"""The port's native bindings (``utils/native.py``) on the CPU: the root
``csrc/`` sources built by ``g++`` into the port's ``_build/native/``, the
baseline chain and circle and polygon queries held to the port's oracle as
tests/test_native.py holds the JAX package's (chain atol 1e-6, exact
verdicts), and the native bag reader held to the port's ``utils/rosbag.py``
on a bag the port writes. The build never runs ``csrc/build.sh`` and never
opens anything under the JAX package's ``_native/``: an audit hook records
every file the process opens, every process it starts and every library it
loads while the port builds and loads. Skips only where ``g++`` is absent.
"""

import shutil
import sys

import numpy as np
import pytest

from traversability_estimation_tpu_torch.oracle import filters as OF
from traversability_estimation_tpu_torch.oracle.footprint import OracleMap
from traversability_estimation_tpu_torch.ops.filters import ChainConfig
from traversability_estimation_tpu_torch.utils import native, rosbag

RES = 0.03

_events = []
_recording = [False]


def _audit(event, args):
    if _recording[0] and event in ("open", "subprocess.Popen", "ctypes.dlopen", "os.exec",
                                   "os.posix_spawn"):
        _events.append((event, repr(args)))


sys.addaudithook(_audit)


@pytest.fixture(scope="module")
def built():
    """Both libraries built and loaded (from a fresh start), and what the
    process touched meanwhile."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the native baseline builds with the host's g++")
    native._loaded.clear()
    for lib in native.BUILD_DIR.glob("lib*.so") if native.BUILD_DIR.exists() else []:
        lib.unlink()
    _events.clear()
    _recording[0] = True
    try:
        assert native.available()
        native._load_bag_lib()
    finally:
        _recording[0] = False
    return list(_events)


def _terrain(seed, nan_frac):
    rng = np.random.default_rng(seed)
    x = np.arange(48)[:, None] * RES
    y = np.arange(48)[None, :] * RES
    z = (0.05 * np.sin(2 * x) * np.cos(1.5 * y) + 0.004 * rng.standard_normal((48, 48))
         + 0.5 * (x > x.mean() + 0.2))
    z[rng.random((48, 48)) < nan_frac] = np.nan
    return z.astype(np.float32)


def _oracle(layers):
    return OracleMap(layers, RES, (0.0, 0.0), critical_step_height=0.12, max_gap_width=0.3,
                     traversability_default=0.5, check_roughness=False)


def test_builds_into_the_port_and_never_touches_the_jax_build(built):
    libs = {name: native.library_path(name, shutil.which("g++")) for name in native.SOURCES}
    for name, path in libs.items():
        assert path.exists() and path.parent == native.BUILD_DIR, name
        assert native._loaded[name]._name == str(path)
    assert native.BUILD_DIR.parts[-3:] == ("traversability_estimation_tpu_torch", "_build",
                                           "native")
    assert any(e == "subprocess.Popen" and "g++" in a for e, a in built)
    for event, args in built:
        assert "build.sh" not in args, (event, args)
        assert "traversability_estimation_tpu/_native" not in args, (event, args)


def test_unavailable_without_gxx(built, monkeypatch):
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    monkeypatch.setattr(native, "_loaded", {})
    with pytest.raises(native.NativeUnavailable):
        native.baseline_run_chain(_terrain(1, 0.0), RES, ChainConfig(resolution=RES))
    assert not native.available()


@pytest.mark.parametrize("seed, nan_frac", [(51, 0.08), (3, 0.0)])
def test_native_chain_matches_oracle(built, seed, nan_frac):
    elev = _terrain(seed, nan_frac)
    nat = native.baseline_run_chain(elev, RES, ChainConfig(resolution=RES))
    ref = OF.run_chain(elev, RES, OF.DEFAULT_CHAIN_CONFIG, (0.0, 0.0))
    for k in ("traversability_slope", "traversability_step", "traversability_roughness",
              "traversability"):
        a, b = nat[k], ref[k]
        assert (np.isfinite(a) == np.isfinite(b)).all(), k
        both = np.isfinite(a) & np.isfinite(b)
        np.testing.assert_allclose(a[both], b[both], atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def layers(built):
    elev = _terrain(0, 0.01)
    return {"elevation": elev, **OF.run_chain(elev, RES, OF.DEFAULT_CHAIN_CONFIG)}


def test_native_circles_match_oracle(layers):
    eng = native.BaselineQueryEngine(layers, RES)
    rng = np.random.default_rng(5)
    centers = np.stack([rng.uniform(-0.6, 0.6, 60), rng.uniform(-0.6, 0.6, 60)], -1)
    ok, trav = eng.check_circles(centers, 0.3, 0.2)
    # one oracle for all centres, in the same order: the engine's per-cell
    # memo caches persist across the calls of one map epoch, the oracle's too
    om = _oracle(layers)
    for b in range(len(centers)):
        o_ok, o_trav, _ = om.is_traversable_circle(centers[b], 0.3, 0.2)
        assert bool(ok[b]) == o_ok, centers[b]
        if o_ok:
            assert trav[b] == pytest.approx(o_trav, abs=1e-5)
    assert ok.any() and not ok.all()


def test_native_polygon_paths_match_oracle(layers):
    eng = native.BaselineQueryEngine(layers, RES, 0.12, 0.3, 0.5)
    fp = np.array([[0.09, 0.06], [0.09, -0.06], [-0.09, -0.06], [-0.09, 0.06]])
    rng = np.random.default_rng(0)
    P, N = 24, 4
    ext = 48 * RES / 2 * 0.7
    starts = np.stack([rng.uniform(-ext, ext, P), rng.uniform(-ext, ext, P)], -1)
    poses = np.concatenate(
        [starts[:, None], starts[:, None] + np.cumsum(rng.uniform(-0.05, 0.05, (P, N - 1, 2)),
                                                      1)], 1)
    for n in (N, 1):
        ok_n, tv_n = eng.check_polygon_paths(poses[:, :n], fp)
        n_safe = 0
        for p in range(P):
            r = _oracle(layers).check_polygonal_footprint_path(
                np.concatenate([poses[p, :n], np.zeros((n, 1))], 1),
                np.tile([0, 0, 0, 1.0], (n, 1)), fp)
            assert bool(ok_n[p]) == bool(r.is_safe), (n, p)
            if r.is_safe:
                n_safe += 1
                assert tv_n[p] == pytest.approx(r.traversability, abs=1e-9), (n, p)
        assert 0 < n_safe < P


def test_native_bag_reader_matches_python(built, tmp_path):
    rng = np.random.default_rng(9)
    elev = rng.standard_normal((40, 52)).astype(np.float32)
    elev[rng.random(elev.shape) < 0.1] = np.nan
    path = str(tmp_path / "map.bag")
    rosbag.save_grid_map_bag(
        path, {"elevation": elev, "traversability": rng.random(elev.shape).astype(np.float32)},
        RES, position=(0.3, -0.6), basic_layers=("elevation",))
    want = rosbag.load_grid_map_bag(path)
    got = native.load_grid_map_bag_native(path)
    assert isinstance(got, rosbag.GridMapMessage)
    assert got.size == want.size and got.resolution == want.resolution
    assert got.position[:2] == pytest.approx(want.position[:2])
    assert set(got.layers) == set(want.layers)
    for k in want.layers:
        np.testing.assert_array_equal(got.data[k], want.data[k])
