"""The port's estimator against the JAX estimator, on the CPU: the update
and the check_footprint_path service.

Both get the same configuration (carried over by config_from_fields) and the
same 96x120 map. Update layers at the chain bars of test_torch_filters.py:
step, masks and footprint layers exact; slope 5e-5; roughness and
traversability 2e-4. Path queries on each engine's own update: verdicts
exact, path traversability within the fused layer's 2e-4; on one shared map
state within 2e-5 (circular paths alone are in test_torch_paths.py, the
polygonal evaluators in test_torch_polygons.py).
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traversability_estimation_tpu.models.estimator import FootprintPath as JaxPath
from traversability_estimation_tpu.models.estimator import TraversabilityEstimator as JaxEstimator
from traversability_estimation_tpu.ops.footprint import QueryState as JaxQueryState
from traversability_estimation_tpu.utils.config import EstimatorConfig as JaxConfig
from traversability_estimation_tpu.utils.config import FootprintConfig as JaxFootprint
from traversability_estimation_tpu_torch import (
    EstimatorConfig,
    FootprintPath,
    TraversabilityEstimator,
    resolve_device,
)
from traversability_estimation_tpu_torch.ops.update_kernel import fused_update_plain
from traversability_estimation_tpu_torch.utils.convert import config_from_fields

RES = 0.03
POSITION = (0.05, -0.1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smooth_terrain(rows, cols, seed):
    rng = np.random.default_rng(seed)
    x = np.arange(rows)[:, None] * RES
    y = np.arange(cols)[None, :] * RES
    z = (
        0.15 * np.sin(2.0 * x) * np.cos(1.5 * y)
        + 0.012 * rng.standard_normal((rows, cols))
        + 0.3 * ((x > x.mean()) & (y > y.mean()))
        + 0.05 * x
    )
    z[rng.random((rows, cols)) < 0.02] = np.nan
    return z.astype(np.float32)


@pytest.fixture(scope="module")
def estimators():
    jcfg = JaxConfig(resolution=RES, footprint=JaxFootprint(verify_roughness_footprint=True))
    elev = smooth_terrain(96, 120, seed=7)
    jest = JaxEstimator(jcfg)
    test = TraversabilityEstimator(config_from_fields(jcfg), device="cpu")
    assert jest.update(elev, position=POSITION) and test.update(elev, position=POSITION)
    return jest, test, elev


def test_config_from_fields_carries_every_field():
    jcfg = JaxConfig(resolution=0.05, max_gap_width=0.25,
                     footprint=JaxFootprint(traversability_default=0.3))
    for src in (jcfg, dataclasses.asdict(jcfg)):
        cfg = config_from_fields(src)
        assert cfg.chain.resolution == 0.05 and cfg.max_gap_width == 0.25
        assert cfg.footprint.traversability_default == 0.3
        assert dataclasses.asdict(cfg.veto) == dataclasses.asdict(jcfg.veto)
        assert cfg.chain.fusion_weights == jcfg.chain.fusion_weights


def test_update_layers_match_jax(estimators):
    jest, test, _ = estimators
    ref = {k: np.asarray(v) for k, v in jest.traversability_map.layers.items()}
    out = test.traversability_map.to_numpy()
    assert set(out) == set(ref)
    assert test.traversability_map.size == (96, 120)
    close = {"traversability_slope": 5e-5, "traversability_roughness": 2e-4,
             "traversability": 2e-4}
    for k in ref:
        assert out[k].dtype == ref[k].dtype, k
        if k in close:
            assert (np.isfinite(out[k]) == np.isfinite(ref[k])).all(), k
            fin = np.isfinite(ref[k])
            np.testing.assert_allclose(out[k][fin], ref[k][fin], rtol=0, atol=close[k], err_msg=k)
        else:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    mask = out["traversable_mask"]
    assert 0.2 < mask.mean() < 0.995


def test_paths_on_own_updates_match_jax(estimators):
    """The slice end to end: update -> circle field -> circular paths, each
    engine from its own update of the same map."""
    jest, test, _ = estimators
    rng = np.random.default_rng(5)
    P, N = 32, 12
    ext = 96 * RES / 2 * 0.8
    starts = np.float32(POSITION) + rng.uniform(-ext, ext, (P, 2))
    steps = rng.uniform(-0.06, 0.06, (P, N - 1, 2))
    poses = np.concatenate(
        [starts[:, None], starts[:, None] + np.cumsum(steps, 1)], 1
    ).astype(np.float32)
    n_poses = rng.integers(1, N + 1, P).astype(np.int32)
    n_poses[:3] = [1, 1, N]
    safe_j, trav_j = jest.check_circular_paths_batch(poses, n_poses, 0.3)
    safe_t, trav_t = test.check_circular_paths_batch(poses, n_poses, 0.3)
    np.testing.assert_array_equal(safe_t.numpy(), np.asarray(safe_j))
    np.testing.assert_allclose(trav_t.numpy(), np.asarray(trav_j), rtol=0, atol=2e-4)
    assert safe_t.any() and not safe_t.all()

    specs = [(poses[0, :1], 0.3), (poses[3, :6], 0.2), (np.zeros((0, 2), np.float32), 0.3)]
    res_j = jest.check_footprint_path([JaxPath(poses=p, radius=r) for p, r in specs])
    res_t = test.check_footprint_path([FootprintPath(poses=p, radius=r) for p, r in specs])
    assert [r.is_safe for r in res_t] == [r.is_safe for r in res_j]
    np.testing.assert_allclose(
        [r.traversability for r in res_t], [r.traversability for r in res_j], rtol=0, atol=2e-4
    )


def test_update_is_fused_update_plain_on_cpu(estimators):
    _, test, elev = estimators
    cfg = test.config
    want = fused_update_plain(torch.from_numpy(elev), cfg.chain, cfg.veto)
    for k, v in want.items():
        got = test.traversability_map[k]
        np.testing.assert_array_equal(got.numpy(), v.numpy(), err_msg=k)


RECT = np.float32([[0.45, 0.3], [0.45, -0.3], [-0.45, -0.3], [-0.45, 0.3]])
SQUARE = np.float32([[0.2, 0.2], [0.2, -0.2], [-0.2, -0.2], [-0.2, 0.2]])
L_SHAPE = np.float32(
    [[0.4, 0.3], [0.4, -0.3], [-0.4, -0.3], [-0.4, 0.0], [0.0, 0.0], [0.0, 0.3]]
)


def _mixed_paths(cls):
    """Circular and polygonal paths interleaved: two convex footprints (one
    also conservative), a non-convex one, ragged pose counts from 1 to 11,
    with and without orientations, an empty path and one off the map."""
    rng = np.random.default_rng(8)
    ext = 96 * RES / 2 * 0.7
    paths = []
    for k in range(18):
        n = int(rng.integers(1, 12))
        start = np.float32(POSITION) + rng.uniform(-ext, ext, 2)
        xy = start + np.concatenate([np.zeros((1, 2)), np.cumsum(rng.uniform(-0.06, 0.06, (n - 1, 2)), 0)])
        yaw = rng.uniform(-np.pi, np.pi, n)
        quats = np.stack([0 * yaw, 0 * yaw, np.sin(yaw / 2), np.cos(yaw / 2)], -1).astype(np.float32)
        poses = xy.astype(np.float32)
        kind = k % 6
        if kind == 0:
            paths.append(cls(poses=poses, radius=0.3))
        elif kind == 1:
            paths.append(cls(poses=poses, footprint=RECT))  # identity orientation
        elif kind == 2:
            paths.append(cls(poses=np.concatenate([poses, np.zeros((n, 1), np.float32)], 1),
                             orientations=quats, footprint=SQUARE))
        elif kind == 3:
            paths.append(cls(poses=poses, orientations=quats, footprint=SQUARE, conservative=True))
        elif kind == 4:
            paths.append(cls(poses=poses, orientations=quats, footprint=L_SHAPE))
        else:
            paths.append(cls(poses=poses, radius=0.2))
    paths.append(cls(poses=np.zeros((0, 2), np.float32), footprint=RECT))
    paths.append(cls(poses=np.float32([[50.0, 50.0]]), footprint=RECT))
    return paths


@pytest.mark.parametrize("state", ["own_updates", "shared_state"])
def test_mixed_footprint_paths_match_jax(estimators, state):
    """check_footprint_path with circular and polygonal paths mixed, through
    both estimators. On each engine's own update the path traversability
    inherits the fused layer's 2e-4 bar; on one shared map state it holds
    2e-5. Verdicts, and which evaluator each polygonal group took, are equal
    either way."""
    jest, test, elev = estimators
    jcfg = JaxConfig(resolution=RES, footprint=JaxFootprint(verify_roughness_footprint=True))
    test = TraversabilityEstimator(test.config, device="cpu")
    assert test.update(elev, position=POSITION)
    jest_new = JaxEstimator(jcfg)
    if state == "own_updates":
        assert jest_new.update(elev, position=POSITION)
    else:
        qs = test.query_state
        jest_new._query_state = JaxQueryState(
            traversability=jnp.asarray(qs.traversability.numpy()),
            traversable_mask=jnp.asarray(qs.traversable_mask.numpy()),
            position=jnp.asarray(np.float32(POSITION)), resolution=RES,
            default_traversability=qs.default_traversability,
        )
        jest_new._position = np.float32(POSITION)
        jest_new.initialized = True
    atol = 2e-4 if state == "own_updates" else 2e-5
    res_j = jest_new.check_footprint_path(_mixed_paths(JaxPath))
    res_t = test.check_footprint_path(_mixed_paths(FootprintPath))
    assert [r.is_safe for r in res_t] == [r.is_safe for r in res_j]
    np.testing.assert_allclose(
        [r.traversability for r in res_t], [r.traversability for r in res_j], rtol=0, atol=atol
    )
    np.testing.assert_allclose(
        [r.area for r in res_t], [r.area for r in res_j], rtol=1e-5, atol=1e-6
    )
    safe = [r.is_safe for r in res_t]
    assert any(safe[:18]) and not all(safe[:18])
    assert res_t[18].is_safe is False and res_t[18].area == 0.0  # no pose
    assert res_t[19].is_safe is True and res_t[19].traversability == 0.5  # off the map
    # the last group dispatched is RECT's; the L went to the per-segment evaluator
    assert test.last_polygonal_dispatch == jest_new.last_polygonal_dispatch
    assert test.polygonal_dispatch_counts == jest_new.polygonal_dispatch_counts
    assert test.polygonal_dispatch_counts["batches_non_convex_footprint"] == 1
    assert test.polygonal_dispatch_counts["paths_per_segment"] == 3
    assert test.polygonal_dispatch_counts["paths_grouped"] == 10


def test_polygonal_batch_dispatch_matches_jax(estimators, monkeypatch):
    """check_polygonal_paths_batch: the dispatch statistics equal key for
    key, for the grouped tiers and the per-segment evaluator; a long path
    past the window cap takes block windows."""
    from traversability_estimation_tpu.models import estimator as jmod
    from traversability_estimation_tpu_torch.models import estimator as tmod

    jest, test, _ = estimators
    rng = np.random.default_rng(9)
    P, N = 6, 33
    start = np.float32(POSITION) + rng.uniform(-0.3, 0.3, (P, 1, 2))
    xy = start + np.concatenate(
        [np.zeros((P, 1, 2)), np.cumsum(rng.uniform(0.0, 0.06, (P, N - 1, 2)), 1)], 1)
    pos3 = np.concatenate([xy, np.zeros((P, N, 1))], -1).astype(np.float32)
    quats = np.zeros((P, N, 4), np.float32)
    quats[..., 3] = 1.0
    n_poses = np.full((P,), N, np.int32)
    cases = [(RECT, False, None), (RECT, True, None), (L_SHAPE, False, None),
             (RECT, False, 20_000), (RECT, False, 5_000)]
    seen = set()
    assert tmod._GROUPED_ELEMS_CAP == jmod._GROUPED_ELEMS_CAP == 32_000_000
    for fp, conservative, cap in cases:
        with monkeypatch.context() as patch:
            if cap is not None:  # a small cap stands in for a long-path batch
                patch.setattr(jmod, "_GROUPED_ELEMS_CAP", cap)
                patch.setattr(tmod, "_GROUPED_ELEMS_CAP", cap)
            out_j = jest.check_polygonal_paths_batch(pos3, quats, n_poses, fp, conservative)
            out_t = test.check_polygonal_paths_batch(pos3, quats, n_poses, fp, conservative)
        assert test.last_polygonal_dispatch == jest.last_polygonal_dispatch
        stats = test.last_polygonal_dispatch
        seen.add((stats["evaluator"], stats["reason"], stats["block_window"] is not None))
        np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
        # each engine on its own update: the fused layer's 2e-4 bar
        np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]), rtol=0, atol=2e-4)
        np.testing.assert_allclose(out_t[2].numpy(), np.asarray(out_j[2]), rtol=1e-5, atol=1e-6)
    assert seen == {
        ("grouped", "ok", False), ("grouped", "ok", True),
        ("per_segment", "non_convex_footprint", False), ("per_segment", "window_cap", False),
    }
    assert test.polygonal_dispatch_counts == jest.polygonal_dispatch_counts


def test_unported_paths_raise(estimators):
    """Nothing on the query path is unported any more: untraversable polygons,
    the inclination check and a generic chain, which raised NotImplementedError
    with their ROADMAP items (A16, A11) in earlier slices, are served."""
    _, test, _ = estimators
    res = test.check_footprint_path(
        FootprintPath(poses=np.float32(POSITION) + np.zeros((2, 2), np.float32), footprint=SQUARE)
    )
    assert len(res) == 1 and (res[0].area > 0.0 or not res[0].is_safe)
    for kw in (dict(radius=0.3), dict(footprint=SQUARE)):
        (r,) = test.check_footprint_path(
            FootprintPath(poses=np.zeros((2, 2)), compute_untraversable_polygon=True, **kw)
        )
        assert r.is_safe or r.untraversable_polygon is not None
    incl = TraversabilityEstimator(
        dataclasses.replace(
            test.config,
            footprint=dataclasses.replace(test.config.footprint, check_robot_inclination=True),
        ),
        device="cpu",
    )
    incl.update(np.zeros((40, 40), np.float32))
    safe, _ = incl.check_circular_paths_batch(np.zeros((1, 2, 2), np.float32), np.int32([2]), 0.3)
    assert bool(safe[0])
    assert incl.check_footprint_path(FootprintPath(poses=np.zeros((2, 2)), footprint=SQUARE))[0].is_safe
    identity = np.tile(np.float32([0, 0, 0, 1]), (1, 2, 1))
    safe, _, area = incl.check_polygonal_paths_batch(
        np.zeros((1, 2, 3), np.float32), identity, np.int32([2]), SQUARE)
    assert bool(safe[0]) and float(area[0]) > 0.0
    assert EstimatorConfig(use_generic_chain=True).use_generic_chain
    import pathlib

    package = pathlib.Path(REPO) / "traversability_estimation_tpu_torch"
    for path in package.rglob("*.py"):
        text = path.read_text()
        assert "NotImplementedError" not in text or "A14" in text, path


def test_cuda_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TraversabilityEstimator(EstimatorConfig())
    with pytest.raises(RuntimeError):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_port_imports_nothing_of_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import traversability_estimation_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.split('.')[0] == 'traversability_estimation_tpu')\n"
        "assert not bad, bad\n"
        "assert 'yaml' not in sys.modules\n"
        "print('modules', len([m for m in sys.modules if m.startswith(pkg.__name__)]))\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15
