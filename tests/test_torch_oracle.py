"""The port's NumPy oracle (``oracle/filters.py``, ``oracle/footprint.py``)
against the JAX package's, and the port's torch chain and queries against
the port's oracle, on the CPU.

The two oracles are the same NumPy code over each package's own host
geometry, so they must agree bit for bit: chain layers, circle verdicts,
circular and polygonal paths (with and without the untraversable polygon).
The port's torch chain computes in float32 where the oracle computes in
float64, so it is held to the tolerances the JAX package holds its own
chain to (tests/test_ops_chain.py: 5e-5, roughness 2.5e-4), with the NaN
pattern exact; the queries, given the same layers, to exact verdicts and
tests/test_footprint.py's score tolerances (circles 2e-5, polygonal paths
1e-4, area rtol 1e-3). Circular paths' scores are held within 1e-3: the
batched evaluator scores each line sample by the dense field at its cell's
centre, the oracle by a circle at the sample's exact position, which moves a
path's mean by up to ~4e-4 on this terrain (the JAX package's batched
evaluator differs from the oracle by the same amounts; the port equals it
within 1e-6, tests/test_torch_paths.py).
"""

import numpy as np
import pytest
import torch

from traversability_estimation_tpu.oracle import filters as JOF
from traversability_estimation_tpu.oracle import footprint as JOFP
from traversability_estimation_tpu_torch.oracle import filters as OF
from traversability_estimation_tpu_torch.oracle import footprint as OFP
from traversability_estimation_tpu_torch.ops import filters as TF
from traversability_estimation_tpu_torch.ops import footprint as fp_ops
from traversability_estimation_tpu_torch.ops.veto import VetoConfig, compute_veto_fields

RES = 0.03
LAYERS = ("traversability_slope", "traversability_step", "traversability_roughness",
          "traversability")
FOOTPRINT = np.array([[0.09, 0.06], [0.09, -0.06], [-0.09, -0.06], [-0.09, 0.06]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the host's cores, and
    OpenMP regions of many small ops stall when threads outnumber cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _terrain(rows, cols, seed, nan_frac, res=RES):
    """Gentle terrain with a hard wall: both verdicts of every query."""
    rng = np.random.default_rng(seed)
    x = np.arange(rows)[:, None] * res
    y = np.arange(cols)[None, :] * res
    z = (
        0.05 * np.sin(2 * x) * np.cos(1.5 * y)
        + 0.004 * rng.standard_normal((rows, cols))
        + 0.5 * (x > x.mean() + 0.2)
    )
    z[rng.random((rows, cols)) < nan_frac] = np.nan
    return z.astype(np.float32)


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        ((a == b) | (np.isnan(a) & np.isnan(b))).all())


@pytest.fixture(scope="module")
def world():
    """The port's torch chain on a 48 x 56 terrain: the layers both
    oracles and the port's queries read, the port's query state over them,
    and random paths."""
    elev = _terrain(48, 56, seed=3, nan_frac=0.02)
    out = TF.run_chain(torch.from_numpy(elev), TF.ChainConfig(resolution=RES))
    layers = {"elevation": elev, **{k: out[k].numpy() for k in LAYERS}}
    veto = compute_veto_fields({k: torch.from_numpy(v) for k, v in layers.items()},
                               VetoConfig(resolution=RES))
    state = fp_ops.QueryState(
        traversability=torch.from_numpy(layers["traversability"]),
        traversable_mask=veto["traversable_mask"],
        position=torch.zeros(2), resolution=RES, default_traversability=0.5)
    rng = np.random.default_rng(11)
    P, N = 16, 4
    starts = np.stack([rng.uniform(-0.5, 0.5, P), rng.uniform(-0.6, 0.6, P)], -1)
    steps = rng.uniform(-0.08, 0.08, (P, N - 1, 2))
    poses = np.concatenate([starts[:, None], starts[:, None] + np.cumsum(steps, 1)], 1).astype(
        np.float32)
    return layers, state, poses


def _oracles(layers):
    kw = dict(critical_step_height=0.12, max_gap_width=0.3, traversability_default=0.5,
              check_roughness=False)
    return (OFP.OracleMap(layers, RES, (0.0, 0.0), **kw),
            JOFP.OracleMap(layers, RES, (0.0, 0.0), **kw))


@pytest.mark.parametrize("res, seed, nan_frac", [(0.03, 51, 0.08), (0.06, 5, 0.05)])
def test_run_chain_equals_jax_oracle(res, seed, nan_frac):
    elev = _terrain(40, 44, seed, nan_frac, res)
    got = OF.run_chain(elev, res, OF.DEFAULT_CHAIN_CONFIG, (0.1, -0.2))
    want = JOF.run_chain(elev, res, JOF.DEFAULT_CHAIN_CONFIG, (0.1, -0.2))
    assert OF.DEFAULT_CHAIN_CONFIG == JOF.DEFAULT_CHAIN_CONFIG
    assert set(got) == set(want)
    for k in want:
        assert _equal(got[k], want[k]), k


def test_circles_and_paths_equal_jax_oracle(world):
    layers, _, poses = world
    mine, theirs = _oracles(layers)
    rng = np.random.default_rng(2)
    for c in np.stack([rng.uniform(-0.8, 0.8, 24), rng.uniform(-0.9, 0.9, 24)], -1):
        a = mine.is_traversable_circle(c, 0.45, 0.3, compute_untraversable=True)
        b = theirs.is_traversable_circle(c, 0.45, 0.3, compute_untraversable=True)
        assert a[:2] == b[:2] and _equal(a[2] if a[2] is not None else [],
                                         b[2] if b[2] is not None else [])
    quats = np.tile(np.float32([0, 0, 0, 1]), (poses.shape[1], 1))
    n_safe = 0
    for p in poses:
        for conservative in (False, True):
            pos3 = np.concatenate([p, np.zeros((len(p), 1), np.float32)], 1)
            a = mine.check_polygonal_footprint_path(pos3, quats, FOOTPRINT, conservative, True)
            b = theirs.check_polygonal_footprint_path(pos3, quats, FOOTPRINT, conservative, True)
            assert (a.is_safe, a.traversability, a.area) == (b.is_safe, b.traversability, b.area)
            assert (a.untraversable_polygon is None) == (b.untraversable_polygon is None)
            if a.untraversable_polygon is not None:
                assert _equal(a.untraversable_polygon, b.untraversable_polygon)
        a = mine.check_circular_footprint_path(p, 0.12, 0.06, True)
        b = theirs.check_circular_footprint_path(p, 0.12, 0.06, True)
        assert (a.is_safe, a.traversability, a.area) == (b.is_safe, b.traversability, b.area)
        n_safe += a.is_safe
    assert 0 < n_safe < len(poses)


@pytest.mark.parametrize("res, seed, nan_frac", [(0.03, 51, 0.08), (0.03, 3, 0.15),
                                                 (0.06, 5, 0.05)])
def test_torch_chain_matches_oracle(res, seed, nan_frac):
    elev = _terrain(40, 48, seed, nan_frac, res)
    out = TF.run_chain(torch.from_numpy(elev), TF.ChainConfig(resolution=res))
    ref = OF.run_chain(elev, res, OF.DEFAULT_CHAIN_CONFIG, (0.0, 0.0))
    for k in LAYERS:
        a, b = out[k].numpy(), ref[k]
        assert np.array_equal(np.isfinite(a), np.isfinite(b)), k
        both = np.isfinite(b)
        tol = 2.5e-4 if k == "traversability_roughness" else 5e-5
        if both.any():
            assert np.abs(a[both] - b[both]).max() < tol, k


def test_torch_circles_match_oracle(world):
    layers, state, _ = world
    rng = np.random.default_rng(4)
    centers = np.stack([rng.uniform(-0.8, 0.8, 60), rng.uniform(-0.9, 0.9, 60)], -1).astype(
        np.float32)
    ok, trav = fp_ops.check_circles(state, torch.from_numpy(centers), 0.45, 0.3)
    ok, trav = ok.numpy(), trav.numpy()
    for b, c in enumerate(centers):
        om = _oracles(layers)[0]  # a fresh memo per query
        o_ok, o_trav, _ = om.is_traversable_circle(c, 0.45, 0.3)
        assert bool(ok[b]) == o_ok, c
        if o_ok:
            assert trav[b] == pytest.approx(o_trav, abs=2e-5), c
    assert ok.any() and not ok.all()


def test_torch_paths_match_oracle(world):
    layers, state, poses = world
    P, N = poses.shape[:2]
    n_poses = np.full((P,), N, np.int32)
    safe, trav = fp_ops.check_circular_paths(state, torch.from_numpy(poses),
                                             torch.from_numpy(n_poses), 0.12, 0.06, 16)
    pos3 = np.concatenate([poses, np.zeros((P, N, 1), np.float32)], -1)
    quats = np.zeros((P, N, 4), np.float32)
    quats[..., 3] = 1.0
    window = fp_ops.polygon_window_cells(FOOTPRINT, 0.2, RES, False)
    psafe, ptrav, parea = fp_ops.check_polygonal_paths(
        state, torch.from_numpy(pos3), torch.from_numpy(quats), torch.from_numpy(n_poses),
        torch.from_numpy(FOOTPRINT), window, False)
    for p in range(P):
        r = _oracles(layers)[0].check_circular_footprint_path(poses[p], 0.12, 0.06)
        assert bool(safe[p]) == r.is_safe, p
        if r.is_safe:
            assert float(trav[p]) == pytest.approx(r.traversability, abs=1e-3), p
        r = _oracles(layers)[0].check_polygonal_footprint_path(pos3[p], quats[p], FOOTPRINT)
        assert bool(psafe[p]) == r.is_safe, p
        if r.is_safe:
            assert float(ptrav[p]) == pytest.approx(r.traversability, abs=1e-4), p
            assert float(parea[p]) == pytest.approx(r.area, rel=1e-3, abs=1e-4), p
    assert 0 < int(safe.sum()) < P and 0 < int(psafe.sum()) < P
