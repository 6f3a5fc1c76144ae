"""Kernel 3's wrapper (``ops/poly_kernel.py``) on the CPU: the launch plan
the ``.cu`` checks (a cluster of blocks per path where the batch is too
small to fill the card), the plain version on a CPU state (exactly, with no
launch counted, and against jitted JAX, also on the span-boundary batch
whose rings' first and last columns are decided by ties), no fallback on a
CUDA state, the three grouped call sites reaching the wrapper, and a
footprint past the kernel's shared memory going to it all the same (its
slots in a global scratch). The kernel itself runs on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traversability_estimation_tpu.models import estimator as jest_mod
from traversability_estimation_tpu.ops import footprint as jfp
from traversability_estimation_tpu_torch import EstimatorConfig, TraversabilityEstimator
from traversability_estimation_tpu_torch.ops import footprint as tfp
from traversability_estimation_tpu_torch.ops import poly_kernel
from traversability_estimation_tpu_torch.scripts.kernel3_profile import span_boundary_batch

RES = 0.03
RECT = np.float32([[0.3, 0.2], [0.3, -0.2], [-0.3, -0.2], [-0.3, 0.2]])


def _terrain(rows, cols, seed):
    rng = np.random.default_rng(seed)
    x = np.arange(rows)[:, None] * RES
    y = np.arange(cols)[None, :] * RES
    z = (0.15 * np.sin(2.0 * x) * np.cos(1.5 * y) + 0.012 * rng.standard_normal((rows, cols))
         + 0.3 * ((x > x.mean()) & (y > y.mean())) + 0.05 * x)
    z[rng.random((rows, cols)) < 0.02] = np.nan
    return z.astype(np.float32)


@pytest.fixture(scope="module")
def est():
    e = TraversabilityEstimator(EstimatorConfig(resolution=RES), device="cpu")
    assert e.update(_terrain(80, 72, seed=4), position=(0.1, -0.05))
    return e


def _batch(seed, P=10, N=11, rotated=False):
    """Random-walk paths, ragged pose counts including 1, the first path
    wholly and the second partly off the map."""
    rng = np.random.default_rng(seed)
    starts = rng.uniform(-0.9, 0.9, (P, 2))
    starts[0] += 3.0
    starts[1, 0] += 1.1
    xy = np.concatenate(
        [starts[:, None], starts[:, None] + np.cumsum(rng.uniform(-0.05, 0.05, (P, N - 1, 2)), 1)],
        1)
    pos3 = np.concatenate([xy, np.zeros((P, N, 1))], -1).astype(np.float32)
    quats = np.zeros((P, N, 4), np.float32)
    quats[..., 3] = 1.0
    if rotated:
        yaw = rng.uniform(0, 2 * np.pi, (P, N))
        quats[..., 2] = np.sin(yaw / 2)
        quats[..., 3] = np.cos(yaw / 2)
    n_poses = rng.integers(1, N + 1, P).astype(np.int32)
    n_poses[2] = 1
    for p in range(P):
        pos3[p, n_poses[p]:] = pos3[p, n_poses[p] - 1]
        quats[p, n_poses[p]:] = quats[p, n_poses[p] - 1]
    return pos3, quats, n_poses


def _windows(pos3, quats, rotated, blocks):
    ext = pos3[..., :2].max(axis=1) - pos3[..., :2].min(axis=1)
    gw = tfp.path_group_window_exact(RECT, pos3, quats, RES) if rotated else \
        tfp.path_group_window(RECT, ext, RES, True)
    bw = tfp.path_block_window(RECT, pos3, RES, not rotated) if blocks else None
    return gw, bw


# mode -> (rotated, conservative, block tier)
MODES = {
    "identity": (False, False, False),
    "yaw": (True, False, False),
    "conservative_yaw": (True, True, False),
    "identity_blocks": (False, False, True),
    "yaw_blocks": (True, False, True),
}


@pytest.mark.parametrize("case", [
    # (P, N, V, wi, conservative) -> (ring, n_bits, blocks per path, smem bytes)
    ((1024, 50, 4, 68, False), (8, 7, 1, 1792)),
    ((1024, 50, 4, 76, True), (16, 7, 1, 3328)),
    ((8, 50, 8, 63, True), (32, 6, 7, 6400)),
    ((3, 20, 6, 64, False), (12, 7, 3, 2560)),
    ((1, 1, 3, 1, False), (6, 1, 1, 1408)),
], ids=lambda c: str(c[0]) if isinstance(c[0], tuple) else None)
def test_launch_plan_integers(case):
    (P, N, V, wi, conservative), (ring, n_bits, cluster, smem) = case
    plan = poly_kernel.launch_plan(P, N, V, wi, conservative)
    assert (plan.ring, plan.n_bits, plan.cluster, plan.smem_bytes, plan.scratch_words) == (
        ring, n_bits, cluster, smem, 0)
    assert plan.grid == (P * cluster, 1) and plan.block == (256, 1)
    assert plan.warps == 8 * P * cluster
    # a block's warps take a ring block of the plain version's SEG_BLOCK
    # rings; a path has at most one block per ring block and 8 in all
    assert plan.block[0] // 32 == tfp.SEG_BLOCK
    assert 1 <= plan.cluster <= min(-(-N // tfp.SEG_BLOCK), 8)
    # the rounds the plain version's search runs
    assert plan.n_bits == max(1, int(np.ceil(np.log2(wi + 1))))


@pytest.mark.parametrize("P, N, cluster", [(8, 10, 2), (8, 50, 7), (8, 200, 8), (100, 50, 6),
                                           (528, 50, 1), (1024, 50, 1), (8, 1, 1)])
def test_launch_plan_spreads_small_batches(P, N, cluster):
    """A batch too small to fill the card's resident blocks (132 SMs x 4)
    spreads each path over a cluster of blocks, at most one per ring block
    of 8 rings and 8 in all: 8 paths start more blocks than paths; one that
    fills it keeps one block per path."""
    plan = poly_kernel.launch_plan(P, N, 4, 76, False)
    assert plan.cluster == cluster and plan.grid == (P * cluster, 1)
    if P == 8 and N > 8:
        assert plan.grid[0] > P
    assert poly_kernel.launch_plan(P, N, 4, 76, False, sm_count=1).cluster == 1


def test_launch_plan_shared_memory_limit():
    """The largest footprints whose slots shared memory holds beside the
    block's fixed take: 302 vertices conservative (1,208 points), 604
    plain. One more vertex, or a limit below the fixed take, puts the slots
    in a global scratch of one block's slots per block and asks for the
    fixed take alone."""
    for V, conservative in ((302, True), (604, False)):
        inside = poly_kernel.launch_plan(5, 50, V, 40, conservative)
        assert poly_kernel.FIXED_SMEM < inside.smem_bytes <= poly_kernel.SMEM_LIMIT
        assert inside.scratch_words == 0
        past = poly_kernel.launch_plan(5, 50, V + 1, 40, conservative)
        assert past.smem_bytes == poly_kernel.FIXED_SMEM
        assert past.ring == (V + 1) * (4 if conservative else 2)
        assert past.scratch_words == past.grid[0] * 8 * 6 * past.ring
        assert (past.grid, past.block, past.n_bits) == (inside.grid, inside.block, inside.n_bits)
    forced = poly_kernel.launch_plan(3, 20, 4, 40, False, smem_limit=0)
    assert (forced.smem_bytes, forced.scratch_words) == (poly_kernel.FIXED_SMEM, 9 * 8 * 6 * 8)


def test_work_counts():
    """Bytes and operations of the bound: the swept hull costs 6 per
    vertex, the edge-matrix hull 14 per point test the kernel counts; a
    straddle test 2 (counted over each ring's own span of columns); each
    binary search its set-up and rounds; each inside cell 3."""
    assert poly_kernel.kernel_bytes(2, 3, 4, 100) == 2 * 3 * 28 + 8 + 32 + 400 + 18 + 78
    swept = poly_kernel.kernel_operations(16, 50, 4, 68, False, True, 10_000, 0, 500, 40_000)
    hull = poly_kernel.kernel_operations(16, 50, 4, 68, False, False, 10_000, 70_000, 500, 40_000)
    assert hull - swept == 14 * 70_000 - 16 * 49 * 6 * 4
    more = poly_kernel.kernel_operations(16, 50, 4, 68, False, False, 20_000, 70_000, 600, 40_000)
    assert more - hull == 30_000 + 100 * (6 + 5 * 7)
    wider = poly_kernel.kernel_operations(16, 50, 4, 68, False, False, 20_000, 70_000, 600, 45_000)
    assert wider - more == 2 * 5_000


@pytest.mark.parametrize("mode", list(MODES))
def test_wrapper_on_a_cpu_state_is_the_plain_version(est, mode):
    rotated, conservative, blocks = MODES[mode]
    pos3, quats, n_poses = _batch(seed=len(mode), rotated=rotated)
    gw, bw = _windows(pos3, quats, rotated, blocks)
    args = (est.query_state, pos3, quats, n_poses, RECT, gw, conservative,
            not rotated and not conservative, bw)
    before = poly_kernel.check_polygonal_paths_grouped.launches
    got = poly_kernel.check_polygonal_paths_grouped(*args, return_segments=True)
    want = tfp.check_polygonal_paths_grouped(*args, return_segments=True)
    assert poly_kernel.check_polygonal_paths_grouped.launches == before
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and g.dtype == w.dtype and torch.equal(g, w)
    safe = got[0].numpy()
    assert safe.any() and not safe.all()
    assert not safe[0] or got[1][0] == est.query_state.default_traversability  # off the map


@pytest.mark.parametrize("mode", ["yaw", "conservative_yaw", "identity_blocks"])
def test_per_ring_outputs_give_the_verdicts(est, mode):
    """The per-ring reductions and weights are the ones the verdicts came
    from: the window verdict and the aggregation over them give the
    wrapper's results exactly."""
    rotated, conservative, blocks = MODES[mode]
    pos3, quats, n_poses = _batch(seed=40 + len(mode), N=13, rotated=rotated)
    gw, bw = _windows(pos3, quats, rotated, blocks)
    safe, trav, area, fail, cells, sums, weights = poly_kernel.check_polygonal_paths_grouped(
        est.query_state, pos3, quats, n_poses, RECT, gw, conservative,
        not rotated and not conservative, bw, return_segments=True)
    assert fail.shape == cells.shape == sums.shape == weights.shape == pos3.shape[:2]
    ok, tv = tfp._window_verdict(est.query_state, fail, cells, sums)
    # the aggregation subtracts polygon1 from every weight after the first
    # one: pass the weights as hull areas and zero polygon1 areas
    out = tfp._aggregate_polygonal_path(
        ok[:, 1:], tv[:, 1:], weights[:, 1:], torch.zeros_like(weights[:, 1:]),
        torch.from_numpy(n_poses), ok[:, 0], tv[:, 0], weights[:, 0])
    for g, w in zip(out, (safe, trav, area)):
        assert torch.equal(g, w)
    assert (cells[:, 0] > 0).any() and fail.any() and not fail.all()


@pytest.mark.parametrize("mode", ["yaw", "conservative_yaw", "identity_blocks"])
def test_wrapper_on_a_cpu_state_matches_jax(est, mode):
    """The module holding kernel 3 against the JAX package's grouped
    evaluator on the same query state: verdicts exact, traversability
    within 2e-5, areas within rtol 1e-5 (the sums run in another order)."""
    rotated, conservative, blocks = MODES[mode]
    pos3, quats, n_poses = _batch(seed=60 + len(mode), rotated=rotated)
    gw, bw = _windows(pos3, quats, rotated, blocks)
    translate_only = not rotated and not conservative
    qs = est.query_state
    jqs = jfp.QueryState(
        traversability=jnp.asarray(qs.traversability.numpy()),
        traversable_mask=jnp.asarray(qs.traversable_mask.numpy()),
        position=jnp.asarray(qs.position.numpy()), resolution=RES,
        default_traversability=qs.default_traversability,
    )
    out_j = jest_mod._polygonal_paths_grouped_jit(
        jqs, jnp.asarray(pos3), jnp.asarray(quats), jnp.asarray(n_poses), jnp.asarray(RECT), gw,
        conservative, translate_only, bw)
    out_t = poly_kernel.check_polygonal_paths_grouped(
        qs, pos3, quats, n_poses, RECT, gw, conservative, translate_only, bw)
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]), rtol=0, atol=2e-5)
    np.testing.assert_allclose(out_t[2].numpy(), np.asarray(out_j[2]), rtol=1e-5, atol=1e-6)
    assert jax.devices()[0].platform == "cpu"


def test_span_boundary_batch_matches_jax():
    """The span-boundary batch (a rectangle's vertices exactly on cell
    centres and cell borders: each ring's first and last columns are
    decided by ties) through the module holding kernel 3, on a CPU state,
    against the JAX package's grouped evaluator: verdicts exact,
    traversability within 2e-5, areas within rtol 1e-5."""
    res, shape, position, pos3, quats, n_poses, fp = span_boundary_batch()
    e = TraversabilityEstimator(EstimatorConfig(resolution=res), device="cpu")
    assert e.update(_terrain(*shape, seed=23), position=position)
    ext = pos3[..., :2].max(axis=1) - pos3[..., :2].min(axis=1)
    gw = tfp.path_group_window(fp, ext, res, True)
    qs = e.query_state
    jqs = jfp.QueryState(
        traversability=jnp.asarray(qs.traversability.numpy()),
        traversable_mask=jnp.asarray(qs.traversable_mask.numpy()),
        position=jnp.asarray(qs.position.numpy()), resolution=res,
        default_traversability=qs.default_traversability,
    )
    out_j = jest_mod._polygonal_paths_grouped_jit(
        jqs, jnp.asarray(pos3), jnp.asarray(quats), jnp.asarray(n_poses), jnp.asarray(fp), gw,
        False, True, None)
    out_t = poly_kernel.check_polygonal_paths_grouped(qs, pos3, quats, n_poses, fp, gw, False, True)
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]), rtol=0, atol=2e-5)
    np.testing.assert_allclose(out_t[2].numpy(), np.asarray(out_j[2]), rtol=1e-5, atol=1e-6)
    safe = out_t[0].numpy()
    assert safe.any() and not safe.all()
    # the ties are there: every ring point lies on a cell centre or a border
    p0 = np.asarray(qs.position) + np.asarray(shape) * res / 2
    v = pos3[:, :, None, :2] + fp[None, None]
    half_cells = (p0 - v) / res * 2
    assert np.array_equal(half_cells, np.round(half_cells))
    assert (np.round(half_cells) % 2 == 1).any() and (np.round(half_cells) % 2 == 0).any()


class _CudaState(tfp.QueryState):
    """A query state that says it lies on a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda")


def test_wrapper_raises_on_a_cuda_state_without_cuda(est, monkeypatch):
    """No fallback: on a host without CUDA a CUDA state raises, the plain
    version is never run and no launch is counted; a CUDA estimator cannot
    be made at all; another device type raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA state")

    monkeypatch.setattr(tfp, "check_polygonal_paths_grouped", plain)
    qs = est.query_state
    pos3, quats, n_poses = _batch(seed=3)
    gw, _ = _windows(pos3, quats, False, False)
    before = poly_kernel.check_polygonal_paths_grouped.launches
    state = _CudaState(qs.traversability, qs.traversable_mask, qs.position, RES)
    with pytest.raises((RuntimeError, AssertionError), match="CUDA|cuda"):
        poly_kernel.check_polygonal_paths_grouped(state, pos3, quats, n_poses, RECT, gw)
    assert poly_kernel.check_polygonal_paths_grouped.launches == before
    with pytest.raises(RuntimeError):
        TraversabilityEstimator(EstimatorConfig(resolution=RES), device="cuda")

    class _MetaState(_CudaState):
        device = property(lambda self: torch.device("meta"))

    with pytest.raises(ValueError, match="unsupported device"):
        poly_kernel.check_polygonal_paths_grouped(
            _MetaState(qs.traversability, qs.traversable_mask, qs.position, RES),
            pos3, quats, n_poses, RECT, gw)


@pytest.fixture
def spy(monkeypatch):
    """Replace the wrapper by one that records each call and runs it."""
    calls = []
    wrapper = poly_kernel.check_polygonal_paths_grouped

    def recording(*args, **kwargs):
        calls.append(args[5:])
        return wrapper(*args, **kwargs)

    monkeypatch.setattr(poly_kernel, "check_polygonal_paths_grouped", recording)
    return calls


def test_dispatch_reaches_the_wrapper(est, spy):
    pos3, quats, n_poses = _batch(seed=5, rotated=True)
    want = est.check_polygonal_paths_batch(pos3, quats, n_poses, RECT)
    assert len(spy) == 1 and est.last_polygonal_dispatch["reason"] == "ok"
    assert spy[0][0] == est.last_polygonal_dispatch["group_window"]
    assert torch.equal(want[0], tfp.check_polygonal_paths_grouped(
        est.query_state, pos3, quats, n_poses, RECT, spy[0][0])[0])


def test_fused_online_tick_reaches_the_wrapper(spy):
    e = TraversabilityEstimator(EstimatorConfig(resolution=0.05), device="cpu")
    assert e.update(_terrain(160, 160, seed=91))
    rng = np.random.default_rng(8)
    patch = (0.03 * rng.standard_normal((40, 40))).astype(np.float32)
    starts = rng.uniform(-0.6, 0.6, (8, 2))
    poses = np.concatenate(
        [starts[:, None], starts[:, None] + np.cumsum(rng.uniform(-0.08, 0.08, (8, 3, 2)), 1)],
        1).astype(np.float32)
    out = e.online_tick(patch, (0.25, -0.15), poses, np.full(8, 4, np.int32), footprint=RECT)
    assert out is not None and len(spy) == 1
    assert spy[0][0] == next(iter(e._pwindow_hwm.values()))  # the tick's window mark


def test_bucketed_evaluator_reaches_the_wrapper(est, spy):
    pos3, quats, n_poses = _batch(seed=6, P=12, rotated=True)
    plan = tfp.plan_window_buckets(RECT, pos3, quats, RES, 3)
    got = poly_kernel.check_polygonal_paths_bucketed(
        est.query_state, pos3, quats, n_poses, RECT, plan)
    assert [c[0] for c in spy] == list(plan[1])  # one call per bucket, with its window
    assert got[0].shape == (12,)


def test_footprint_past_shared_memory_reaches_the_wrapper(est, spy):
    """A footprint whose rings exceed kernel 3's shared memory (a convex
    700-gon: 1,400 ring points) is dispatched as any other: grouped / ok,
    through the wrapper (its slots in the global scratch on the card), with
    the plain version's results here."""
    many = np.float32([[0.3 * np.cos(a), 0.2 * np.sin(a)]
                       for a in np.arange(700) * -2 * np.pi / 700])
    assert poly_kernel.launch_plan(1, 5, len(many), 1, False).scratch_words > 0
    pos3, quats, n_poses = _batch(seed=7, P=4, N=5)
    got = est.check_polygonal_paths_batch(pos3, quats, n_poses, many)
    stats = est.last_polygonal_dispatch
    assert (stats["evaluator"], stats["reason"]) == ("grouped", "ok") and len(spy) == 1
    want = tfp.check_polygonal_paths_grouped(
        est.query_state, pos3, quats, n_poses, many, stats["group_window"], False,
        stats["translate_only"])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
