"""Kernel 4's wrapper (``ops/circ_kernel.py``) and the dispatch in
``ops/footprint.py::check_circular_paths`` on the CPU: a CPU state runs the
plain version (exactly, with no launch counted), a CUDA state never does
(it raises here, where there is no card), the estimator's three circular
call sites reach the dispatch, and the integer sample formula the kernel
uses (``sample_cells``) gives the Bresenham walk's stride-4 cells. The
kernel itself runs on the card (``tests/test_torch_kernels.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from traversability_estimation_tpu_torch import EstimatorConfig, FootprintPath, TraversabilityEstimator
from traversability_estimation_tpu_torch.grid.geometry import line_cells_batch
from traversability_estimation_tpu_torch.ops import circ_kernel
from traversability_estimation_tpu_torch.ops import footprint as tfp

RES = 0.03


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
    assert e.update(_terrain(70, 64, seed=4), position=(0.1, -0.05))
    return e


def _batch(seed, P=24, N=9):
    """Random-walk paths with ragged pose counts (0, 1, 2, N and more than
    N among them), one path off the map, one with segments longer than 16
    cells and one of zero length."""
    rng = np.random.default_rng(seed)
    starts = np.array([0.1, -0.05]) + rng.uniform(-1.0, 1.0, (P, 2))
    steps = rng.uniform(-0.1, 0.1, (P, N - 1, 2))
    steps[3] *= 10
    steps[4] = 0.0
    poses = np.concatenate([starts[:, None], starts[:, None] + np.cumsum(steps, 1)], 1)
    poses[5] += 2.5
    n_poses = rng.integers(0, N + 1, P).astype(np.int32)
    n_poses[:5] = [0, 1, 2, N, N + 2]
    return poses.astype(np.float32), n_poses


@pytest.mark.parametrize("N, has_single_pose, max_cells", [
    (9, True, 16), (9, False, 8), (2, True, 64), (1, True, 16)])
def test_cpu_state_runs_the_plain_version(est, N, has_single_pose, max_cells):
    qs = est.query_state
    poses, n_poses = _batch(seed=N, N=N)
    field = tfp.dense_circle_field(qs, 0.45, 0.3)
    before = circ_kernel.check_circular_paths.launches
    got = tfp.check_circular_paths(qs, poses, n_poses, 0.3, 0.15, max_cells, field,
                                   has_single_pose)
    want = tfp.check_circular_paths_plain(qs, poses, n_poses, 0.3, 0.15, max_cells, field,
                                          has_single_pose)
    assert circ_kernel.check_circular_paths.launches == before
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and g.dtype == w.dtype and torch.equal(g, w)
    assert got[0].any() and not got[0].all()


class _CudaState(tfp.QueryState):
    """A query state that says it lies on a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda")


def test_cuda_state_never_runs_the_plain_version(est, monkeypatch):
    """No fallback: on a host without CUDA a CUDA state raises, the plain
    version is never run and no launch is counted; another device type
    raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA state")

    monkeypatch.setattr(tfp, "check_circular_paths_plain", plain)
    qs = est.query_state
    poses, n_poses = _batch(seed=1)
    before = circ_kernel.check_circular_paths.launches
    state = _CudaState(qs.traversability, qs.traversable_mask, qs.position, RES)
    with pytest.raises((RuntimeError, AssertionError), match="CUDA|cuda"):
        tfp.check_circular_paths(state, poses, n_poses, 0.3)
    assert circ_kernel.check_circular_paths.launches == before

    class _MetaState(_CudaState):
        device = property(lambda self: torch.device("meta"))

    with pytest.raises(ValueError, match="unsupported device"):
        tfp.check_circular_paths(
            _MetaState(qs.traversability, qs.traversable_mask, qs.position, RES), poses,
            n_poses, 0.3)


@pytest.fixture
def spy(monkeypatch):
    """Record each call of the plain version (what the dispatch runs on the
    CPU) and run it."""
    calls = []
    plain = tfp.check_circular_paths_plain

    def recording(*args, **kwargs):
        calls.append(np.asarray(args[1]).shape)
        return plain(*args, **kwargs)

    monkeypatch.setattr(tfp, "check_circular_paths_plain", recording)
    return calls


def test_call_sites_reach_the_dispatch(est, spy):
    """``check_circular_paths_batch``, the service's circular paths and the
    fused online tick each go through ``check_circular_paths``, once per
    batch."""
    poses, n_poses = _batch(seed=2)
    est.check_circular_paths_batch(poses, np.maximum(n_poses, 1), 0.3)
    assert spy == [poses.shape]
    paths = [FootprintPath(poses=poses[k, :4], radius=0.3) for k in range(6)]
    paths.append(FootprintPath(poses=poses[6, :2], radius=0.2))
    est.check_footprint_path(paths)
    assert len(spy) == 3  # one batch per radius
    e = TraversabilityEstimator(EstimatorConfig(resolution=0.05), device="cpu")
    assert e.update(_terrain(160, 160, seed=91))
    rng = np.random.default_rng(8)
    patch = (0.03 * rng.standard_normal((40, 40))).astype(np.float32)
    starts = rng.uniform(-0.6, 0.6, (8, 2))
    tick_poses = np.concatenate(
        [starts[:, None], starts[:, None] + np.cumsum(rng.uniform(-0.08, 0.08, (8, 3, 2)), 1)],
        1).astype(np.float32)
    assert e.online_tick(patch, (0.25, -0.15), tick_poses, np.full(8, 4, np.int32),
                         radius=0.3) is not None
    assert spy[3:] == [tick_poses.shape]


@pytest.mark.parametrize("m", [8, 16, 64])
def test_sample_cells_are_the_line_walk_every_fourth_cell(m):
    """``sample_cells`` (the kernel's closed form, one sample at a time)
    equals ``line_cells_batch(end, start, m)[..., ::4, :]`` on the valid
    cells, with the same valid mask, for every offset |di|, |dj| <= 40
    from a few start cells."""
    d = np.arange(-40, 41)
    offs = np.stack(np.meshgrid(d, d, indexing="ij"), -1).reshape(-1, 2)
    first = np.concatenate([offs * 0 + c for c in ((0, 0), (7, -3), (-120, 55))])
    last = first + np.concatenate([offs] * 3)
    first_t = torch.from_numpy(first.astype(np.int32))
    last_t = torch.from_numpy(last.astype(np.int32))
    cells, valid = circ_kernel.sample_cells(first_t, last_t, m)
    want_cells, want_valid, _ = line_cells_batch(first_t, last_t, m)
    want_cells, want_valid = want_cells[:, ::4], want_valid[:, ::4]
    assert cells.dtype == torch.int32 and cells.shape == want_cells.shape
    assert torch.equal(valid, want_valid)
    assert torch.equal(cells[valid], want_cells[want_valid])
    assert cells.shape[1] == circ_kernel.samples_per_segment(m)


@pytest.mark.parametrize("P, grid", [(1, 1), (4, 1), (5, 2), (256, 64), (1024, 256)])
def test_launch_plan(P, grid):
    plan = circ_kernel.launch_plan(P)
    assert (plan.grid, plan.block) == (grid, 32 * circ_kernel.WARPS)
    assert plan.grid * circ_kernel.WARPS >= P > (plan.grid - 1) * circ_kernel.WARPS


def test_launch_plan_refuses_an_empty_batch():
    with pytest.raises(ValueError):
        circ_kernel.launch_plan(0)


def test_work_counts_follow_the_data(est):
    """Samples read: the valid samples of the valid segments, as the plain
    version's masks count them; bytes and operations grow with them."""
    qs = est.query_state
    poses, n_poses = _batch(seed=3)
    segments, samples = circ_kernel.work_counts(qs, poses, n_poses, 16)
    p, n = torch.from_numpy(poses), torch.from_numpy(n_poses)
    seg_valid = torch.arange(1, poses.shape[1])[None, :] < n[:, None]
    _, valid, _ = line_cells_batch(tfp._index_of(qs, p[:, 1:]), tfp._index_of(qs, p[:, :-1]), 16)
    assert segments == int(seg_valid.sum())
    assert samples == int((valid[..., ::4] & seg_valid[..., None]).sum())
    assert segments < samples <= 4 * segments
    P, N = poses.shape[:2]
    assert circ_kernel.kernel_bytes(P, N, samples, True) == \
        circ_kernel.kernel_bytes(P, N, samples, False) + 5 * P
    assert circ_kernel.kernel_operations(P, segments, samples + 1) == \
        circ_kernel.kernel_operations(P, segments, samples) + 4
