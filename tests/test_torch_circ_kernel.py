"""Kernel 4's wrapper (``ops/circ_kernel.py``) and the dispatch in
``ops/footprint.py::check_circular_paths`` on the CPU: a CPU state runs the
plain version (exactly, with no launch counted), a CUDA state never does
(it raises here, where there is no card), the estimator's three circular
call sites reach the dispatch, and the integer sample formula the kernel
uses (``sample_cells``) gives the Bresenham walk's stride-4 cells.

Kernel 4 walks every segment whole (no sample cap from the host): the
plain version at the estimator's cap (``_max_segment_cells``) equals the
plain version walking every segment whole, bit for bit, and the JAX
package's ``check_circular_paths`` at that cap. A serial transliteration of
the kernel (its single-pose spiral walk with ``_prefix_sum``'s pairwise
sums, its segment walk and its lane tree) equals ``check_circles`` bit for
bit and the plain version's verdicts exactly (traversability within 1e-6,
its own bar against JAX), and its stages of a block's poses give every
lane its segments in order. The estimator's batch, tick and served paths
pass no cap on either device and run no ``check_circles`` on the host side
of the kernel, and non-finite poses raise on a CUDA state what they raise
on the CPU. The kernel itself runs on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traversability_estimation_tpu.ops import footprint as jfp
from traversability_estimation_tpu_torch import EstimatorConfig, FootprintPath, TraversabilityEstimator
from traversability_estimation_tpu_torch.grid.geometry import line_cells_batch
from traversability_estimation_tpu_torch.models import estimator as est_mod
from traversability_estimation_tpu_torch.ops import circ_kernel
from traversability_estimation_tpu_torch.ops import footprint as tfp
from traversability_estimation_tpu_torch.ops.filters import f32, fma_f32, rcp

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


def test_cpu_paths_pass_no_cap(est, monkeypatch):
    """On the CPU too, the batch, the served circular paths and the fused
    tick ask the plain version to walk every segment whole
    (``max_segment_cells=None``) and make no pass over the poses' lengths
    (``_max_segment_cells``)."""
    caps, spied = [], []
    plain = tfp.check_circular_paths_plain
    cells = TraversabilityEstimator._max_segment_cells

    def recording(*args):
        caps.append(args[5])
        return plain(*args)

    def spy_cells(self, *args):
        spied.append("_max_segment_cells")
        return cells(self, *args)

    monkeypatch.setattr(tfp, "check_circular_paths_plain", recording)
    monkeypatch.setattr(TraversabilityEstimator, "_max_segment_cells", spy_cells)
    poses, n_poses = _batch(seed=6)
    est.check_circular_paths_batch(poses, n_poses, 0.3)
    est.check_footprint_path([FootprintPath(poses=poses[k, :3], radius=0.3) for k in range(4)])
    e = TraversabilityEstimator(EstimatorConfig(resolution=0.05), device="cpu")
    assert e.update(_terrain(160, 160, seed=91))
    patch, centre, tick_poses, tick_n = _tick_args(9)
    assert e.online_tick(patch, centre, tick_poses, tick_n, radius=0.3) is not None
    assert any(k[0] == "tick_crop" for k in e._epoch.fields)  # the tick ran fused
    assert caps == [None, None, None] and spied == []


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
    """A warp per path; a block's poses and their cells (16 bytes a pose) in
    shared memory, a stage of at most 4 x 512 segment starts and the pose
    after them (32 KB) at a time."""
    for N, smem in ((1, 64), (10, 640), (50, 3200), (512, 32768), (513, 32784),
                    (800, 32784)):
        plan = circ_kernel.launch_plan(P, N)
        assert (plan.grid, plan.block) == (grid, 32 * circ_kernel.WARPS)
        assert plan.grid * circ_kernel.WARPS >= P > (plan.grid - 1) * circ_kernel.WARPS
        assert plan.smem == smem <= 48 * 1024


def _stage_walk(P, N, n_poses):
    """Kernel 4's stages transliterated: per path and lane, the segments j
    the lane walks, in its order, over every stage of the path's block;
    each segment's staged poses lie in the stage, which fits the plan's
    shared memory."""
    S, W = circ_kernel.STAGE_POSES, circ_kernel.WARPS
    plan = circ_kernel.launch_plan(P, N)
    order = {}
    for blk in range(plan.grid):
        first = blk * W
        total = min(W, P - first) * N
        c0 = 0
        while True:
            count = min(S + 1, total - c0)
            assert 1 <= count and 16 * count <= plan.smem
            for w in range(W):
                p = first + w
                last = min(N - 1, int(n_poses[p]) - 1) if p < P else 0
                lo, hi = max(0, c0 - w * N), min(last, c0 + S - w * N)
                for lane in range(32):
                    for j in range(lo + ((lane - lo) & 31), hi, 32):
                        i = w * N + j - c0
                        assert 0 <= i and i + 1 < count
                        order.setdefault((p, lane), []).append(j)
            if c0 + S + 1 >= total:
                break
            c0 += S
    return order


@pytest.mark.parametrize("P, N", [(5, 1), (7, 50), (4, 512), (6, 513), (9, 800), (3, 2049),
                                  (5, 3000)])
def test_stages_walk_every_segment_in_lane_order(P, N):
    """Over the stages of its block's poses, lane l of a path's warp walks
    the path's valid segments l, l + 32, l + 64, ... once each and in that
    order, as one stage would: the sums do not depend on the staging."""
    rng = np.random.default_rng(N)
    n_poses = rng.integers(0, N + 2, P)
    n_poses[: min(P, 3)] = [0, 1, N][: min(P, 3)]
    order = _stage_walk(P, N, n_poses)
    for p in range(P):
        last = min(N - 1, int(n_poses[p]) - 1)
        for lane in range(32):
            assert order.get((p, lane), []) == list(range(lane, max(last, 0), 32))
    assert sum(map(len, order.values())) == sum(max(min(N - 1, int(k) - 1), 0) for k in n_poses)


def test_launch_plan_refuses_an_empty_batch():
    with pytest.raises(ValueError):
        circ_kernel.launch_plan(0, 10)
    with pytest.raises(ValueError):
        circ_kernel.launch_plan(4, 0)


def test_work_counts_follow_the_data(est):
    """Samples read: the valid samples of the valid segments, as the plain
    version's masks count them, capped or whole; the single-pose paths'
    spiral positions to their first failure (or all of them), as the serial
    transliteration visits them; bytes and operations grow with them."""
    qs = est.query_state
    poses, n_poses = _batch(seed=3)
    w = circ_kernel.work_counts(qs, poses, n_poses, 0.3, 0.15, 16)
    p, n = torch.from_numpy(poses), torch.from_numpy(n_poses)
    seg_valid = torch.arange(1, poses.shape[1])[None, :] < n[:, None]
    _, valid, _ = line_cells_batch(tfp._index_of(qs, p[:, 1:]), tfp._index_of(qs, p[:, :-1]), 16)
    assert w.segments == int(seg_valid.sum())
    assert w.samples == int((valid[..., ::4] & seg_valid[..., None]).sum())
    assert w.segments < w.samples <= 4 * w.segments
    whole = circ_kernel.work_counts(qs, poses, n_poses, 0.3, 0.15, None)
    m = tfp.whole_segment_cells(qs, poses, n_poses)
    _, valid, _ = line_cells_batch(tfp._index_of(qs, p[:, 1:]), tfp._index_of(qs, p[:, :-1]), m)
    assert whole.samples == int((valid[..., ::4] & seg_valid[..., None]).sum()) > w.samples
    singles = [k for k in range(len(n_poses)) if n_poses[k] == 1]
    assert whole.single_paths == len(singles) >= 1
    visited = [_serial_single(qs, poses[k, 0], 0.45, 0.3)[2] for k in singles]
    assert whole.spiral_cells == sum(visited) and whole.table_entries == max(visited)
    assert 0 < whole.spiral_reads <= whole.spiral_cells and 0 <= whole.outer_cells
    none = circ_kernel.work_counts(qs, poses, n_poses, 0.3, 0.15, None, has_single_pose=False)
    assert none.single_paths == none.spiral_cells == none.table_entries == 0
    P, N = poses.shape[:2]
    assert circ_kernel.kernel_bytes(P, N, whole) == circ_kernel.kernel_bytes(P, N, none) + 5 * (
        whole.samples - none.samples) + 5 * whole.spiral_reads + 8 * whole.table_entries
    more = dataclasses.replace(w, samples=w.samples + 1)
    assert circ_kernel.kernel_operations(P, more) == circ_kernel.kernel_operations(P, w) + 4
    assert circ_kernel.kernel_operations(P, whole) > circ_kernel.kernel_operations(P, none)


# ---------------------------------------------------------------------------
# kernel 4 transliterated: its arithmetic in float32, serially, in its order


def _origin(state):
    """(p0x, p0y, res, res_rcp) as the kernel computes them."""
    H, W = state.shape
    res = np.float32(f32(state.resolution))
    pos = state.position.numpy().astype(np.float32)
    p0 = [pos[a] + (np.float32(n) * res) * np.float32(0.5) for a, n in enumerate((H, W))]
    return p0[0], p0[1], res, np.float32(rcp(state.resolution))


def _cell(p0, x, res_rcp):
    return int(np.floor((np.float32(p0) - np.float32(x)) * res_rcp))


def _shfl_down(v, o):
    """__shfl_down_sync over 32 lanes: a lane past the warp keeps its own."""
    out = v.copy()
    out[: 32 - o] = v[o:]
    return out


def _serial_single(state, center, rmax, rmin):
    """Kernel 4's single-pose walk (``single_pose`` in csrc/circ_paths.cu):
    (ok, trav, spiral positions visited: to the first failure or all)."""
    trav = state.traversability.numpy()
    mask = state.traversable_mask.numpy()
    H, W = trav.shape
    p0x, p0y, res, res_rcp = _origin(state)
    px, py = np.float32(center[0]), np.float32(center[1])
    default = np.float32(state.default_traversability)
    tx, ty = p0x - px, p0y - py
    if not (tx >= 0 and tx < np.float32(H) * res and ty >= 0 and ty < np.float32(W) * res):
        return bool(default != 0), default, 0
    ci0, cj0 = _cell(p0x, px, res_rcp), _cell(p0y, py, res_rcp)
    table = circ_kernel.spiral_table(rmax, state.resolution)
    K = len(table)
    ci = ci0 + (table[:, 0] >> 16)
    cj = cj0 + (table[:, 0] & 0xFFFF).astype(np.uint16).view(np.int16).astype(np.int32)
    outer = table[:, 1] < 0
    radius = np.abs(table[:, 1].view(np.float32))
    active = (ci >= 0) & (ci < H) & (cj >= 0) & (cj < W)
    g = [torch.from_numpy(-(c.astype(np.float32) + np.float32(0.5))) for c in (ci, cj)]
    gx = fma_f32(g[0], float(res), float(p0x)).numpy()
    gy = fma_f32(g[1], float(res), float(p0y)).numpy()
    dx, dy = torch.from_numpy(gx - px), torch.from_numpy(gy - py)
    d2 = fma_f32(dy, dy, dx * dx).numpy()
    active &= ~outer | (d2 <= np.float32(rmax * rmax))
    t = trav[np.clip(ci, 0, H - 1), np.clip(cj, 0, W - 1)]
    tvf = np.where(np.isfinite(t), t, default).astype(np.float32)
    v = np.where(mask[np.clip(ci, 0, H - 1), np.clip(cj, 0, W - 1)], tvf,
                 np.float32(-1) - tvf).astype(np.float32)
    passing = active & (v >= 0)
    failing = active & ~(v >= 0)
    v = np.where(passing, v, np.float32(0)).astype(np.float32)

    level, chunks, count, first_fail, rest = {}, 0, 0, -1, 0
    for base in range(0, K, 32):
        lane_v = np.zeros(32, np.float32)
        lane_v[: min(32, K - base)] = v[base:base + 32]
        take = min(32, K - base)
        fails = np.flatnonzero(failing[base:base + 32])
        if len(fails):
            first_fail = base + int(fails[0])
            take = first_fail - base + 1
        count += int(passing[base:base + take].sum())
        part = [lane_v]
        for lv in range(1, 6):
            part.append((part[-1] + _shfl_down(part[-1], 1 << (lv - 1))).astype(np.float32))
        if take == 32:
            carry, a = part[5][0], 0
            while (chunks >> a) & 1:
                carry = np.float32(level[a] + carry)
                a += 1
            level[a] = carry
            chunks += 1
        else:
            rest = take
        if len(fails) or take < 32:
            break
    blocks = [level[a] for a in range(31, -1, -1) if (chunks >> a) & 1]
    off = 0
    for lv in range(5, -1, -1):
        if (rest >> lv) & 1:
            blocks.append(part[lv][off])
            off += 1 << lv
    total = blocks[0]
    for b in blocks[1:]:
        total = np.float32(total + b)
    mean = np.float32(total / np.float32(max(count, 1)))
    visited = K if first_fail < 0 else first_fail + 1
    any_fail = first_fail >= 0
    if rmin == 0.0:
        return not any_fail, np.float32(0) if any_fail else mean, visited
    r_fail = radius[first_fail] if any_fail else np.float32(0)
    rmin32 = np.float32(rmin)
    hard = any_fail and r_fail <= rmin32
    inflate = any_fail and r_fail > rmin32
    factor = fma_f32(torch.tensor([r_fail - rmin32]), rcp(rmax - rmin), 1.0).numpy()[0]
    factor = np.float32(factor * np.float32(0.5))
    trav_out = np.float32(mean * factor) if inflate else (np.float32(0) if hard else mean)
    return not hard, trav_out, visited


def _serial_kernel(state, poses, n_poses, radius, offset, max_cells, field, single):
    """Kernel 4 on a batch, serially (``circ_paths_kernel``): (safe (P,),
    trav (P,)) as numpy arrays."""
    field_ok, field_trav = (f.numpy() for f in field)
    H, W = field_ok.shape
    p0x, p0y, res, res_rcp = _origin(state)
    default = float(state.default_traversability)
    fill = np.float32(default if default != 0.0 else -1.0 - default)
    S = circ_kernel.samples_per_segment(max_cells)
    P, N, _ = poses.shape
    safe = np.zeros(P, bool)
    trav = np.zeros(P, np.float32)
    for p in range(P):
        n = int(n_poses[p])
        if N == 1 or n == 1:
            ok1, trav1 = False, np.float32(0)
            if N == 1 or single:
                ok1, trav1, _ = _serial_single(state, poses[p, 0], radius + offset, radius)
            safe[p] = ok1 and n >= 1
            trav[p] = trav1 if (ok1 if N == 1 else safe[p]) else 0
            continue
        lanes = np.zeros((4, 32), np.float32)  # lengths, weighted, plain, count
        lane_ok = np.ones(32, bool)
        for j in range(min(N - 1, n - 1)):
            s, e = poses[p, j].astype(np.float32), poses[p, j + 1].astype(np.float32)
            fi, fj = _cell(p0x, e[0], res_rcp), _cell(p0y, e[1], res_rcp)
            li, lj = _cell(p0x, s[0], res_rcp), _cell(p0y, s[1], res_rcp)
            di, dj = abs(li - fi), abs(lj - fj)
            si, sj = (1 if li >= fi else -1), (1 if lj >= fj else -1)
            x_dom = di >= dj
            denom, num_add = (di, dj) if x_dom else (dj, di)
            seg_ok, n_s, acc, t = True, 0, np.float32(0), 0
            while t < S and 4 * t <= denom:
                k = 4 * t
                over = 0 if k == 0 else (denom // 2 + k * num_add) // max(denom, 1)
                ci, cj = fi + si * (k if x_dom else over), fj + sj * (over if x_dom else k)
                v = fill
                if 0 <= ci < H and 0 <= cj < W:
                    tv = field_trav[ci, cj]
                    v = tv if field_ok[ci, cj] else np.float32(np.float32(-1) - tv)
                ok_s = v >= 0
                seg_ok = seg_ok and ok_s
                acc = np.float32(acc + (v if ok_s else np.float32(np.float32(-1) - v)))
                n_s += 1
                t += 1
            seg_trav = np.float32(acc / np.float32(max(n_s, 1)))
            d = e - s
            length = np.float32(np.sqrt(np.float64(np.float32(d[0] * d[0] + d[1] * d[1]))))
            lane = j % 32
            lane_ok[lane] &= seg_ok
            lanes[:, lane] = (lanes[:, lane]
                              + np.float32([length, length * seg_trav, seg_trav, 1])).astype(
                                  np.float32)
        for o in (16, 8, 4, 2, 1):
            lanes = np.stack([(row + _shfl_down(row, o)).astype(np.float32) for row in lanes])
        sum_len, sum_wt, sum_t, cnt = lanes[:, 0]
        uniform = not (sum_len > 0)
        num, den = (sum_t, cnt) if uniform else (sum_wt, sum_len)
        den = np.float32(1e-30) if den < np.float32(1e-30) else den
        safe[p] = bool(lane_ok.all()) and n >= 1
        trav[p] = np.float32(num / den) if safe[p] else 0
    return safe, trav


def _jax_state(qs):
    return jfp.QueryState(
        traversability=jnp.asarray(qs.traversability.numpy()),
        traversable_mask=jnp.asarray(qs.traversable_mask.numpy()),
        position=jnp.asarray(qs.position.numpy()), resolution=qs.resolution,
        default_traversability=qs.default_traversability)


def _centers(qs, rng, n):
    """Sub-cell poses over the map and a little past it, a quarter of them
    on cell borders."""
    p0x, p0y, res, _ = _origin(qs)
    H, W = qs.shape
    c = np.stack([p0x - rng.uniform(-0.1, 1.05, n) * H * float(res),
                  p0y - rng.uniform(-0.1, 1.05, n) * W * float(res)], -1).astype(np.float32)
    k = rng.integers(0, min(H, W), (n // 4, 2))
    c[: n // 4] = np.stack([p0x - k[:, 0] * res, p0y - k[:, 1] * res], -1).astype(np.float32)
    return c


@pytest.mark.parametrize("rmin, default", [(0.3, 0.5), (0.0, 0.5), (0.3, 0.0)])
def test_serial_single_pose_walk_equals_check_circles(est, rmin, default):
    """The kernel's single-pose walk, transliterated: verdicts and
    traversability bit for bit ``check_circles``' (its ``_prefix_sum``
    order), and the JAX package's check_circles within its bar (1e-6)."""
    base = est.query_state
    qs = tfp.QueryState(base.traversability, base.traversable_mask, base.position, RES, default)
    rng = np.random.default_rng(int(10 * rmin) + int(10 * default))
    centers = _centers(qs, rng, 240)
    rmax = rmin + 0.15 if rmin else 0.45
    ok_t, tv_t = tfp.check_circles(qs, torch.from_numpy(centers), rmax, rmin)
    got = [_serial_single(qs, c, rmax, rmin) for c in centers]
    ok_s = np.array([g[0] for g in got])
    tv_s = np.array([g[1] for g in got], np.float32)
    np.testing.assert_array_equal(ok_s, ok_t.numpy())
    np.testing.assert_array_equal(tv_s.view(np.int32), tv_t.numpy().view(np.int32))
    ok_j, tv_j = jax.jit(lambda s, c: jfp.check_circles(s, c, rmax, rmin))(
        _jax_state(qs), jnp.asarray(centers))
    np.testing.assert_array_equal(ok_s, np.asarray(ok_j))
    np.testing.assert_allclose(tv_s, np.asarray(tv_j), rtol=0, atol=1e-6)
    visited = np.array([g[2] for g in got])
    K = len(circ_kernel.spiral_table(rmax, RES))
    # verdicts of both kinds, walks cut at a failure and walks of all K
    assert ok_s.any() and not ok_s.all()
    assert (visited == K).any() and ((visited > 0) & (visited < K)).any()
    assert (visited > 32).any() and (visited % 32 != 0).any()


@pytest.mark.parametrize("N, has_single_pose, max_cells", [
    (9, True, None), (9, True, 16), (9, False, None), (1, True, None), (2, True, 8)])
def test_serial_kernel_matches_the_plain_version(est, N, has_single_pose, max_cells):
    """The kernel transliterated over a whole edge batch (pose counts 0, 1,
    2, N and more, a path off the map, long and zero-length segments),
    capped and whole: verdicts equal to the plain version's, single-pose
    paths bit for bit, traversability within 1e-6."""
    qs = est.query_state
    poses, n_poses = _batch(seed=40 + N, N=N)
    field = tfp.dense_circle_field(qs, 0.45, 0.3)
    want = tfp.check_circular_paths_plain(qs, poses, n_poses, 0.3, 0.15, max_cells, field,
                                          has_single_pose)
    safe, trav = _serial_kernel(qs, poses, n_poses, 0.3, 0.15, max_cells, field,
                                has_single_pose)
    np.testing.assert_array_equal(safe, want[0].numpy())
    np.testing.assert_allclose(trav, want[1].numpy(), rtol=0, atol=1e-6)
    one = (n_poses == 1) if N > 1 else np.ones(len(n_poses), bool)
    np.testing.assert_array_equal(trav[one].view(np.int32), want[1].numpy()[one].view(np.int32))
    assert safe.any() and not safe.all()


def _cap_batch(qs, kind, seed, N=12):
    """Batches for the sample cap: random walks with steps up to ~20 cells;
    poses on cell borders; or a batch whose longest segment spans a whole
    number of cells from a border, on both axes and diagonally."""
    rng = np.random.default_rng(seed)
    p0x, p0y, res, _ = _origin(qs)
    P = 32
    starts = qs.position.numpy() + rng.uniform(-0.8, 0.8, (P, 2))
    steps = rng.uniform(-1, 1, (P, N - 1, 2)) * rng.choice([0.05, 0.3, 0.6], (P, 1, 1))
    poses = np.concatenate([starts[:, None], starts[:, None] + np.cumsum(steps, 1)], 1)
    if kind == "borders":
        k = np.round((np.float32([p0x, p0y]) - poses) / float(res))
        poses = np.float32([p0x, p0y]) - k * res
    elif kind == "longest":
        m = int(rng.integers(20, 30))
        for q, d in enumerate(([1, 0], [0, 1], [1, 1], [-1, 0])):
            k0 = rng.integers(5, 20, 2)
            b = np.float32([p0x, p0y]) - k0 * res
            poses[q] = b + np.arange(N)[:, None] * np.float32(d) * m * res
    n_poses = rng.integers(0, N + 1, P).astype(np.int32)
    n_poses[:4] = N
    return poses.astype(np.float32), n_poses


@pytest.mark.parametrize("kind", ["random", "borders", "longest"])
@pytest.mark.parametrize("seed", [0, 1])
def test_whole_walk_equals_the_estimators_cap(est, kind, seed):
    """The cap never binds: the plain version at ``_max_segment_cells``' cap
    equals the plain version walking every segment whole, bit for bit, and
    the JAX package's check_circular_paths at that cap (verdicts equal,
    traversability within 1e-6)."""
    qs = est.query_state
    poses, n_poses = _cap_batch(qs, kind, seed)
    cap = est._max_segment_cells(poses, n_poses)
    assert tfp.whole_segment_cells(qs, poses, n_poses) <= cap
    field = tfp.dense_circle_field(qs, 0.45, 0.3)
    capped = tfp.check_circular_paths_plain(qs, poses, n_poses, 0.3, 0.15, cap, field, True)
    whole = tfp.check_circular_paths_plain(qs, poses, n_poses, 0.3, 0.15, None, field, True)
    assert torch.equal(capped[0], whole[0])
    assert torch.equal(capped[1].view(torch.int32), whole[1].view(torch.int32))
    js = _jax_state(qs)
    jfield = jax.jit(jfp.dense_circle_field, static_argnums=(1, 2))(js, 0.45, 0.3)
    safe_j, tv_j = jax.jit(
        lambda s, p, n, f: jfp.check_circular_paths(s, p, n, 0.3, 0.15, cap, f, True))(
        js, jnp.asarray(poses), jnp.asarray(n_poses), jfield)
    np.testing.assert_array_equal(whole[0].numpy(), np.asarray(safe_j))
    np.testing.assert_allclose(whole[1].numpy(), np.asarray(tv_j), rtol=0, atol=1e-6)
    assert whole[0].any() and not whole[0].all()


def test_cap_never_binds_on_random_batches(est):
    """Over 300 random batches (steps up to 40 cells, poses on borders in a
    third of them) the estimator's cap covers every valid segment's line,
    so a whole walk samples what the capped one does."""
    qs = est.query_state
    rng = np.random.default_rng(7)
    p0 = np.float32(_origin(qs)[:2])
    for b in range(300):
        P, N = int(rng.integers(1, 9)), int(rng.integers(2, 12))
        scale = rng.choice([0.01, 0.1, 0.5, 1.2])
        poses = (qs.position.numpy() + rng.uniform(-1, 1, (P, 1, 2))
                 + np.cumsum(rng.uniform(-scale, scale, (P, N, 2)), 1))
        if b % 3 == 0:
            poses = p0 - np.round((p0 - poses) / RES) * np.float32(RES)
        poses = poses.astype(np.float32)
        n_poses = rng.integers(0, N + 1, P).astype(np.int32)
        assert tfp.whole_segment_cells(qs, poses, n_poses) <= est._max_segment_cells(
            poses, n_poses)


# ---------------------------------------------------------------------------
# the estimator on a CUDA state: no cap, no check_circles, the same errors


@pytest.fixture
def card(monkeypatch):
    """An estimator whose query states say they lie on a CUDA device, with
    kernel 4's wrapper replaced by a recorder of its arguments (answers all
    unsafe) and kernel 2 by its plain version; spies on
    ``_max_segment_cells`` and ``check_circles``. Returns (estimator,
    recorded calls, spied calls)."""
    e = TraversabilityEstimator(EstimatorConfig(resolution=0.05), device="cpu")
    assert e.update(_terrain(160, 160, seed=91))
    monkeypatch.setattr(tfp, "QueryState", _CudaState)
    qs = e._epoch.state
    e._epoch = dataclasses.replace(e._epoch, state=_CudaState(
        qs.traversability, qs.traversable_mask, qs.position, qs.resolution,
        qs.default_traversability))
    plain_state = _CudaState.__mro__[1]

    def field(state, rmax, rmin, *args):
        return tfp.dense_circle_field(plain_state(
            state.traversability, state.traversable_mask, state.position, state.resolution,
            state.default_traversability), rmax, rmin, *args)

    monkeypatch.setattr(est_mod, "dense_circle_field", field)
    calls, spied = [], []

    def kernel(state, poses, n_poses, radius, offset=0.15, max_segment_cells=64, field=None,
               has_single_pose=True):
        assert isinstance(state, _CudaState)
        calls.append((np.asarray(poses).shape, max_segment_cells, has_single_pose))
        P = np.asarray(poses).shape[0]
        return torch.zeros(P, dtype=torch.bool), torch.zeros(P)

    monkeypatch.setattr(circ_kernel, "check_circular_paths", kernel)
    cells = TraversabilityEstimator._max_segment_cells
    circles = tfp.check_circles

    def spy_cells(self, *args):
        spied.append("_max_segment_cells")
        return cells(self, *args)

    def spy_circles(*args, **kwargs):
        spied.append("check_circles")
        return circles(*args, **kwargs)

    monkeypatch.setattr(TraversabilityEstimator, "_max_segment_cells", spy_cells)
    monkeypatch.setattr(tfp, "check_circles", spy_circles)
    return e, calls, spied


def _tick_args(seed, poses=None):
    rng = np.random.default_rng(seed)
    patch = (0.03 * rng.standard_normal((40, 40))).astype(np.float32)
    if poses is None:
        starts = rng.uniform(-0.6, 0.6, (8, 2))
        poses = np.concatenate(
            [starts[:, None], starts[:, None] + np.cumsum(rng.uniform(-0.08, 0.08, (8, 3, 2)), 1)],
            1).astype(np.float32)
    n_poses = np.full(len(poses), poses.shape[1], np.int32)
    n_poses[0] = 1
    return patch, (0.25, -0.15), poses, n_poses


def test_card_paths_pass_no_cap_and_run_no_check_circles(card):
    """On a CUDA state the batch, the served circular paths (with a path of
    one pose) and the fused tick reach kernel 4 once each, with
    ``max_segment_cells=None``, and call neither ``_max_segment_cells`` nor
    ``check_circles``."""
    e, calls, spied = card
    poses, n_poses = _batch(seed=2)
    e.check_circular_paths_batch(poses, n_poses, 0.3)
    assert calls == [(poses.shape, None, True)]
    paths = [FootprintPath(poses=poses[k, :4], radius=0.3) for k in range(6)]
    paths.append(FootprintPath(poses=poses[6, :1], radius=0.3))
    results = e.check_footprint_path(paths)
    assert len(calls) == 2 and calls[1][1:] == (None, True) and calls[1][0][0] == 7
    assert not any(r.is_safe for r in results)
    patch, centre, tick_poses, tick_n = _tick_args(8)
    assert e.online_tick(patch, centre, tick_poses, tick_n, radius=0.3) is not None
    assert calls[2:] == [(tick_poses.shape, None, True)]
    assert any(k[0] == "tick_crop" for k in e._epoch.fields)  # the tick ran fused
    assert spied == []


@pytest.mark.parametrize("bad", ["nan", "inf", "-inf", "huge"])
@pytest.mark.parametrize("path", ["batch", "served", "tick"])
def test_card_paths_raise_what_the_cpu_raises(est, card, bad, path):
    """Non-finite poses (and finite ones whose lengths overflow float32)
    raise on a CUDA state the exception they raise on the CPU, before
    kernel 4; a finite batch passes the check without a pass over its
    lengths."""
    e, calls, spied = card
    cpu = TraversabilityEstimator(EstimatorConfig(resolution=0.05), device="cpu")
    assert cpu.update(_terrain(160, 160, seed=91))
    poses, n_poses = _batch(seed=5)
    poses = poses[:, :4].copy()
    n_poses = np.maximum(np.minimum(n_poses, 4), 2)
    poses[3, 2] = {"nan": np.nan, "inf": np.inf, "-inf": -np.inf, "huge": 3e19}[bad]

    def run(x):
        if path == "batch":
            return x.check_circular_paths_batch(poses, n_poses, 0.3)
        if path == "served":
            return x.check_footprint_path([FootprintPath(poses=p, radius=0.3) for p in poses])
        return x.online_tick(*_tick_args(3, poses)[:2], poses, n_poses, radius=0.3)

    with pytest.raises(Exception) as on_cpu:
        run(cpu)
    with pytest.raises(type(on_cpu.value)):
        run(e)
    assert calls == [] and "check_circles" not in spied
