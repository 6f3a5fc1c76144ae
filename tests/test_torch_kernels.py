"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present (a CUDA kernel
has no CPU mode; the CPU tests reach the plain versions instead). On the
machine with the card, which has no JAX (tests/conftest.py imports it):
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
``chip_smoke.py`` holds the same bars at the main path's shapes. The edge
shapes (1x1, 5x400, 337x335, 100x133 with 4% holes) test the kernels'
ragged tiles: every layer must stay bit-identical to the plain version.

The grouped polygonal evaluator is kernel 3 (``csrc/poly_paths.cu``): its
cases hold it to its plain version on the card, ring by ring (chip_smoke.py
phase 5b's batches at a smaller size, with a batch whose rings' first and
last columns are decided by ties and one of 8 paths, spread over several
blocks each), two launches to the same bits, and its work counters to the
function's work counted from the plain version's values. The polygonal batch cases hold the
CUDA estimator to the same estimator on the CPU (is_safe and dispatch
equal, traversability within 2e-5, area within rtol 1e-5: only the sums run
in another order), and the dense circular service must launch kernel 2.
The dispatch's window plan on the card gives the NumPy planners' integers
on the polygonal cell's own inputs.

The circular path batch is kernel 4 (``csrc/circ_paths.cu``): its cases hold
``check_circular_paths`` on the card (one launch a call, no
``check_circles`` on the card) to its plain version on the same CUDA
tensors at the ``circ_paths_336`` cell's 1024 x 50 batch and the online
tick's 256 x 10, each at the estimator's cap and walked whole, the cell's
batch with a quarter of its paths of one pose, paths of 800 poses (a block's
poses in two stages of shared memory) and edge batches (pose counts 0, 1, 2, N and
more, poses off the map and on its border, segments longer than
``max_segment_cells``, a path of zero length, a default traversability of 0
and of 0.5, a batch of single poses): is_safe equal, traversability within
1e-6 (the plain version's own bar against JAX), a single-pose path's bit for
bit, two launches to the same bits; poses and counts from host arrays give
the same bits as from device tensors.
"""

import numpy as np
import pytest
import torch

from traversability_estimation_tpu_torch import (
    EstimatorConfig,
    FootprintConfig,
    TraversabilityEstimator,
)
from traversability_estimation_tpu_torch.ops import (
    circ_kernel,
    field_kernel,
    footprint,
    update_kernel,
)
from traversability_estimation_tpu_torch.ops.filters import ChainConfig, fma_f32, sqrt_f32
from traversability_estimation_tpu_torch.scripts.kernel3_profile import span_boundary_batch

pytestmark = pytest.mark.cuda

RES = 0.03
# (rows, cols, seed, NaN fraction)
EDGE_SHAPES = [(1, 1, 6, 0.0), (5, 400, 7, 0.02), (337, 335, 8, 0.01), (100, 133, 5, 0.04)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _terrain(rows, cols, seed, nan_frac, noise=0.05, tilt=0.1):
    """Terrain with slopes, a step edge and NaN holes; rough by default (most
    cells vetoed), smooth enough to drive over with a small `noise`."""
    rng = np.random.default_rng(seed)
    x = np.arange(rows)[:, None] * RES
    y = np.arange(cols)[None, :] * RES
    z = (
        0.15 * np.sin(2.0 * x) * np.cos(1.5 * y)
        + noise * rng.standard_normal((rows, cols))
        + 0.3 * ((x > x.mean()) & (y > y.mean()))
        + tilt * x
    )
    z[rng.random((rows, cols)) < nan_frac] = np.nan
    return z.astype(np.float32)


def _same(a, b):
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return bool(torch.equal(a, b))


def _check_update(elev, check_roughness, ulps=0, frame=(), **chain_kw):
    """Kernel 1 against the plain version: one launch, every layer
    bit-identical; with `ulps`, the fused layer within that many float32
    steps instead. `frame`: (origin, global shape) of the array in a larger
    map, given to both."""
    cfg = EstimatorConfig(
        resolution=RES, chain=ChainConfig(resolution=RES, **chain_kw),
        footprint=FootprintConfig(verify_roughness_footprint=check_roughness),
    )
    before = update_kernel.fused_update.launches
    got = update_kernel.fused_update(elev, cfg.chain, cfg.veto, *frame)
    want = update_kernel.fused_update_plain(elev, cfg.chain, cfg.veto, *frame)
    assert update_kernel.fused_update.launches == before + 1
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if ulps and k == "traversability":
            assert torch.equal(torch.isnan(got[k]), torch.isnan(want[k]))
            fin = torch.isfinite(want[k])
            steps = (got[k][fin].view(torch.int32) - want[k][fin].view(torch.int32)).abs()
            assert int(steps.max()) <= ulps, int(steps.max())
        else:
            assert _same(got[k], want[k]), k


def _check_field(elev, radius_min, cuda):
    cfg = EstimatorConfig(resolution=RES)
    layers = update_kernel.fused_update_plain(elev, cfg.chain, cfg.veto)
    state = footprint.QueryState(
        traversability=layers["traversability"], traversable_mask=layers["traversable_mask"],
        position=torch.zeros(2, device=cuda), resolution=RES,
    )
    in_map = torch.as_tensor(np.random.default_rng(1).random(elev.shape) > 0.1, device=cuda)
    for im in (None, in_map):
        before = field_kernel.dense_circle_field.launches
        ok_k, tv_k = field_kernel.dense_circle_field(state, 0.45, radius_min, im)
        ok_p, tv_p = footprint.dense_circle_field(state, 0.45, radius_min, im)
        assert field_kernel.dense_circle_field.launches == before + 1
        assert torch.equal(ok_k, ok_p) and _same(tv_k, tv_p)


@pytest.mark.parametrize("check_roughness", [False, True])
def test_fused_update_kernel_matches_plain(cuda, check_roughness):
    elev = torch.as_tensor(_terrain(77, 101, seed=9, nan_frac=0.05), device=cuda)
    _check_update(elev, check_roughness)


@pytest.mark.parametrize("check_roughness", [False, True])
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_fused_update_kernel_edge_shapes(cuda, shape, check_roughness):
    rows, cols, seed, nan_frac = shape
    _check_update(torch.as_tensor(_terrain(rows, cols, seed, nan_frac), device=cuda),
                  check_roughness)


# (origin, global shape) of a 90 x 120 array: a tile's padded block whose
# halo leaves the map at the top left; an interior block; a block past the
# map's bottom right (the padding that makes a map divide the process grid);
# a frame that cuts the array on every side
FRAMES = [((-11, -11), (300, 300)), ((40, 57), (400, 400)), ((250, 310), (330, 415)),
          ((-5, 9), (70, 100))]


@pytest.mark.parametrize("check_roughness", [False, True])
@pytest.mark.parametrize("frame", FRAMES, ids=lambda f: f"{f[0][0]}_{f[0][1]}_in_{f[1][0]}x{f[1][1]}")
def test_fused_update_kernel_with_a_map_origin(cuda, frame, check_roughness):
    """Kernel 1 placed in a larger map (the tile body of the tiled update):
    cells beyond the map hold no elevation and end no walk; every layer
    bit-identical to the plain version given the same frame."""
    elev = torch.as_tensor(_terrain(90, 120, seed=13, nan_frac=0.04), device=cuda)
    _check_update(elev, check_roughness, frame=frame)


# name -> (expression, compute_roughness, float32 steps allowed in the fused layer)
EXPRESSIONS = {
    "reference": ("(1.0 / 3.0) * (traversability_slope + traversability_step + "
                  "traversability_roughness)", True, 0),
    "two_layers": ("0.5*(traversability_slope + traversability_step)", False, 0),
    "min_max_sqrt_pow": ("max(min(traversability_slope, traversability_step), "
                         "-sqrt(traversability_roughness) + traversability_step ^ 2)", True, 0),
    "exp_sin": ("exp(-traversability_roughness) * sin(traversability_slope) + "
                "traversability_step ^ 1.5", True, 2),
}


@pytest.mark.parametrize("name", sorted(EXPRESSIONS))
@pytest.mark.parametrize("shape", [(77, 101, 9, 0.05), (337, 335, 8, 0.01)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_fused_update_kernel_fusion_expression(cuda, shape, name):
    """The fusion expression runs inside kernel 1 (its launch count rises, no
    torch op fuses on the card): arithmetic, min, max, sqrt and ^ 2 are
    bit-identical to the plain version, exp, sin and a general power within
    2 float32 steps."""
    rows, cols, seed, nan_frac = shape
    expression, rough, ulps = EXPRESSIONS[name]
    _check_update(torch.as_tensor(_terrain(rows, cols, seed, nan_frac), device=cuda), False,
                  ulps=ulps, fusion_expression=expression, compute_roughness=rough)


def test_fusion_expression_over_the_kernel_caps_raises(cuda):
    elev = torch.as_tensor(_terrain(40, 40, 1, 0.0), device=cuda)
    cfg = EstimatorConfig(resolution=RES)
    deep = "traversability_slope+(1+(2+(3+(4+(5+(6+(7+(8+9))))))))"
    for expression, what in (("+".join(["traversability_slope"] * 40), "program entries"),
                             (deep, "stack")):
        chain = ChainConfig(resolution=RES, fusion_expression=expression)
        with pytest.raises(ValueError, match=what):
            update_kernel.fused_update(elev, chain, cfg.veto)


@pytest.mark.parametrize("radius_min", [0.3, 0.0])
def test_circle_field_kernel_matches_plain(cuda, radius_min):
    _check_field(torch.as_tensor(_terrain(90, 70, seed=4, nan_frac=0.03), device=cuda),
                 radius_min, cuda)


@pytest.mark.parametrize("radius_min", [0.3, 0.0])
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_circle_field_kernel_edge_shapes(cuda, shape, radius_min):
    rows, cols, seed, nan_frac = shape
    _check_field(torch.as_tensor(_terrain(rows, cols, seed, nan_frac), device=cuda),
                 radius_min, cuda)


RECT = np.float32([[0.45, 0.3], [0.45, -0.3], [-0.45, -0.3], [-0.45, 0.3]])
L_SHAPE = np.float32(
    [[0.45, 0.3], [0.45, -0.3], [-0.45, -0.3], [-0.45, 0.0], [0.0, 0.0], [0.0, 0.3]]
)


def _estimator_pair(cuda):
    """The estimator on the card and on the CPU, after the same update."""
    elev = _terrain(160, 144, seed=3, nan_frac=0.02, noise=0.012, tilt=0.05)
    pair = []
    for device in (cuda, "cpu"):
        est = TraversabilityEstimator(EstimatorConfig(resolution=RES), device=device)
        assert est.update(elev, position=(0.4, -0.2))
        pair.append(est)
    return pair


@pytest.mark.parametrize("mode", ["identity", "conservative", "rotated", "non_convex"])
def test_polygonal_batch_card_matches_cpu(cuda, mode):
    on_card, on_cpu = _estimator_pair(cuda)
    rng = np.random.default_rng(12)
    P, N = 96, 20
    starts = np.float32([0.4, -0.2]) + rng.uniform(-1.6, 1.6, (P, 2))
    xy = np.concatenate(
        [starts[:, None], starts[:, None] + np.cumsum(rng.uniform(-0.06, 0.06, (P, N - 1, 2)), 1)],
        axis=1,
    )
    pos3 = np.concatenate([xy, np.zeros((P, N, 1))], -1).astype(np.float32)
    quats = np.zeros((P, N, 4), np.float32)
    quats[..., 3] = 1.0
    if mode in ("rotated", "non_convex"):
        yaw = rng.uniform(0, 2 * np.pi, (P, N))
        quats[..., 2] = np.sin(yaw / 2)
        quats[..., 3] = np.cos(yaw / 2)
    n_poses = rng.integers(1, N + 1, P).astype(np.int32)
    for p in range(P):
        pos3[p, n_poses[p]:] = pos3[p, n_poses[p] - 1]
        quats[p, n_poses[p]:] = quats[p, n_poses[p] - 1]
    footprint_xy = L_SHAPE if mode == "non_convex" else RECT
    args = (pos3, quats, n_poses, footprint_xy, mode == "conservative")
    safe_g, trav_g, area_g = on_card.check_polygonal_paths_batch(*args)
    safe_c, trav_c, area_c = on_cpu.check_polygonal_paths_batch(*args)
    assert safe_g.is_cuda and on_card.last_polygonal_dispatch == on_cpu.last_polygonal_dispatch
    want = "per_segment" if mode == "non_convex" else "grouped"
    assert on_card.last_polygonal_dispatch["evaluator"] == want
    assert torch.equal(safe_g.cpu(), safe_c) and safe_c.any() and not safe_c.all()
    torch.testing.assert_close(trav_g.cpu(), trav_c, rtol=0, atol=2e-5)
    torch.testing.assert_close(area_g.cpu(), area_c, rtol=1e-5, atol=1e-6)


OCTAGON = np.float32([[0.4 * np.cos(a), 0.3 * np.sin(a)] for a in np.arange(8) * np.pi / 4])
# 700 vertices: 1,400 ring points, more than kernel 3's shared memory holds
MANY_GON = np.float32(
    [[0.45 * np.cos(a), 0.3 * np.sin(a)] for a in np.arange(700) * -2 * np.pi / 700])


def _kernel3_batch(case, P=96, N=20):
    """chip_smoke.py phase 5b's batches at the test's size: (positions,
    quaternions, n_poses, footprint, conservative, identity, block tier)."""
    if case == "span_boundary":
        _, _, _, pos3, quats, n_poses, fp = span_boundary_batch()
        return pos3, quats, n_poses, fp, False, True, False
    if case == "eight_paths":
        P = 8
    rng = np.random.default_rng(31)
    starts = np.float32([0.4, -0.2]) + rng.uniform(-1.6, 1.6, (P, 2))
    xy = np.concatenate(
        [starts[:, None], starts[:, None] + np.cumsum(rng.uniform(-0.06, 0.06, (P, N - 1, 2)), 1)],
        axis=1)
    yaw = rng.uniform(0, 2 * np.pi, (P, N))
    if case == "block_tier":
        # straight 3 m paths heading along their yaw
        yaw = np.repeat(rng.uniform(0, 2 * np.pi, (P, 1)), 3 * N, 1)
        N *= 3
        xy = starts[:, None] + 0.05 * np.arange(N)[None, :, None] * np.stack(
            [np.cos(yaw), np.sin(yaw)], -1)
    if case == "off_map":
        xy[: P // 2, :, 0] += 8.0
        xy[P // 2 :, :, 0] += 2.2
    if case == "many_vertices":
        xy = xy[:16, :8]
        yaw = yaw[:16, :8]
        P, N = xy.shape[:2]
    pos3 = np.concatenate([xy, np.zeros((P, N, 1))], -1).astype(np.float32)
    identity = case in ("identity", "off_map", "many_vertices")
    quats = np.zeros((P, N, 4), np.float32)
    quats[..., 3] = 1.0
    if not identity:
        quats[..., 2] = np.sin(yaw / 2)
        quats[..., 3] = np.cos(yaw / 2)
    n_poses = np.full((P,), N, np.int32)
    if case == "ragged":
        n_poses = rng.integers(1, N + 1, P).astype(np.int32)
        n_poses[:8] = 1
        for p in range(P):
            pos3[p, n_poses[p]:] = pos3[p, n_poses[p] - 1]
            quats[p, n_poses[p]:] = quats[p, n_poses[p] - 1]
    fp = {"octagon_conservative": OCTAGON, "global_slots": OCTAGON,
          "many_vertices": MANY_GON}.get(case, RECT)
    conservative = case in ("conservative_yaw", "octagon_conservative", "global_slots")
    return pos3, quats, n_poses, fp, conservative, identity, case == "block_tier"


def _bits_equal(a, b):
    """Equal to the bit (floats compared as their int32 patterns)."""
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize("case", ["identity", "random_yaw", "conservative_yaw", "block_tier",
                                  "ragged", "off_map", "unknown_map", "octagon_conservative",
                                  "global_slots", "many_vertices", "span_boundary",
                                  "eight_paths"])
def test_poly_kernel_matches_plain(cuda, case):
    """Kernel 3 against its plain version on the card, chip_smoke.py phase
    5b's bars: one launch; is_safe, each ring's fail and cell count equal;
    each ring's cell sum within rtol 1e-5 (plus 1e-7 a cell) and its area
    weight within 1e-5 of the larger of the weight and the footprint's area
    (a weight after the first segment is the difference of two areas near
    the footprint's); traversability within 2e-5 and area within rtol 1e-5,
    scaled by the path's sum|w| / |sum w| over its segments' area weights (1
    where none is negative; the conservative sweep's are of mixed sign, and
    so is the weight of a hull that the collinearity band collapses, as on a
    path heading along a footprint edge). "global_slots": the octagon's
    slots forced into the global scratch; "many_vertices": a 700-gon, whose
    slots exceed the shared memory, through the wrapper; "span_boundary":
    a rectangle's vertices on cell centres and borders (ties decide each
    ring's first and last columns); "eight_paths": a batch too small to
    fill the card, each path spread over several blocks. A second launch on
    the same inputs gives the same bits."""
    from traversability_estimation_tpu_torch.ops import poly_kernel

    res = RES
    if case == "span_boundary":
        res, shape, position = span_boundary_batch()[:3]
        on_card = TraversabilityEstimator(EstimatorConfig(resolution=res), device=cuda)
        assert on_card.update(_terrain(*shape, seed=23, nan_frac=0.02, noise=0.012, tilt=0.05),
                              position=position)
    else:
        on_card, _ = _estimator_pair(cuda)
    if case == "unknown_map":
        on_card = TraversabilityEstimator(EstimatorConfig(resolution=RES), device=cuda)
        assert on_card.update(np.full((160, 144), np.nan, np.float32), position=(0.4, -0.2))
    pos3, quats, n_poses, fp, conservative, identity, blocks = _kernel3_batch(case)
    ext = pos3[..., :2].max(axis=1) - pos3[..., :2].min(axis=1)
    group = footprint.path_group_window(fp, ext, res, True) if identity else \
        footprint.path_group_window_exact(fp, pos3, quats, res)
    block = footprint.path_block_window(fp, pos3, res, identity) if blocks else None
    args = (on_card.query_state, torch.as_tensor(pos3, device=cuda),
            torch.as_tensor(quats, device=cuda), n_poses, fp, group, conservative,
            identity and not conservative, block)
    before = poly_kernel.check_polygonal_paths_grouped.launches
    if case == "global_slots":
        inputs = poly_kernel.kernel_inputs(*args, smem_limit=0)
        assert inputs.plan.smem_bytes == poly_kernel.FIXED_SMEM and inputs.slots is not None
        got = poly_kernel.launch(inputs, return_segments=True)
    else:
        got = poly_kernel.check_polygonal_paths_grouped(*args, return_segments=True)
    torch.cuda.synchronize()
    assert poly_kernel.check_polygonal_paths_grouped.launches == before + 1
    assert (poly_kernel.launch_plan(1, 2, len(fp), 1, conservative).scratch_words > 0) == (
        case == "many_vertices")
    inputs = poly_kernel.kernel_inputs(*args, smem_limit=0 if case == "global_slots" else
                                       poly_kernel.SMEM_LIMIT)
    if case == "eight_paths":
        assert inputs.plan.cluster > 1 and inputs.plan.grid[0] > len(pos3)
    again = poly_kernel.launch(inputs, return_segments=True)
    assert all(_bits_equal(a, b) for a, b in zip(got, again))
    want = footprint.check_polygonal_paths_grouped(*args, return_segments=True)
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype and g.shape == w.shape
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
    assert torch.equal(got[4], want[4])
    weights = want[6]
    assert bool(((got[5] - want[5]).abs() <= 1e-5 * want[5].abs() + 1e-7 * want[4]).all())
    assert bool(((got[6] - weights).abs()
                 <= 1e-5 * torch.maximum(weights.abs(), weights[:, :1].abs())).all())
    n_t = torch.as_tensor(n_poses, device=cuda)
    valid = torch.arange(1, pos3.shape[1], device=cuda)[None, :] < n_t[:, None]
    w_seg = torch.where(valid, weights[:, 1:], 0.0)
    single = n_t == 1
    abs_sum = torch.where(single, weights[:, 0].abs(), w_seg.abs().sum(1))
    cond = abs_sum / torch.where(single, weights[:, 0].abs(), w_seg.sum(1).abs()).clamp_min(1e-12)
    assert bool(((got[1] - want[1]).abs() <= 2e-5 * cond).all())
    assert bool(((got[2] - want[2]).abs() <= 1e-5 * abs_sum + 1e-6).all())


def _function_work(state, pos3, quats, n_poses, fp, window, conservative):
    """(hull point tests, searches, straddle tests) that the grouped
    evaluator needs on a path-tier batch, counted from the plain version's
    own values: per pair of a segment's hull points that is no duplicate
    edge, its tests up to the first point outside (ops/hull.py's band); per
    ring and window column, one search per straddling edge; per ring, its
    edges on each column whose centre line lies within its y range."""
    positions, quaternions, n_poses, fp = footprint._path_inputs(
        state, pos3, quats, n_poses, fp)
    polys = footprint.transform_footprint(fp, positions, quaternions)  # (P, N, V, 2)
    rings = footprint._segment_rings(polys, positions, fp, conservative, False)[0]
    prev, cur = polys[:, :-1], polys[:, 1:]
    if conservative:
        d = (positions[:, 1:, :2] - positions[:, :-1, :2])[:, :, None]
        pts = torch.cat([prev, cur - d, cur, prev + d], 2)
    else:
        pts = torch.cat([prev, cur], 2)
    px, py = pts[..., 0], pts[..., 1]
    jx = px[..., None, :, None] - px[..., :, None, None]  # (.., i, j, 1)
    jy = py[..., None, :, None] - py[..., :, None, None]
    kx = px[..., None, None, :] - px[..., :, None, None]  # (.., i, 1, k)
    ky = py[..., None, None, :] - py[..., :, None, None]
    cross = fma_f32(jx, ky, -(jy * kx))
    dot = fma_f32(jx, kx, jy * ky)
    len2 = fma_f32(jx, jx, jy * jy)
    eps = 3e-6 * sqrt_f32(len2 * fma_f32(kx, kx, ky * ky)) + 1e-30
    fails = ~((cross > eps) | ((cross.abs() <= eps) & (dot >= -eps) & (dot <= len2 + eps)))
    M = pts.shape[-2]
    tests = torch.where(fails.any(-1), fails.to(torch.int64).argmax(-1) + 1, M)  # (.., i, j)
    same = (px[..., :, None] == px[..., None, :]) & (py[..., :, None] == py[..., None, :])
    idx = torch.arange(M)
    dup = (same & (idx[:, None] > idx[None, :])).any(-1)
    skip = dup[..., :, None] | dup[..., None, :] | same
    hull_tests = int(torch.where(skip, 0, tests).sum())
    wi, wj = window
    gpad = max(wi, wj)
    xy = positions[..., :2]
    sj = footprint._window_starts(state, footprint._index_of(
        state, 0.5 * (xy.amax(1) + xy.amin(1))), wi, wj, gpad)[1]
    gj = (sj[:, None] - gpad) + torch.arange(wj)
    pyc = footprint._cell_coord(footprint._origin_offset(state)[1], gj.to(torch.float32),
                                state.resolution)  # (P, wj)
    searches = straddles = 0
    for ring in [polys[:, 0]] + list(rings.unbind(1)):  # (P, m, 2) each
        y = ring[..., 1]
        yp = torch.roll(y, 1, dims=1)
        cond = (y[:, :, None] > pyc[:, None]) != (yp[:, :, None] > pyc[:, None])
        searches += int(cond.sum())
        span = (pyc >= y.amin(1, keepdim=True)) & (pyc < y.amax(1, keepdim=True))
        straddles += int(span.sum()) * ring.shape[1]
    return hull_tests, searches, straddles


@pytest.mark.parametrize("case", ["random_yaw", "conservative_yaw"])
def test_poly_kernel_counts_the_function_work(cuda, case):
    """Kernel 3's counting instantiation (``work_counts``, the bound's
    inputs) reports the function's work, counted from the plain version's
    values on the CPU. The first design counted the same hull point tests
    and searches: 8,740,377 and 3,514,478 at chip_smoke.py's 1024 x 50
    random-yaw batch, which the redesigned kernel counts too."""
    from traversability_estimation_tpu_torch.ops import poly_kernel

    on_card, on_cpu = _estimator_pair(cuda)
    pos3, quats, n_poses, fp, conservative, _, _ = _kernel3_batch(case, P=24, N=12)
    group = footprint.path_group_window_exact(fp, pos3, quats, RES)
    inputs = poly_kernel.kernel_inputs(
        on_card.query_state, torch.as_tensor(pos3, device=cuda),
        torch.as_tensor(quats, device=cuda), n_poses, fp, group, conservative, False)
    got = poly_kernel.work_counts(inputs)
    want = _function_work(on_cpu.query_state, pos3, quats, n_poses, fp, group, conservative)
    assert got == want and min(want) > 0


@pytest.mark.parametrize("orientation", ["random_yaw", "identity"])
def test_window_plan_card_matches_numpy(cuda, orientation):
    """The polygonal dispatch's window plan on the card, on the inputs of
    the benchmark cell poly_paths_336 (1024 x 50 poses, seed 0, epoch 0):
    the identity flag and every integer of the NumPy planners, and the same
    plan as on the CPU."""
    import json
    from pathlib import Path

    from bench_torch.inputs import epoch_inputs

    bench = json.loads((Path(__file__).resolve().parents[1] / "BENCHMARK.json").read_text())
    traffic = next(w for w in bench["workloads"] if w["name"] == "poly_paths_336")["traffic"]
    (ep,) = epoch_inputs(traffic, 336, RES, 0, range(1))
    pos3, quats = ep.positions, ep.quaternions
    if orientation == "identity":
        quats = np.zeros_like(quats)
        quats[..., 3] = 1.0
    tensors = [torch.from_numpy(a) for a in (pos3, quats, RECT)]
    plan = footprint.path_window_plan(*(t.to(cuda) for t in tensors))
    assert plan.is_cuda
    plan = plan.cpu()
    assert torch.equal(plan, footprint.path_window_plan(*tensors))
    identity = bool(np.all(np.abs(quats - np.asarray([0, 0, 0, 1])) < 1e-12))
    assert identity == (orientation == "identity")
    ext = pos3[..., :2].max(axis=1) - pos3[..., :2].min(axis=1)
    assert tuple(plan[10:12].tolist()) == tuple(ext.max(axis=0).astype(np.float64))
    group = footprint.path_group_window(RECT, ext, RES, True) if identity else \
        footprint.path_group_window_exact(RECT, pos3, quats, RES)
    assert footprint.planned_windows(plan.tolist(), RECT, RES) == (
        identity, group, footprint.path_block_window(RECT, pos3, RES, identity))


def test_footprint_services_card_matches_cpu(cuda):
    """Both dense services against the CPU run; the circular one launches
    kernel 2 (no plain field on a CUDA map)."""
    on_card, on_cpu = _estimator_pair(cuda)
    before = field_kernel.dense_circle_field.launches
    on_card.traversability_footprint_circle()
    assert field_kernel.dense_circle_field.launches == before + 1
    on_card.traversability_footprint_circle(radius=0.2, offset=0.1)
    assert field_kernel.dense_circle_field.launches == before + 2
    on_cpu.traversability_footprint_circle(radius=0.2, offset=0.1)
    got_map, want_map = on_card.traversability_footprint(), on_cpu.traversability_footprint()
    for name in ("traversability_footprint", "traversability_x", "traversability_rot"):
        got, want = got_map[name].cpu(), want_map[name]
        assert torch.equal(got != 0, want != 0), name
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        assert (want != 0).any() and not (want != 0).all()


@pytest.mark.parametrize("side", [189, 317])
def test_fused_update_kernel_on_a_view_of_a_larger_plane(cuda, side):
    """The online tick's shapes: the (patch + 4 halo)^2 crop (189 for a 133
    cell submap, 317 for 261) cut as a strided view out of a larger plane."""
    plane = torch.as_tensor(_terrain(700, 640, seed=21, nan_frac=0.02, noise=0.012), device=cuda)
    for i0, j0 in ((0, 0), (133, 71), (700 - side, 640 - side)):
        view = plane[i0 : i0 + side, j0 : j0 + side]
        assert not view.is_contiguous()
        _check_update(view, check_roughness=False)
    _check_update(plane[11 : 11 + side, 300 : 300 + side], check_roughness=True)


@pytest.mark.parametrize("side", [256, 512])
def test_circle_field_kernel_on_query_crops(cuda, side):
    """The online tick's query crops (256- and 512-bucketed), cut as views
    out of a larger map's planes."""
    cfg = EstimatorConfig(resolution=RES)
    elev = torch.as_tensor(_terrain(800, 720, seed=22, nan_frac=0.02, noise=0.012), device=cuda)
    layers = update_kernel.fused_update_plain(elev, cfg.chain, cfg.veto)
    n_ok = n_cells = 0
    # the last crop straddles the terrain's step edge (row 400, column 360)
    for i0, j0 in ((0, 0), (800 - side, 720 - side), (400 - side // 2, 360 - side // 2)):
        state = footprint.QueryState(
            traversability=layers["traversability"][i0 : i0 + side, j0 : j0 + side],
            traversable_mask=layers["traversable_mask"][i0 : i0 + side, j0 : j0 + side],
            position=torch.zeros(2, device=cuda), resolution=RES,
        )
        before = field_kernel.dense_circle_field.launches
        ok_k, tv_k = field_kernel.dense_circle_field(state, 0.45, 0.3)
        ok_p, tv_p = footprint.dense_circle_field(state, 0.45, 0.3)
        assert field_kernel.dense_circle_field.launches == before + 1
        assert torch.equal(ok_k, ok_p) and _same(tv_k, tv_p)
        n_ok += int(ok_k.sum())
        n_cells += ok_k.numel()
    assert 0 < n_ok < n_cells


@pytest.mark.parametrize("mode", ["circular", "roaming", "polygonal"])
def test_online_tick_card_matches_cpu(cuda, mode):
    """Four ticks on the card and on the CPU: each fused tick launches
    kernel 1 once and (circular) kernel 2 once, each circular tick kernel 4
    once; verdicts equal, path
    traversability within 1e-6, every map layer bit-identical except the
    float chain layers, which agree within 1e-6."""
    from traversability_estimation_tpu_torch import SyntheticTerrainSource

    src = SyntheticTerrainSource(RES)
    pair = []
    for device in (cuda, "cpu"):
        est = TraversabilityEstimator(EstimatorConfig(resolution=RES), device=device)
        est.set_elevation_map(np.full((400, 400), np.nan, np.float32))
        pair.append(est)
    rng = np.random.default_rng(0)
    for k in range(4):
        c = (1.5 * np.cos(0.3 * k), 1.5 * np.sin(0.3 * k))
        patch, _ = src.sample(c, (3.0, 3.0))
        starts = np.float32(c) + rng.uniform(-1.0, 1.0, (32, 2))
        poses = np.concatenate(
            [starts[:, None], starts[:, None] + np.cumsum(rng.uniform(-0.1, 0.1, (32, 7, 2)), 1)],
            axis=1).astype(np.float32)
        n = np.full((32,), 8, np.int32)
        kw = dict(footprint=RECT) if mode == "polygonal" else dict(radius=0.3)
        if mode == "roaming":
            kw["recenter_to"] = c
        k1, k2 = update_kernel.fused_update.launches, field_kernel.dense_circle_field.launches
        k4 = circ_kernel.check_circular_paths.launches
        safe_g, trav_g = pair[0].online_tick(patch, c, poses, n, **kw)
        assert update_kernel.fused_update.launches == k1 + 1
        assert circ_kernel.check_circular_paths.launches == k4 + (mode != "polygonal")
        fused = k > 0
        if fused and mode != "polygonal":
            assert field_kernel.dense_circle_field.launches == k2 + 1
        safe_c, trav_c = pair[1].online_tick(patch, c, poses, n, **kw)
        assert safe_g.is_cuda and torch.equal(safe_g.cpu(), safe_c)
        torch.testing.assert_close(trav_g.cpu(), trav_c, rtol=0, atol=1e-6)
    assert safe_c.any()
    for name, want in pair[1].traversability_map.layers.items():
        got = pair[0].traversability_map[name].cpu()
        if name in ("traversability", "traversability_slope", "traversability_roughness"):
            assert torch.equal(torch.isnan(got), torch.isnan(want)), name
            torch.testing.assert_close(got.nan_to_num(0), want.nan_to_num(0), rtol=0, atol=1e-6)
        else:
            assert _same(got, want), name
    np.testing.assert_array_equal(pair[0]._position, pair[1]._position)


def test_node_round_trip_card_matches_cpu(cuda, tmp_path):
    """A node on the card behind the TCP service, under the reference-format
    configuration (its fusion expression runs inside kernel 1): an update
    request launches kernel 1 once, a circular path request kernel 2 once per
    map epoch; verdicts and polygons equal a CPU node's, traversability
    within 1e-6, and the saved bag loads back bit-identical."""
    from traversability_estimation_tpu_torch import (
        SyntheticTerrainSource,
        TraversabilityClient,
        TraversabilityNode,
        TraversabilityServer,
        config_from_documents,
        reference_documents,
    )
    from traversability_estimation_tpu_torch.utils.rosbag import load_grid_map_bag

    import dataclasses

    cfg = dataclasses.replace(
        config_from_documents(**reference_documents(), resolution=RES), min_update_rate=0.0)
    assert cfg.chain.fusion_expression and not cfg.use_generic_chain
    rng = np.random.default_rng(2)
    # the source's plateau ends at x = 5.36: the paths straddle its edge
    starts = np.float32([5.0, 0.0]) + rng.uniform(-1.5, 1.5, (24, 2))
    poses = starts[:, None] + np.cumsum(rng.uniform(-0.1, 0.1, (24, 6, 2)), 1)
    paths = [{"poses": p.tolist(), "radius": 0.3, "compute_untraversable_polygon": True}
             for p in poses[:16]]
    paths += [{"poses": p.tolist(), "footprint": RECT.tolist(),
               "compute_untraversable_polygon": True} for p in poses[16:]]
    answers = {}
    for device in ("cuda", "cpu"):
        node = TraversabilityNode(
            cfg, source=SyntheticTerrainSource(RES), robot_pose=lambda: (5.0, 0.0),
            persistent_map_length=(12.0, 12.0), device=device)
        with TraversabilityServer(node) as srv, \
                TraversabilityClient(*srv.address, timeout=120.0) as cli:
            k1, k2 = update_kernel.fused_update.launches, field_kernel.dense_circle_field.launches
            assert cli.update_traversability()["ok"]
            first = cli.check_footprint_path(paths)
            again = cli.check_footprint_path(paths)
            if device == "cuda":
                assert update_kernel.fused_update.launches == k1 + 1
                assert field_kernel.dense_circle_field.launches == k2 + 1  # cached for the epoch
            assert first == again and first["ok"]
            sub = cli.get_traversability(
                layers=["traversability", "traversability_step", "traversable_mask"],
                position=(5.0, 0.0), length=(4.0, 4.0))
            bag = str(tmp_path / f"{device}.bag")
            assert cli.save_traversability_map_to_bag(bag)["ok"]
            want = node.get_traversability_map()
            msg = load_grid_map_bag(bag)
            for k, v in msg.data.items():
                assert np.array_equal(v, want[k].cpu().numpy(), equal_nan=True), k
            answers[device] = (first["results"], sub)
    (got, got_sub), (want, want_sub) = answers["cuda"], answers["cpu"]
    assert any(not r["is_safe"] for r in want) and any(r["is_safe"] for r in want)
    for g, w in zip(got, want):
        assert g["is_safe"] == w["is_safe"]
        assert abs(g["traversability"] - w["traversability"]) <= 1e-6
        assert g.get("untraversable_polygon") == w.get("untraversable_polygon")
    assert got_sub["map_info"] == want_sub["map_info"]
    for k in ("traversability_step", "traversable_mask"):
        assert np.array_equal(got_sub["data"][k], want_sub["data"][k], equal_nan=True), k
    g, w = got_sub["data"]["traversability"], want_sub["data"]["traversability"]
    assert np.array_equal(np.isnan(g), np.isnan(w))
    assert float(np.nanmax(np.abs(g - w))) <= 1e-6


def test_measured_peaks_within_the_spec_sheet(cuda):
    """The roofline's probes (csrc/peaks.cu): each measured peak between 30%
    and 105% of the spec sheet (above it the measurement is broken), and a
    shifted-plane read costs something."""
    from traversability_estimation_tpu_torch.utils import roofline

    peaks = roofline.measure_peaks(k1=200, k2=1000, repeats=1, device=cuda)
    spec = roofline.spec_peaks(cuda)
    for key in spec:
        assert 0.3 * spec[key] < peaks[key] <= 1.05 * spec[key], key
    assert roofline.measure_static_shift_cost((336, 336), device=cuda) > 0.0
    assert roofline.measure_shift_floor((256, 256), 64, 16, device=cuda) > 0.0


# kernel 4's batches: name -> (map side in cells, paths, poses, default
# traversability); "_whole" walks every segment whole (the card's
# estimator), the others at the estimator's cap (8 for "edge_default_0.5")
CIRC_CASES = {
    "cell_1024x50": (336, 1024, 50, 0.5),
    "tick_256x10": (256, 256, 10, 0.5),
    "edge_default_0.5": (120, 64, 12, 0.5),
    "edge_default_0": (120, 64, 12, 0.0),
    "single_poses": (120, 64, 1, 0.5),
    "cell_1024x50_whole": (336, 1024, 50, 0.5),
    "tick_256x10_whole": (256, 256, 10, 0.5),
    "cell_mixed_single_whole": (336, 1024, 50, 0.5),
    "long_800_whole": (336, 64, 800, 0.0),
}


def _circ_batch(case, cuda):
    """(state, poses, n_poses, max_segment_cells, field, has_single_pose) of
    a kernel 4 case, all on the card. The cell's batch is
    ``circ_paths_336``'s random walk of 0.06 m steps over 80% of the map;
    the tick's 256 paths start within 1.5 m of a centre and step 0.1 m; the
    edge batches add every corner of the sampling and the aggregation."""
    side, P, N, default = CIRC_CASES[case]
    elev = _terrain(side, side, seed=side, nan_frac=0.01, noise=0.012, tilt=0.05)
    est = TraversabilityEstimator(EstimatorConfig(resolution=RES), device=cuda)
    assert est.update(elev, position=(0.2, -0.1))
    qs = est.query_state
    state = footprint.QueryState(qs.traversability, qs.traversable_mask, qs.position, RES,
                                 default)
    rng = np.random.default_rng(side + N)
    centre = np.float32([0.2, -0.1])
    if case.startswith(("cell", "long")):
        ext = side * RES / 2 * 0.8
        starts = centre + rng.uniform(-ext, ext, (P, 2))
        steps = rng.uniform(-0.06, 0.06, (P, N - 1, 2)) / (3 if N > 100 else 1)
    else:
        starts = centre + rng.uniform(-1.5, 1.5, (P, 2))
        steps = rng.uniform(-0.1, 0.1, (P, N - 1, 2))
    poses = np.concatenate([starts[:, None], starts[:, None] + np.cumsum(steps, 1)], 1)
    n_poses = np.full((P,), N, np.int32)
    if case.startswith("edge") or case == "single_poses":
        n_poses = rng.integers(0, N + 2, P).astype(np.int32)
        n_poses[:5] = [0, 1, 2, N, N + 1]
        half = side * RES / 2
        poses[5] += 3 * half  # wholly off the map
        poses[6, :, 0] = centre[0] + half  # on the border: row 0
        poses[7, :, 1] = centre[1] - half  # on the far border: off the map
        poses[8] = poses[8, :1] + np.arange(N)[:, None] * np.float32([0.9, -0.4])  # long segments
        poses[9] = poses[9, :1]  # all-zero length
        poses[10, : N // 2] = poses[10, :1]  # zero-length segments, then not
    if case == "cell_mixed_single_whole":
        n_poses = rng.integers(2, N + 1, P).astype(np.int32)
        n_poses[rng.random(P) < 0.25] = 1
    poses = poses.astype(np.float32)
    max_cells = est._max_segment_cells(poses, n_poses)
    if case == "edge_default_0.5":
        max_cells = 8  # the long segments are cut at S = 2 samples
    if case.endswith("_whole"):
        max_cells = None
    field = field_kernel.dense_circle_field(state, 0.45, 0.3)
    has_single = bool(np.any(n_poses <= 1))
    return (state, torch.as_tensor(poses, device=cuda), torch.as_tensor(n_poses, device=cuda),
            max_cells, field, has_single)


@pytest.mark.parametrize("case", sorted(CIRC_CASES))
def test_circ_kernel_matches_plain(cuda, case):
    """Kernel 4 against its plain version on the same CUDA tensors: one
    launch a call and no check_circles on the card, is_safe equal,
    traversability within 1e-6 and a single-pose path's bit for bit, two
    launches bit-identical."""
    state, poses, n_poses, max_cells, field, has_single = _circ_batch(case, cuda)
    args = (state, poses, n_poses, 0.3, 0.15, max_cells, field, has_single)
    before = circ_kernel.check_circular_paths.launches
    circles = footprint.check_circles.card_calls
    got = footprint.check_circular_paths(*args)
    assert circ_kernel.check_circular_paths.launches == before + 1
    again = footprint.check_circular_paths(*args)
    assert footprint.check_circles.card_calls == circles
    want = footprint.check_circular_paths_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype and g.shape == w.shape
    assert torch.equal(got[0], want[0])
    assert float((got[1] - want[1]).abs().max()) <= 1e-6
    one = (n_poses == 1) & has_single if poses.shape[1] > 1 else torch.ones_like(got[0])
    assert _bits_equal(got[1][one], want[1][one])
    assert torch.equal(got[0], again[0]) and _bits_equal(got[1], again[1])
    assert bool(torch.isfinite(got[1]).all())
    assert got[0].any() and not got[0].all()


def test_circ_kernel_host_inputs_match_device_inputs(cuda):
    """Poses from host arrays go up in one copy (none from device tensors):
    the same bits as from device tensors, over batches of several sizes."""
    for case in ("tick_256x10_whole", "cell_mixed_single_whole", "tick_256x10_whole",
                 "single_poses"):
        state, poses, n_poses, max_cells, field, has_single = _circ_batch(case, cuda)
        copies = circ_kernel.device_inputs.copies
        dev = footprint.check_circular_paths(state, poses, n_poses, 0.3, 0.15, max_cells,
                                             field, has_single)
        assert circ_kernel.device_inputs.copies == copies
        host = footprint.check_circular_paths(state, poses.cpu().numpy(), n_poses.cpu().numpy(),
                                              0.3, 0.15, max_cells, field, has_single)
        assert circ_kernel.device_inputs.copies == copies + 1
        torch.cuda.synchronize()
        assert torch.equal(dev[0], host[0]) and _bits_equal(dev[1], host[1])
