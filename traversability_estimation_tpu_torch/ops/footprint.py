"""Batched footprint and path evaluation as torch ops.

Semantics follow the reference's query engine: circular checks visit cells
in grid_map's exact spiral order (the first-failure radius inflation
depends on the order within a ring); line sampling keeps the stride-4
Bresenham walk from segment end to start; polygonal checks rasterise convex
hulls of consecutive transformed footprints by the crossing-number rule of
grid_map's PolygonIterator and aggregate the path by area; the veto cascade
is read from the dense ``traversable_mask`` plane.

The dense circle field's plain version lives here; its CUDA kernel is in
``ops/field_kernel.py`` (``csrc/circle_field.cu``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from traversability_estimation_tpu_torch.grid.geometry import (
    line_cells_batch,
    polygon_area,
    spiral_order,
)
from traversability_estimation_tpu_torch.ops.filters import (
    _shifted,
    f32,
    fma_f32,
    mul_rcp,
    rcp,
    sqrt_f32,
)
from traversability_estimation_tpu_torch.ops.hull import convex_hull_batch


@dataclasses.dataclass(frozen=True)
class QueryState:
    """Compact per-map-update state that footprint queries gather from."""

    traversability: torch.Tensor  # (H, W) f32, NaN = unknown
    traversable_mask: torch.Tensor  # (H, W) bool, dense veto verdicts
    position: torch.Tensor  # (2,) f32 map center in the map frame
    resolution: float
    default_traversability: float = 0.5

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.traversability.shape)

    @property
    def device(self) -> torch.device:
        return self.traversability.device


def map_origin(shape, position: torch.Tensor, resolution: float) -> torch.Tensor:
    """P0 of a `shape` map centred at `position` (2,) f32: index i covers x
    in (P0 - (i+1) res, P0 - i res]."""
    size = torch.tensor(tuple(shape), dtype=torch.float32, device=position.device)
    return position + size * resolution * 0.5


def _origin_offset(state: QueryState) -> torch.Tensor:
    return map_origin(state.shape, state.position, state.resolution)


def index_from_origin(p0: torch.Tensor, xy: torch.Tensor, resolution: float) -> torch.Tensor:
    """Integer cell indices (..., 2) of positions (..., 2) below origin P0."""
    return torch.floor(mul_rcp(p0 - xy, resolution)).to(torch.int32)


def _index_of(state: QueryState, xy: torch.Tensor) -> torch.Tensor:
    return index_from_origin(_origin_offset(state), xy, state.resolution)


def _position_of(state: QueryState, idx: torch.Tensor) -> torch.Tensor:
    """Cell-centre positions (..., 2) of integer indices (..., 2)."""
    return _cell_coord(_origin_offset(state), idx.to(torch.float32), state.resolution)


def _is_inside(state: QueryState, xy: torch.Tensor) -> torch.Tensor:
    rows, cols = state.shape
    p0 = _origin_offset(state)
    t = p0 - xy
    size = torch.tensor([rows, cols], dtype=torch.float32, device=state.device)
    length = size * state.resolution
    return ((t >= 0.0) & (t < length)).all(dim=-1)


def _gather_plane(plane: torch.Tensor, cells: torch.Tensor, fill):
    """plane (H, W) at integer cells (..., 2); `fill` outside the map."""
    rows, cols = plane.shape
    ci = cells[..., 0]
    cj = cells[..., 1]
    inmap = (ci >= 0) & (ci < rows) & (cj >= 0) & (cj < cols)
    lin = ci.clamp(0, rows - 1).to(torch.int64) * cols + cj.clamp(0, cols - 1)
    vals = plane.reshape(-1)[lin]
    return torch.where(inmap, vals, fill), inmap


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis in the pairwise odd/even order
    of ``jax.lax.associative_scan`` (a sequential f32 cumsum over hundreds
    of cells drifts ~1e-3 from a double accumulation; this order keeps it
    ~1e-5 and matches the JAX reference bit for bit)."""
    n = x.shape[-1]
    if n < 2:
        return x
    odd = _prefix_sum(x[..., 0:-1:2] + x[..., 1::2])
    if n % 2 == 0:
        even = odd[..., :-1] + x[..., 2::2]
    else:
        even = odd + x[..., 2::2]
    even = torch.cat([x[..., :1], even], dim=-1)
    out = torch.empty_like(x)
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return out


def _inflation_factor(r_fail: torch.Tensor, radius_max: float, radius_min: float):
    """((r_fail - rmin) / (rmax - rmin) + 1) / 2, the division by the
    constant span compiled as a fused multiply-add by its reciprocal."""
    return fma_f32(r_fail - f32(radius_min), rcp(radius_max - radius_min), 1.0) * 0.5


def check_circles(
    state: QueryState,
    centers: torch.Tensor,
    radius_max: float,
    radius_min: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched isTraversable(center, radiusMax, ..., radiusMin) at arbitrary
    (sub-cell) centers (..., 2). Returns (ok (...,) bool, trav (...,) f32)."""
    dev = state.device
    offs_np, rings_np = spiral_order(radius_max, state.resolution)
    n_rings = int(math.ceil(radius_max / state.resolution - 1e-12))
    offs = torch.as_tensor(offs_np, dtype=torch.int32, device=dev)
    rings = torch.as_tensor(rings_np, dtype=torch.int32, device=dev)
    radii = torch.as_tensor(
        (np.linalg.norm(offs_np.astype(np.float64), axis=1) * state.resolution).astype(
            np.float32
        ),
        dtype=torch.float32,
        device=dev,
    )

    centers_in = torch.as_tensor(centers, dtype=torch.float32, device=dev)
    batch_shape = centers_in.shape[:-1]
    centers = centers_in.reshape(-1, 2)
    idx = _index_of(state, centers)
    cells = idx[:, None, :] + offs  # (B, K, 2)

    # one packed plane: passing cell -> tv in [0, 1]; vetoed cell -> -1 - tv;
    # off-map -> +inf
    tvf = torch.where(
        torch.isfinite(state.traversability),
        state.traversability,
        state.default_traversability,
    )
    packed_plane = torch.where(state.traversable_mask, tvf, -1.0 - tvf)
    v, inmap = _gather_plane(packed_plane, cells, math.inf)
    ok_vals = v >= 0.0
    tv = torch.where(ok_vals, v, -1.0 - v)

    # outermost two rings: grid_map re-checks the Euclidean distance to the
    # (sub-cell accurate) query center
    # (a rim that passes through a cell centre decides that cell by an ulp:
    # the centre coordinate and the squared distance are the fused
    # multiply-adds XLA:CPU compiles, ``fma(dy, dy, dx * dx)``)
    diff = _position_of(state, cells) - centers[:, None, :]
    d2 = fma_f32(diff[..., 1], diff[..., 1], diff[..., 0] * diff[..., 0])
    outer = rings >= max(n_rings - 1, 0)
    within = torch.where(outer, d2 <= radius_max * radius_max, True)

    active = inmap & within
    fail = active & ~ok_vals
    passing = active & ok_vals
    contrib = torch.where(passing, tv, 0.0)
    passing_f = passing.to(torch.float32)

    any_fail = fail.any(dim=-1)
    first_fail = torch.argmax(fail.to(torch.uint8), dim=-1)  # first occurrence

    cum_cnt = _prefix_sum(passing_f)
    cum_sum = _prefix_sum(contrib)
    total_cnt = cum_cnt[..., -1]
    total_sum = cum_sum[..., -1]

    # counts/sums strictly before the first failing spiral position
    ff = first_fail[:, None]
    before_cnt = (cum_cnt.gather(-1, ff) - passing_f.gather(-1, ff))[:, 0]
    before_sum = (cum_sum.gather(-1, ff) - contrib.gather(-1, ff))[:, 0]
    r_fail = radii[first_fail]

    default = state.default_traversability
    mean_all = total_sum / torch.clamp_min(total_cnt, 1.0)
    if radius_min == 0.0:
        ok = ~any_fail
        trav = torch.where(ok, mean_all, 0.0)
    else:
        hard_fail = any_fail & (r_fail <= radius_min)
        inflate = any_fail & (r_fail > radius_min)
        factor = _inflation_factor(r_fail, radius_max, radius_min)
        mean_before = before_sum / torch.clamp_min(before_cnt, 1.0)
        ok = ~hard_fail
        trav = torch.where(
            inflate, mean_before * factor, torch.where(hard_fail, 0.0, mean_all)
        )

    # centers outside the map: the default verdict
    inside = _is_inside(state, centers)
    ok = torch.where(inside, ok, default != 0.0)
    trav = torch.where(inside, trav, default)
    return ok.reshape(batch_shape), trav.reshape(batch_shape)


@functools.lru_cache(maxsize=None)
def field_tables(radius_max: float, resolution: float) -> Tuple[np.ndarray, np.ndarray]:
    """Spiral offsets (K, 2) int32 and their radii (K,) float32 for a query at
    a cell center: the outer-ring Euclidean re-check is static per offset,
    so excluded offsets leave the order. Radii are computed in float64 and
    rounded once. Cached; the arrays are read-only."""
    offs_np, rings_np = spiral_order(radius_max, resolution)
    n_rings = int(math.ceil(radius_max / resolution - 1e-12))
    keep = np.ones(len(offs_np), dtype=bool)
    outer = rings_np >= max(n_rings - 1, 0)
    d2 = np.sum(offs_np.astype(np.float64) ** 2, axis=1) * resolution * resolution
    keep[outer] = d2[outer] <= radius_max * radius_max
    offs_np = offs_np[keep]
    radii = np.sqrt(np.sum(offs_np.astype(np.float64) ** 2, axis=1)) * resolution
    offs_np, radii = offs_np.astype(np.int32), radii.astype(np.float32)
    offs_np.flags.writeable = False
    radii.flags.writeable = False
    return offs_np, radii


def dense_circle_field(
    state: QueryState,
    radius_max: float,
    radius_min: float,
    in_map: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cell circular footprint verdict for a query centered at each cell
    center (the reference's ``traversability_footprint`` memo layer, dense).
    Plain version of ``csrc/circle_field.cu``.

    The map's spiral scans advance in lockstep over the static offset order,
    each step reading one shifted plane of a packed encoding: failing cell
    -> -inf, beyond the map or `in_map` False -> NaN (contributes nothing),
    else the effective traversability. Six carries per cell: found, radius
    of the first fail, count and sum before it, total count and sum.

    Returns (ok (H, W) bool, trav (H, W) f32).
    """
    res = state.resolution
    offs_np, radii_np = field_tables(radius_max, res)
    H, W = state.shape
    R = int(np.max(np.abs(offs_np))) if len(offs_np) else 0
    tv = torch.where(
        torch.isfinite(state.traversability),
        state.traversability,
        state.default_traversability,
    )
    fail_plane = ~state.traversable_mask
    if in_map is not None:
        fail_plane = fail_plane & in_map
        packed = torch.where(in_map, torch.where(fail_plane, -math.inf, tv), math.nan)
    else:
        packed = torch.where(fail_plane, -math.inf, tv)
    pad = torch.full((H + 2 * R, W + 2 * R), math.nan, dtype=torch.float32, device=state.device)
    pad[R : R + H, R : R + W] = packed

    zero = torch.zeros((H, W), dtype=torch.float32, device=state.device)
    found = torch.zeros((H, W), dtype=torch.bool, device=state.device)
    r_fail, cnt_b, sum_b, cnt, ssum = zero, zero, zero, zero, zero
    for (oi, oj), r_k in zip(offs_np.tolist(), radii_np.tolist()):
        v_k = pad[R + oi : R + oi + H, R + oj : R + oj + W]
        fail_k = v_k == -math.inf
        is_pass = torch.isfinite(v_k)  # NaN (out) and -inf (fail) excluded
        new_fail = fail_k & ~found
        r_fail = torch.where(new_fail, r_k, r_fail)
        cnt_b = torch.where(new_fail, cnt, cnt_b)
        sum_b = torch.where(new_fail, ssum, sum_b)
        found = found | fail_k
        cnt = cnt + is_pass.to(torch.float32)
        ssum = ssum + torch.where(is_pass, v_k, 0.0)

    mean_all = ssum / torch.clamp_min(cnt, 1.0)
    default = state.default_traversability
    if radius_min == 0.0:
        ok = ~found
        trav = torch.where(ok, mean_all, 0.0)
    else:
        hard = found & (r_fail <= radius_min)
        inflate = found & (r_fail > radius_min)
        factor = _inflation_factor(r_fail, radius_max, radius_min)
        mean_b = sum_b / torch.clamp_min(cnt_b, 1.0)
        ok = ~hard
        trav = torch.where(inflate, mean_b * factor, torch.where(hard, 0.0, mean_all))
    empty = (cnt == 0.0) & ~found
    ok = torch.where(empty, default != 0.0, ok)
    trav = torch.where(empty, default, trav)
    return ok, trav


def check_circular_paths(
    state: QueryState,
    poses,
    n_poses,
    radius: float,
    offset: float = 0.15,
    max_segment_cells: int = 64,
    field: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    has_single_pose: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched checkCircularFootprintPath.

    poses: (P, N, 2) map-frame positions, the first n_poses[p] valid per
    path. `field`: the dense circle field ``(radius + offset, radius)`` of
    this map epoch (built with the CUDA kernel on the card when omitted).
    `has_single_pose`: False skips the exact sub-cell spiral evaluation
    when no path has exactly one pose. Returns (is_safe (P,), trav (P,)).
    """
    dev = state.device
    poses = torch.as_tensor(poses, dtype=torch.float32, device=dev)
    P, N, _ = poses.shape
    n_poses = torch.as_tensor(n_poses, dtype=torch.int32, device=dev)

    if has_single_pose or N == 1:
        ok1, trav1 = check_circles(state, poses[:, 0, :], radius + offset, radius)
    else:
        ok1 = torch.zeros((P,), dtype=torch.bool, device=dev)
        trav1 = torch.zeros((P,), dtype=torch.float32, device=dev)

    if N == 1:
        safe = ok1 & (n_poses >= 1)
        return safe, torch.where(ok1, trav1, 0.0)

    # path samples are always cell centers, so the dense field answers each
    # with one lookup
    if field is None:
        from traversability_estimation_tpu_torch.ops.field_kernel import (
            dense_circle_field as field_fn,
        )

        field = field_fn(state, radius + offset, radius)
    field_ok, field_trav = field

    starts = poses[:, :-1, :]
    ends = poses[:, 1:, :]
    seg_valid = torch.arange(1, N, device=dev)[None, :] < n_poses[:, None]

    # the reference iterates from END to START
    cells, cell_valid, _ = line_cells_batch(
        _index_of(state, ends), _index_of(state, starts), max_segment_cells
    )
    # stride-4 sampling (nSkip = 3): positions 0, 4, 8, ...
    S = (max_segment_cells + 3) // 4
    sample_ids = torch.arange(S, device=dev) * 4
    s_cells = cells[..., sample_ids, :]
    s_valid = cell_valid[..., sample_ids]

    default = float(state.default_traversability)
    # (ok, trav) packed into one plane: trav >= 0, failing cells store -1-trav
    packed = torch.where(field_ok, field_trav, -1.0 - field_trav)
    fill = default if default != 0.0 else -1.0 - default
    p_s, _ = _gather_plane(packed, s_cells, f32(fill))
    ok_s = p_s >= 0.0
    trav_s = torch.where(ok_s, p_s, -1.0 - p_s)

    return aggregate_sampled_segments(
        ok_s, trav_s, s_valid, seg_valid, starts, ends, n_poses, ok1, trav1
    )


def aggregate_sampled_segments(
    ok_s, trav_s, s_valid, seg_valid, starts, ends, n_poses, ok1, trav1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment -> path aggregation: per-segment all-samples-ok and sample
    mean, then the length-weighted path mean (with a correct running length
    where the reference reads an uninitialised one)."""
    s_active = s_valid & seg_valid[..., None]
    seg_ok = (ok_s | ~s_active).all(dim=-1)
    n_s = torch.clamp_min(s_active.sum(dim=-1), 1)
    seg_trav = torch.where(s_active, trav_s, 0.0).sum(dim=-1) / n_s

    d = ends - starts
    seg_len = sqrt_f32(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    w = torch.where(seg_valid, seg_len, 0.0)
    # degenerate all-zero-length multi-pose path: uniform weights
    w_sum = w.sum(dim=-1, keepdim=True)
    w = torch.where(w_sum > 0.0, w, seg_valid.to(torch.float32))
    path_trav_multi = (w * seg_trav).sum(dim=-1) / torch.clamp_min(w.sum(dim=-1), 1e-30)
    multi_ok = (seg_ok | ~seg_valid).all(dim=-1)

    is_single = n_poses == 1
    safe = torch.where(is_single, ok1, multi_ok) & (n_poses >= 1)
    trav = torch.where(is_single, trav1, path_trav_multi)
    return safe, torch.where(safe, trav, 0.0)


def check_inclination_paths(
    state: QueryState, robot_slope: torch.Tensor, poses, n_poses, max_segment_cells: int
) -> torch.Tensor:
    """Batched checkInclination: a path fails if any valid `robot_slope`
    cell on any segment's full Bresenham line (stride 1) is exactly 0; a
    single-pose path tests the pose's own cell. No filter of the reference
    produces `robot_slope`: the check is active only when a configured chain
    adds that layer. Returns ok (P,) bool."""
    dev = state.device
    poses = torch.as_tensor(poses, dtype=torch.float32, device=dev)
    n_poses = torch.as_tensor(n_poses, dtype=torch.int32, device=dev)
    N = poses.shape[1]
    fail_plane = robot_slope == 0.0  # NaN -> False (invalid cells skipped)

    f0, _ = _gather_plane(fail_plane, _index_of(state, poses[:, 0, :]), False)
    if N == 1:
        return ~f0
    seg_valid = torch.arange(1, N, device=dev)[None, :] < n_poses[:, None]
    cells, cell_valid, _ = line_cells_batch(
        _index_of(state, poses[:, :-1, :]), _index_of(state, poses[:, 1:, :]), max_segment_cells
    )
    f, _ = _gather_plane(fail_plane, cells, False)
    seg_fail = (f & cell_valid).any(dim=-1)
    multi_fail = (seg_fail & seg_valid).any(dim=-1)
    return torch.where(n_poses == 1, ~f0, ~multi_fail)


def traversability_footprint_circles(
    state: QueryState, radius: float, offset: float
) -> torch.Tensor:
    """Dense per-cell circular footprint scores, the
    ``traversability_footprint`` service layer: the dense circle field
    (kernel 2 on a CUDA map) with 0.0 where not traversable. (H, W) f32."""
    from traversability_estimation_tpu_torch.ops.field_kernel import dense_circle_field as field_fn

    ok, trav = field_fn(state, radius + offset, radius)
    return torch.where(ok, trav, 0.0)


# ---------------------------------------------------------------------------
# Polygonal footprints
# ---------------------------------------------------------------------------

# elements of one (B, wi, wj) window temporary per chunk of polygons: eager
# torch materialises every one of them
_WINDOW_CHUNK_ELEMS = 1 << 24


def transform_footprint(
    footprint: torch.Tensor, positions: torch.Tensor, quaternions: torch.Tensor
) -> torch.Tensor:
    """Footprint vertices (V, 2) transformed by poses: the full 3D rotation
    of (x, y, 0) plus the translation, z dropped.

    positions: (..., 3); quaternions: (..., 4) as (x, y, z, w).
    Returns (..., V, 2).
    """
    x, y, z, w = (quaternions[..., i] for i in range(4))
    # the multiply-adds XLA:CPU contracts into FMAs when it compiles this
    # function are FMAs here too (one ulp in a vertex can move a cell whose
    # centre lies on an edge): the norm as a chain, x*y -+ z*w, 1 - s*(..)
    # and the first product of each output row
    n = fma_f32(w, w, fma_f32(z, z, fma_f32(x, x, y * y)))
    s = torch.where(n > 0.0, 2.0 / torch.where(n > 0.0, n, 1.0), 0.0)
    # rotation matrix rows acting on (px, py, 0)
    r00 = fma_f32(-s, y * y + z * z, 1.0)
    r01 = s * fma_f32(x, y, -(z * w))
    r10 = s * fma_f32(x, y, z * w)
    r11 = fma_f32(-s, x * x + z * z, 1.0)
    px = footprint[:, 0]
    py = footprint[:, 1]
    out_x = fma_f32(r00[..., None], px, r01[..., None] * py) + positions[..., 0:1]
    out_y = fma_f32(r10[..., None], px, r11[..., None] * py) + positions[..., 1:2]
    return torch.stack([out_x, out_y], dim=-1)


def _query_plane(state: QueryState, pad: int) -> torch.Tensor:
    """The packed plane polygon windows are cut from: vetoed cell -> -inf,
    else the traversability (NaN -> default), inside a ring of +inf (beyond
    the map) `pad` cells wide."""
    tv_eff = torch.where(
        torch.isfinite(state.traversability),
        state.traversability,
        state.default_traversability,
    )
    packed = torch.where(state.traversable_mask, tv_eff, -math.inf)
    return torch.nn.functional.pad(packed, (pad, pad, pad, pad), value=math.inf)


def _window_starts(state: QueryState, anchor_idx: torch.Tensor, wi: int, wj: int, pad: int):
    """Top-left corners, in the padded plane, of (wi, wj) windows centred on
    the anchor cells. Clipped: a wholly off-map anchor lands its window
    entirely in the +inf ring (pad >= wi, wj), so verdicts are unchanged."""
    H, W = state.shape
    start_i = (anchor_idx[:, 0] - wi // 2 + pad).clamp(0, H + 2 * pad - wi)
    start_j = (anchor_idx[:, 1] - wj // 2 + pad).clamp(0, W + 2 * pad - wj)
    return start_i.to(torch.int64), start_j.to(torch.int64)


def _fetch_windows(plane, start_i, start_j, wi: int, wj: int) -> torch.Tensor:
    """(B, wi, wj) windows of `plane` from their top-left corners (B,)."""
    rows = start_i[:, None] + torch.arange(wi, device=plane.device)
    cols = start_j[:, None] + torch.arange(wj, device=plane.device)
    return plane[rows[:, :, None], cols[:, None, :]]


def _cell_coord(p0_axis: torch.Tensor, g: torch.Tensor, res: float) -> torch.Tensor:
    """Map-frame coordinate of the centre of cell index `g` (float32 values
    of integers) along one axis: ``p0 - (g + 0.5) * res`` as the one fused
    multiply-add XLA:CPU compiles it to. A cell centre an ulp away flips the
    crossing test of a cell that lies on a polygon's edge."""
    return fma_f32(-(g + 0.5), f32(res), p0_axis)


def _crossing_count(vertices, n_vertices, px, py) -> torch.Tensor:
    """Crossing-number inside test over a separable cell grid: what
    ``geometry.polygon_contains`` gives at every (px[i], py[j]) pair, with the
    sign of the edge's dy folded in by exact +-1 multiplies so that every
    comparison is the same float comparison.

    vertices: (B, M, 2); n_vertices: (B,); px: (B, wi); py: (B, wj).
    Returns inside (B, wi, wj) bool.
    """
    B, M, _ = vertices.shape
    idx = torch.arange(M, device=vertices.device)
    nv = n_vertices.to(torch.int64)
    jdx = torch.where(idx[None, :] == 0, nv[:, None] - 1, idx[None, :] - 1)  # (B, M)
    vj = torch.gather(vertices, 1, jdx[..., None].expand(vertices.shape))
    xi, yi = vertices[..., 0], vertices[..., 1]  # (B, M)
    xj, yj = vj[..., 0], vj[..., 1]
    denom = yj - yi
    s = torch.where(denom > 0.0, 1.0, -1.0)
    valid = idx[None, :] < nv[:, None]

    cnt = torch.zeros((B, px.shape[-1], py.shape[-1]), dtype=torch.int32, device=vertices.device)
    for e in range(M):
        sl = slice(e, e + 1)
        cond_e = ((yi[:, sl] > py) != (yj[:, sl] > py)) & valid[:, sl]  # (B, wj)
        lhs_e = (px - xi[:, sl]) * (denom[:, sl] * s[:, sl])
        rhs_e = ((xj[:, sl] - xi[:, sl]) * (py - yi[:, sl])) * s[:, sl]
        cnt += cond_e[:, None, :] & (lhs_e[:, :, None] < rhs_e[:, None, :])
    return (cnt & 1) == 1


def _eval_polygon_windows(state: QueryState, vertices, n_vertices, anchor_idx, window):
    """The masked-window reduction under every per-polygon check: one window
    of the packed query plane per polygon, the crossing-number inside mask
    from separable cell positions, and the fail/count/sum reductions.
    Returns (fail (B,), n_cells (B,), tv_sum (B,)).
    """
    wi, wj = (window, window) if isinstance(window, int) else window
    pad = max(wi, wj)
    plane = _query_plane(state, pad)
    p0 = _origin_offset(state)
    res = state.resolution

    def eval_chunk(vertices, n_vertices, anchor_idx):
        start_i, start_j = _window_starts(state, anchor_idx, wi, wj, pad)
        win = _fetch_windows(plane, start_i, start_j, wi, wj)
        gi = (start_i[:, None] - pad) + torch.arange(wi, device=win.device)
        gj = (start_j[:, None] - pad) + torch.arange(wj, device=win.device)
        px = _cell_coord(p0[0], gi.to(torch.float32), res)  # (B, wi)
        py = _cell_coord(p0[1], gj.to(torch.float32), res)  # (B, wj)
        inside = _crossing_count(vertices, n_vertices, px, py)
        fail = (inside & (win == -math.inf)).any(dim=2).any(dim=1)
        passing = inside & torch.isfinite(win)
        n_cells = passing.sum(dim=(1, 2))
        tv_sum = torch.where(passing, win, 0.0).sum(dim=(1, 2))
        return fail, n_cells, tv_sum

    B = vertices.shape[0]
    chunk = max(1, _WINDOW_CHUNK_ELEMS // (wi * wj))
    if B <= chunk:
        return eval_chunk(vertices, n_vertices, anchor_idx)
    parts = [
        eval_chunk(vertices[b : b + chunk], n_vertices[b : b + chunk], anchor_idx[b : b + chunk])
        for b in range(0, B, chunk)
    ]
    return tuple(torch.cat([p[k] for p in parts]) for k in range(3))


def _window_verdict(state: QueryState, fail, n_cells, tv_sum):
    """(ok, trav) of polygons from their window reductions: any vetoed cell
    fails; no cell at all gives the default verdict."""
    default = state.default_traversability
    empty = (n_cells == 0) & ~fail
    ok = ~fail & (~empty | (default != 0.0))
    mean = tv_sum / n_cells.clamp_min(1)
    trav = torch.where(fail, 0.0, torch.where(empty, default, mean))
    return ok, trav


def check_polygons(
    state: QueryState, vertices, n_vertices, anchors, window
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched isTraversable(polygon) for arbitrary (convex or not)
    polygons: crossing-number rasterisation (grid_map PolygonIterator
    parity) over windows of the packed query plane.

    vertices: (B, M, 2), the first n_vertices[b] real; anchors: (B, 2)
    map-frame window centres; window: cells, an int or (wi, wj).
    Returns (ok (B,), trav (B,), n_cells (B,)).
    """
    dev = state.device
    vertices = torch.as_tensor(vertices, dtype=torch.float32, device=dev)
    n_vertices = torch.as_tensor(n_vertices, device=dev).to(torch.int32).expand(vertices.shape[0])
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=dev)
    fail, n_cells, tv_sum = _eval_polygon_windows(
        state, vertices, n_vertices, _index_of(state, anchors), window
    )
    ok, trav = _window_verdict(state, fail, n_cells, tv_sum)
    return ok, trav, n_cells


def polygon_prefix_planes(
    state: QueryState, in_map: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row prefix sums that turn the reduction of a polygon's row span
    into two lookups (the tiled polygonal evaluator,
    ``parallel/sharding.py``).

    Returns (counts (H, W+1) int32, the prefix of fail * 65536 + pass per
    cell; tv (H, W+1) f32, the prefix of the passing cells' traversability,
    NaN read as the default). The packed counts stay exact in int32 up to
    ~32k columns (W * 65537 < 2^31). Cells where `in_map` is False (a tile's padding beyond the map) count as
    neither.
    """
    ok = state.traversable_mask
    fail = ~ok
    if in_map is not None:
        ok = ok & in_map
        fail = fail & in_map
    tv = torch.where(
        torch.isfinite(state.traversability),
        state.traversability,
        state.default_traversability,
    )
    counts_cell = fail.to(torch.int32) * 65536 + ok.to(torch.int32)
    tv_cell = torch.where(ok, tv, 0.0)
    zeros = torch.zeros((ok.shape[0], 1), dtype=torch.int32, device=ok.device)
    counts = torch.cat([zeros, torch.cumsum(counts_cell, dim=1, dtype=torch.int32)], dim=1)
    tv_pre = torch.cat([zeros.to(torch.float32), torch.cumsum(tv_cell, dim=1)], dim=1)
    return counts, tv_pre


def swept_hull_translates(poly1, poly2, footprint, d):
    """Convex hull of two TRANSLATED copies of one convex polygon, O(V).

    For identity-orientation paths, consecutive footprints are translates of
    the same convex polygon: hull(P u P+d) = P (+) segment[0, d] (Minkowski),
    whose boundary is P's edges with the two bridge edges (+-d) inserted at
    the two extreme vertices. Emitted branchlessly as a fixed 2V-vertex ring:
    vertex k contributes its poly1 copy where the adjacent edge's outward
    normal opposes d, its poly2 copy where it aligns, and BOTH at the two
    straddle vertices. Duplicate vertices (the common case) are harmless for
    crossing tests and the shoelace area. Vertex values are selects between
    poly1 and poly2: no arithmetic on coordinates.

    poly1, poly2: (..., V, 2) translated copies; footprint: (V, 2) base
    polygon, CONVEX in stored order (see ``is_convex_polygon``); d: (..., 2)
    translation poly1 -> poly2.
    Returns (hull (..., 2V, 2), n_hull (...,) = 2V).
    """
    fp = footprint
    V = fp.shape[0]
    nxt = torch.roll(fp, -1, dims=0)
    e = nxt - fp  # edge k: v_k -> v_{k+1}, (V, 2)
    # orientation: shoelace sign (+1 CCW, -1 CW)
    orient = torch.sign((fp[:, 0] * nxt[:, 1] - nxt[:, 0] * fp[:, 1]).sum())
    orient = torch.where(orient == 0.0, 1.0, orient)
    # outward normal of edge k opposes d  <=>  orient * cross(e_k, d) >= 0
    cross = e[:, 0] * d[..., None, 1] - e[:, 1] * d[..., None, 0]  # (..., V)
    g = (cross * orient) < 0.0  # True -> poly2 copy past edge k
    g_prev = torch.roll(g, 1, dims=-1)  # flag of edge k-1 (entering vertex k)

    sel_in = torch.where(g_prev[..., None], poly2, poly1)  # (..., V, 2)
    sel_out = torch.where(g[..., None], poly2, poly1)
    hull = torch.stack([sel_in, sel_out], dim=-2)  # (..., V, 2, 2)
    hull = hull.reshape(*poly1.shape[:-2], 2 * V, 2)
    n_hull = torch.full(poly1.shape[:-2], 2 * V, dtype=torch.int32, device=poly1.device)
    return hull, n_hull


def is_convex_polygon(footprint: np.ndarray) -> bool:
    """Host-side: is the polygon convex in its stored vertex order
    (collinear vertices allowed)? Gates the swept-hull fast path and the
    grouped evaluator."""
    fp = np.asarray(footprint, np.float64)
    if len(fp) < 3:
        return False
    e = np.roll(fp, -1, axis=0) - fp
    en = np.roll(e, -1, axis=0)
    cross = e[:, 0] * en[:, 1] - e[:, 1] * en[:, 0]
    return bool(np.all(cross >= 0.0) or np.all(cross <= 0.0))


def _path_inputs(state: QueryState, positions, quaternions, n_poses, footprint):
    dev = state.device
    return (
        torch.as_tensor(positions, dtype=torch.float32, device=dev),
        torch.as_tensor(quaternions, dtype=torch.float32, device=dev),
        torch.as_tensor(n_poses, device=dev).to(torch.int32),
        torch.as_tensor(footprint, dtype=torch.float32, device=dev),
    )


def _segment_rings(polys, positions, footprint, conservative: bool, translate_only: bool):
    """The convex ring each consecutive pose pair sweeps, and polygon1 of the
    reference's area bookkeeping.

    polys: (P, N, V, 2) transformed footprints. Returns (rings (P, N-1, Mh,
    2), n_ring (P, N-1) real vertices per ring, poly1 (P, N-1, Mv, 2)).
    """
    P, N, V, _ = polys.shape
    prev = polys[:, :-1]
    cur = polys[:, 1:]
    step = positions[:, 1:, :2] - positions[:, :-1, :2]  # (P, N-1, 2)
    if conservative:
        # the footprint also placed at the neighbouring pose, unrotated
        d = step[:, :, None, :]
        poly1 = torch.cat([prev, cur - d], dim=2)  # (P, N-1, 2V, 2)
        poly2 = torch.cat([cur, prev + d], dim=2)
    else:
        poly1 = prev
        poly2 = cur
    Mv = poly1.shape[2]
    if translate_only and not conservative:
        rings, n_ring = swept_hull_translates(prev, cur, footprint, step)
    else:
        points = torch.cat([poly1, poly2], dim=2).reshape(P * (N - 1), 2 * Mv, 2)
        rings, n_ring = convex_hull_batch(points, 2 * Mv)
        rings = rings.reshape(P, N - 1, 2 * Mv, 2)
        n_ring = n_ring.reshape(P, N - 1)
    return rings, n_ring, poly1


def _aggregate_polygonal_path(
    seg_ok, seg_trav, hull_area, poly1_area, n_poses, ok1, trav1, area1
):
    """Segments -> path: all valid segments ok, and the reference's running
    area-weighted mean:
      i == 1: area = hullArea; trav = segTrav
      i  > 1: areaNew = hullArea_i - poly1Area_i; area += areaNew;
              trav = (areaNew * segTrav_i + areaPrev * trav) / area
    Single-pose paths take the pose-0 footprint's own verdict."""
    S = seg_ok.shape[1]
    seg_valid = torch.arange(1, S + 1, device=seg_ok.device)[None, :] < n_poses[:, None]
    multi_ok = (seg_ok | ~seg_valid).all(dim=-1)
    weights = torch.cat([hull_area[:, :1], hull_area[:, 1:] - poly1_area[:, 1:]], dim=1)
    weights = torch.where(seg_valid, weights, 0.0)
    total_area = weights.sum(dim=-1)
    trav_multi = (weights * seg_trav).sum(dim=-1) / torch.where(
        total_area != 0.0, total_area, 1.0
    )
    is_single = n_poses == 1
    safe = torch.where(is_single, ok1, multi_ok) & (n_poses >= 1)
    trav = torch.where(is_single, torch.where(ok1, trav1, 0.0), trav_multi)
    area = torch.where(is_single, torch.where(ok1, area1, 0.0), total_area)
    trav = torch.where(safe, trav, 0.0)
    area = torch.where(safe | is_single, area, 0.0)
    return safe, trav, area


def check_polygonal_paths(
    state: QueryState,
    positions,
    quaternions,
    n_poses,
    footprint,
    window,
    conservative: bool = False,
    translate_only: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched checkPolygonalFootprintPath, one raster window per segment.

    positions: (P, N, 3); quaternions: (P, N, 4) xyzw; footprint: (V, 2) in
    the base frame; `window` must cover hulls of consecutive footprints
    (``polygon_window_cells``). `translate_only`: pass True only when every
    quaternion is identity AND the footprint is convex in stored order
    (``is_convex_polygon``): consecutive-footprint hulls then skip the
    O(V^3) hull for the O(V) swept-hull emission.
    Returns (is_safe (P,), traversability (P,), area (P,)).
    """
    positions, quaternions, n_poses, footprint = _path_inputs(
        state, positions, quaternions, n_poses, footprint
    )
    P, N, _ = positions.shape
    V = footprint.shape[0]
    polys = transform_footprint(footprint, positions, quaternions)  # (P, N, V, 2)

    # single pose: the raw user footprint, possibly non-convex
    ok1, trav1, _ = check_polygons(state, polys[:, 0], V, positions[:, 0, :2], window)
    area1 = polygon_area(polys[:, 0], V)
    if N == 1:
        safe = ok1 & (n_poses >= 1)
        return safe, torch.where(ok1, trav1, 0.0), torch.where(ok1, area1, 0.0)

    rings, n_ring, poly1 = _segment_rings(polys, positions, footprint, conservative, translate_only)
    Mh = rings.shape[2]
    mids = (0.5 * (positions[:, 1:, :2] + positions[:, :-1, :2])).reshape(P * (N - 1), 2)
    seg_ok, seg_trav, _ = check_polygons(
        state, rings.reshape(P * (N - 1), Mh, 2), n_ring.reshape(P * (N - 1)), mids, window
    )
    return _aggregate_polygonal_path(
        seg_ok.reshape(P, N - 1),
        seg_trav.reshape(P, N - 1),
        polygon_area(rings, n_ring),
        polygon_area(poly1, poly1.shape[2]),  # grid_map getArea, stored vertex order
        n_poses, ok1, trav1, area1,
    )


SEG_BLOCK = 8  # segments evaluated per step of the grouped evaluator


def _window_cells(reach: float, resolution: float) -> int:
    """Cells of a window reaching `reach` either side of its centre, with 3
    cells of slack, rounded up to a multiple of 4 (a larger window never
    changes a result)."""
    c = 2 * int(math.ceil(reach / resolution)) + 3
    return ((c + 3) // 4) * 4


def _extent_window(fp, ex: float, ey: float, resolution: float, identity_orientation: bool):
    """(wi, wj) covering pose-bbox half extents (ex, ey) plus the footprint's
    reach: its per-axis extent when no pose rotates it, else its
    circumradius."""
    if identity_orientation:
        return (
            _window_cells(ex + float(np.abs(fp[:, 0]).max()), resolution),
            _window_cells(ey + float(np.abs(fp[:, 1]).max()), resolution),
        )
    r = float(np.max(np.linalg.norm(fp, axis=1)))
    return (_window_cells(ex + r, resolution), _window_cells(ey + r, resolution))


def path_group_window(
    footprint: np.ndarray,
    pose_extents: np.ndarray,
    resolution: float,
    identity_orientation: bool = False,
) -> Tuple[int, int]:
    """The per-PATH raster window of ``check_polygonal_paths_grouped``:
    covers every consecutive-footprint hull of every path in the batch
    (pose-bbox half extent + footprint reach).

    The conservative sweep needs no extra margin: its extra vertices are the
    footprint placed at the neighbouring pose, which the pose bbox already
    covers.

    pose_extents: (P, 2) per-path (max - min) over the path's valid poses.
    """
    fp = np.asarray(footprint, np.float64)
    ext = np.asarray(pose_extents, np.float64).reshape(-1, 2)
    ex = float(ext[:, 0].max()) / 2 if ext.size else 0.0
    ey = float(ext[:, 1].max()) / 2 if ext.size else 0.0
    return _extent_window(fp, ex, ey, resolution, identity_orientation)


def per_path_window_cells(
    footprint: np.ndarray,
    positions: np.ndarray,
    quaternions: np.ndarray,
    resolution: float,
) -> np.ndarray:
    """Per-PATH raster-window requirement (P, 2) int cells from the ACTUAL
    transformed footprint vertices (quaternions are host data at dispatch
    time): per path, the exact bbox of every vertex its swept hulls can
    touch, {pos_k + R_m fp_v, |k-m| <= 1} (adjacency covers the conservative
    sweep's prev+d / cur-d vertices), measured around the pose-bbox anchor
    the grouped evaluator uses. The basis of ``path_group_window_exact``
    and of window bucketing (``plan_window_buckets``).

    positions: (P, N, >=2); quaternions: (P, N, 4) xyzw. Padded poses must
    repeat the last valid pose (they only duplicate vertices).
    """
    fp = np.asarray(footprint, np.float64)
    pos = np.asarray(positions, np.float64)[..., :2]
    q = np.asarray(quaternions, np.float64)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = np.where(n > 0.0, 2.0 / np.where(n > 0.0, n, 1.0), 0.0)
    # the planar rows of transform_footprint
    r00 = 1 - s * (y * y + z * z)
    r01 = s * (x * y - z * w)
    r10 = s * (x * y + z * w)
    r11 = 1 - s * (x * x + z * z)
    vx = r00[..., None] * fp[:, 0] + r01[..., None] * fp[:, 1]  # (P, N, V)
    vy = r10[..., None] * fp[:, 0] + r11[..., None] * fp[:, 1]
    lo_x, hi_x = vx.min(axis=-1), vx.max(axis=-1)  # (P, N)
    lo_y, hi_y = vy.min(axis=-1), vy.max(axis=-1)

    def adj(a, red):
        out = a.copy()
        out[:, :-1] = red(out[:, :-1], a[:, 1:])
        out[:, 1:] = red(out[:, 1:], a[:, :-1])
        return out

    hi_x, hi_y = adj(hi_x, np.maximum), adj(hi_y, np.maximum)
    lo_x, lo_y = adj(lo_x, np.minimum), adj(lo_y, np.minimum)
    vert_hi_x = (pos[..., 0] + hi_x).max(axis=1)  # (P,)
    vert_lo_x = (pos[..., 0] + lo_x).min(axis=1)
    vert_hi_y = (pos[..., 1] + hi_y).max(axis=1)
    vert_lo_y = (pos[..., 1] + lo_y).min(axis=1)
    anchor = 0.5 * (pos.max(axis=1) + pos.min(axis=1))  # (P, 2)
    reach_x = np.maximum(vert_hi_x - anchor[:, 0], anchor[:, 0] - vert_lo_x)
    reach_y = np.maximum(vert_hi_y - anchor[:, 1], anchor[:, 1] - vert_lo_y)

    def cells(reach):
        # _window_cells, elementwise
        c = 2 * np.ceil(reach / resolution).astype(np.int64) + 3
        return ((c + 3) // 4) * 4

    return np.stack([cells(reach_x), cells(reach_y)], axis=-1)


def path_group_window_exact(
    footprint: np.ndarray,
    positions: np.ndarray,
    quaternions: np.ndarray,
    resolution: float,
) -> Tuple[int, int]:
    """The per-PATH raster window of ``check_polygonal_paths_grouped`` for
    rotated batches: the largest ``per_path_window_cells`` over the batch.

    ``path_group_window`` prices a rotated batch at pose extent plus the
    circumradius over ALL rotations, composed as a sum of maxima over
    different paths; this is never larger.
    """
    win = per_path_window_cells(footprint, positions, quaternions, resolution)
    return int(win[:, 0].max()), int(win[:, 1].max())


def plan_window_buckets(
    footprint: np.ndarray,
    positions: np.ndarray,
    quaternions: np.ndarray,
    resolution: float,
    n_buckets: int = 2,
):
    """Host-side window-bucketing plan for a polygonal batch: paths sorted by
    the area of their own raster window (``per_path_window_cells``) and cut
    into `n_buckets` groups of equal size, each with the smallest window
    covering its members. One static window prices every path at the batch's
    worst case; in a planner batch the per-path extents follow a random walk
    whose tail sets the maximum, so most paths need about half that area.

    Returns (idx_groups, windows, inverse): the groups' path indices, each
    group's (wi, wj), and the permutation that restores the batch order of
    the concatenated group results. For ``check_polygonal_paths_bucketed``.
    """
    pos_np = np.asarray(positions, np.float32)
    quat_np = np.asarray(quaternions, np.float32)
    P = pos_np.shape[0]
    win_pp = per_path_window_cells(footprint, pos_np, quat_np, resolution)
    areas = win_pp[:, 0] * win_pp[:, 1]
    order = np.argsort(areas, kind="stable")
    idx_groups, windows = [], []
    lo = 0
    for b in range(n_buckets):
        hi = (P * (b + 1)) // n_buckets
        idx = order[lo:hi]
        lo = hi
        if idx.size == 0:
            continue
        idx_groups.append(idx)
        windows.append((int(win_pp[idx, 0].max()), int(win_pp[idx, 1].max())))
    inverse = np.argsort(np.concatenate(idx_groups), kind="stable")
    return (
        tuple(tuple(g.tolist()) for g in idx_groups),
        tuple(windows),
        tuple(inverse.tolist()),
    )


def check_polygonal_paths_bucketed(
    state: QueryState,
    positions,
    quaternions,
    n_poses,
    footprint,
    plan,
    conservative: bool = False,
    translate_only: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The grouped evaluator under a ``plan_window_buckets`` plan: one
    grouped evaluation per bucket, with that bucket's window. Per-path
    results are independent of the batch, so verdicts and areas equal the
    single-window call's; traversability sums run over another window shape
    (within the last ulps). Same requirements as
    ``check_polygonal_paths_grouped``.
    """
    positions, quaternions, n_poses, footprint = _path_inputs(
        state, positions, quaternions, n_poses, footprint
    )
    idx_groups, windows, inverse = plan
    outs = []
    for idx, window in zip(idx_groups, windows):
        ii = torch.as_tensor(idx, dtype=torch.int64, device=state.device)
        outs.append(check_polygonal_paths_grouped(
            state, positions[ii], quaternions[ii], n_poses[ii], footprint, window,
            conservative, translate_only,
        ))
    inv = torch.as_tensor(inverse, dtype=torch.int64, device=state.device)
    return tuple(torch.cat([o[k] for o in outs])[inv] for k in range(3))


def path_block_window(
    footprint: np.ndarray,
    positions: np.ndarray,
    resolution: float,
    identity_orientation: bool = False,
    seg_block: int = SEG_BLOCK,
) -> Tuple[int, int]:
    """The per-SEGMENT-BLOCK raster window of the grouped evaluator's
    block-window mode: covers every consecutive-footprint hull of any
    `seg_block` consecutive segments (block pose-bbox half extent +
    footprint reach). A block spans ~8 pose steps instead of the whole
    path, so its window is much smaller than ``path_group_window``'s.

    positions: (P, N, >=2) the pose batch (padded poses must repeat the
    last valid pose: they only shrink the bbox).
    """
    fp = np.asarray(footprint, np.float64)
    pos = np.asarray(positions, np.float64)[..., :2]
    N = pos.shape[1]
    S = max(N - 1, 1)
    ex = ey = 0.0
    for b0 in range(0, S, seg_block):
        # block b covers segments [b0, b0+SB) -> poses [b0, b0+SB]
        sl = pos[:, b0 : min(b0 + seg_block, S) + 1]
        e = sl.max(axis=1) - sl.min(axis=1)  # (P, 2)
        ex = max(ex, float(e[:, 0].max()) / 2)
        ey = max(ey, float(e[:, 1].max()) / 2)
    return _extent_window(fp, ex, ey, resolution, identity_orientation)


def polygon_window_cells(
    footprint: np.ndarray,
    max_segment_length: float,
    resolution: float,
    conservative: bool = False,
    identity_orientation: bool = False,
):
    """The per-segment raster window covering any consecutive-footprint
    hull: a square int sized by the footprint circumradius; with
    `identity_orientation` (no pose rotates the footprint) a tight (wi, wj)
    rectangle from the per-axis extents instead."""
    fp = np.asarray(footprint, np.float64)
    grow = (1.5 if conservative else 0.5) * max_segment_length
    if identity_orientation:
        return (
            _window_cells(float(np.abs(fp[:, 0]).max()) + grow, resolution),
            _window_cells(float(np.abs(fp[:, 1]).max()) + grow, resolution),
        )
    return _window_cells(float(np.max(np.linalg.norm(fp, axis=1))) + grow, resolution)


def check_polygonal_paths_grouped(
    state: QueryState,
    positions,
    quaternions,
    n_poses,
    footprint,
    window: Tuple[int, int],
    conservative: bool = False,
    translate_only: bool = False,
    block_window: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """checkPolygonalFootprintPath grouped per PATH: the formulation for
    planner batches with short segments.

    A path's consecutive hulls overlap almost entirely, so this evaluator
    fetches ONE window per path (pose bbox + footprint reach) where the
    per-segment evaluator fetches one per segment, and streams the segments
    through it in blocks of ``SEG_BLOCK``:

    - per (edge, window column): binary-search the row where the
      crossing-number comparison flips. px falls with the row index and
      every probe reads the row's exact grid coordinate, so every comparison
      is the one ``geometry.polygon_contains`` makes;
    - a convex ring straddles each horizontal line with exactly 0 or 2
      edges, so the inside run per column is [min, max) of the flip rows;
    - fail/count/sum reduce against the path window.

    With `block_window` (``path_block_window``) each block of segments gets a
    window of its own, anchored at the block's hull bbox centre: the tier
    for long paths whose per-path window is too large.

    REQUIREMENTS (caller-checked, see models/estimator.py):
    - footprint CONVEX in stored order (``is_convex_polygon``): the span
      rule and the single-pose branch assume convex rings;
    - `window` from ``path_group_window`` (covers every path's pose bbox);
    - padded poses beyond n_poses[p] repeat the last valid pose.

    Returns (is_safe (P,), traversability (P,), area (P,)).
    """
    positions, quaternions, n_poses, footprint = _path_inputs(
        state, positions, quaternions, n_poses, footprint
    )
    dev = state.device
    P, N, _ = positions.shape
    V = footprint.shape[0]
    res = state.resolution
    use_blocks = block_window is not None
    wi, wj = block_window if use_blocks else window
    gpad = max(wi, wj)
    n_bits = max(1, math.ceil(math.log2(wi + 1)))
    plane = _query_plane(state, gpad)
    p0 = _origin_offset(state)
    irow = torch.arange(wi, device=dev)[:, None]  # (wi, 1)

    polys = transform_footprint(footprint, positions, quaternions)  # (P, N, V, 2)

    def fetch_context(anchors):
        """(P, 2) anchors -> the window context a block reduces against:
        (fails, finite, values with 0 outside) (P, wi, wj) planes, and the
        exact grid coordinates of the window's rows (P, wi + 1) and columns
        (P, wj)."""
        start_i, start_j = _window_starts(state, _index_of(state, anchors), wi, wj, gpad)
        win = _fetch_windows(plane, start_i, start_j, wi, wj)
        fin = torch.isfinite(win)
        # row wi is probed when a search's bounds meet at the window's end
        gi = (start_i[:, None] - gpad) + torch.arange(wi + 1, device=dev)
        gj = (start_j[:, None] - gpad) + torch.arange(wj, device=dev)
        px = _cell_coord(p0[0], gi.to(torch.float32), res)  # (P, wi + 1)
        py = _cell_coord(p0[1], gj.to(torch.float32), res)  # (P, wj)
        return (win == -math.inf, fin, torch.where(fin, win, 0.0)), px, py

    def seg_block(h_blk, context):
        """(fail, n, sum), each (P, SB), of a block of convex rings per path.

        h_blk: (P, SB, Mb, 2) vertex rings closed by wrap at Mb; padding
        must duplicate real vertices (zero-length edges never straddle a
        horizontal line, so they contribute nothing).
        """
        (neg, fin, winz), px, py = context
        SB, Mb = h_blk.shape[1], h_blk.shape[2]
        vi = h_blk
        vj = torch.roll(h_blk, 1, dims=2)  # previous vertex of the ring
        xi, yi = vi[..., 0].reshape(P, SB * Mb, 1), vi[..., 1].reshape(P, SB * Mb, 1)
        xj, yj = vj[..., 0].reshape(P, SB * Mb, 1), vj[..., 1].reshape(P, SB * Mb, 1)
        denom = yj - yi
        s = torch.where(denom > 0.0, 1.0, -1.0)
        d_abs = denom * s
        pyb = py[:, None, :]  # (P, 1, wj)
        cond = (yi > pyb) != (yj > pyb)  # (P, E, wj)
        rhs = ((xj - xi) * (pyb - yi)) * s
        lo = torch.zeros(cond.shape, dtype=torch.int64, device=dev)
        hi = torch.full(cond.shape, wi, dtype=torch.int64, device=dev)
        px_rows = px[:, None, :].expand(P, SB * Mb, wi + 1)
        for _ in range(n_bits):
            mid = (lo + hi) // 2
            comp = (px_rows.gather(2, mid) - xi) * d_abs < rhs
            lo = torch.where(comp, lo, mid + 1)
            hi = torch.where(comp, mid, hi)
        flip = lo.reshape(P, SB, Mb, wj)
        conds = cond.reshape(P, SB, Mb, wj)
        lo_i = torch.where(conds, flip, wi + 1).amin(dim=2)  # (P, SB, wj)
        hi_i = torch.where(conds, flip, -1).amax(dim=2)
        inside = (irow >= lo_i[:, :, None, :]) & (irow < hi_i[:, :, None, :])  # (P, SB, wi, wj)
        fail = (inside & neg[:, None]).flatten(2).any(dim=2)
        n = (inside & fin[:, None]).flatten(2).sum(dim=2)
        sm = torch.where(inside, winz[:, None], 0.0).flatten(2).sum(dim=2)
        return fail, n, sm

    if not use_blocks:
        # one window per PATH, fetched once, reused by every segment block
        xy = positions[..., :2]
        path_context = fetch_context(0.5 * (xy.amax(dim=1) + xy.amin(dim=1)))

    # single pose: the (convex) footprint polygon at pose 0
    if use_blocks:
        context0 = fetch_context(0.5 * (polys[:, 0].amax(dim=1) + polys[:, 0].amin(dim=1)))
    else:
        context0 = path_context
    f0, n0, s0 = seg_block(polys[:, 0:1], context0)
    ok1, trav1 = _window_verdict(state, f0[:, 0], n0[:, 0], s0[:, 0])
    area1 = polygon_area(polys[:, 0], V)
    if N == 1:
        safe = ok1 & (n_poses >= 1)
        return safe, torch.where(ok1, trav1, 0.0), torch.where(ok1, area1, 0.0)

    # padding of a hull repeats its first vertex: the wrap at Mh then closes
    # the ring with one real edge and zero-length no-ops, so the real vertex
    # count is not needed
    rings, _, poly1 = _segment_rings(polys, positions, footprint, conservative, translate_only)
    S = N - 1
    parts = []
    for b0 in range(0, S, SEG_BLOCK):
        h_blk = rings[:, b0 : b0 + SEG_BLOCK]
        if use_blocks:
            # per-(path, block) windows anchored at the block's hull bbox
            # centre; path_block_window's (wi, wj) covers every block
            flat = h_blk.flatten(1, 2)
            context = fetch_context(0.5 * (flat.amax(dim=1) + flat.amin(dim=1)))
        else:
            context = path_context
        parts.append(seg_block(h_blk, context))
    fail, n, sm = (torch.cat([p[k] for p in parts], dim=1) for k in range(3))
    seg_ok, seg_trav = _window_verdict(state, fail, n, sm)
    return _aggregate_polygonal_path(
        seg_ok, seg_trav,
        polygon_area(rings, rings.shape[2]),
        polygon_area(poly1, poly1.shape[2]),
        n_poses, ok1, trav1, area1,
    )


def _point_in_polygon(verts: np.ndarray, p: np.ndarray) -> bool:
    """grid_map Polygon::isInside crossing-number parity, float64 on the
    host."""
    cross = 0
    nv = len(verts)
    j = nv - 1
    for i in range(nv):
        vi, vj = verts[i], verts[j]
        if (vi[1] > p[1]) != (vj[1] > p[1]):
            x_cross = (vj[0] - vi[0]) * (p[1] - vi[1]) / (vj[1] - vi[1]) + vi[0]
            if p[0] < x_cross:
                cross += 1
        j = i
    return cross % 2 == 1


def dense_polygon_field(
    state: QueryState, vertices_origin: np.ndarray
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cell polygonal footprint verdict for the polygon placed (without
    further rotation) at every CELL CENTER: the traversability_footprint
    service workload.

    The relative cell offsets the polygon covers are static (the
    crossing-number rule of PolygonIterator, evaluated on the host in
    float64), so the whole layer is a sequence of shifted reductions.

    vertices_origin: (V, 2) numpy polygon in the base frame (origin-centred).
    Returns (ok (H, W) bool, trav (H, W) f32).
    """
    verts = np.asarray(vertices_origin, np.float64)
    res = state.resolution
    reach = int(math.ceil(np.abs(verts).max() / res)) + 1
    offs = [
        (di, dj)
        for di in range(-reach, reach + 1)
        for dj in range(-reach, reach + 1)
        if _point_in_polygon(verts, np.array([-di * res, -dj * res]))
    ]

    fail_plane = ~state.traversable_mask
    tv = torch.where(
        torch.isfinite(state.traversability),
        state.traversability,
        state.default_traversability,
    )
    fail = torch.zeros_like(fail_plane)
    n = torch.zeros_like(tv)
    s = torch.zeros_like(tv)
    tv_pass = torch.where(fail_plane, 0.0, tv)
    pass_plane = torch.where(fail_plane, 0.0, 1.0)
    for di, dj in offs:
        fail = fail | _shifted(fail_plane, di, dj, False)
        n = n + _shifted(pass_plane, di, dj, 0.0)
        s = s + _shifted(tv_pass, di, dj, 0.0)
    ok, trav = _window_verdict(state, fail, n, s)
    return ok, trav
