"""Batched circular footprint and path evaluation as torch ops.

Semantics follow the reference's query engine: circular checks visit cells
in grid_map's exact spiral order (the first-failure radius inflation
depends on the order within a ring); line sampling keeps the stride-4
Bresenham walk from segment end to start; the veto cascade is read from the
dense ``traversable_mask`` plane.

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

from traversability_estimation_tpu_torch.grid.geometry import line_cells_batch, spiral_order
from traversability_estimation_tpu_torch.ops.filters import f32, fma_f32, mul_rcp, rcp, sqrt_f32


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


def _origin_offset(state: QueryState) -> torch.Tensor:
    rows, cols = state.shape
    size = torch.tensor([rows, cols], dtype=torch.float32, device=state.device)
    half = size * state.resolution * 0.5
    return state.position + half  # index i covers x in (P0-(i+1)res, P0-i*res]


def _index_of(state: QueryState, xy: torch.Tensor) -> torch.Tensor:
    p0 = _origin_offset(state)
    return torch.floor(mul_rcp(p0 - xy, state.resolution)).to(torch.int32)


def _position_of(state: QueryState, idx: torch.Tensor) -> torch.Tensor:
    p0 = _origin_offset(state)
    return p0 - (idx.to(torch.float32) + 0.5) * state.resolution


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
    diff = _position_of(state, cells) - centers[:, None, :]
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
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
