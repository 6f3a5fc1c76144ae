"""Batched convex hull as torch ops.

Takes the place of grid_map's ``Polygon::convexHull`` (monotone chain) in
the polygonal path checker, for the small point sets there (two footprints,
M <= 32), without a sort or a stack:

1. edge-validity matrix: directed edge i->j is a hull edge iff every other
   point k lies strictly left of it; collinear points are allowed only
   between i and j (keeps the longest collinear edge, as the monotone chain's
   collinear popping does), and exact duplicates are owned by their lowest
   index. O(M^3) elementwise work, no control flow;
2. successor walk: the hull vertices in CCW order by following each vertex's
   first valid outgoing edge M times.

Output matches the monotone chain: CCW order, collinear points dropped,
padding repeats the first hull vertex (harmless for crossing tests and the
shoelace area). Emitted vertices are selects of input points: their values
carry no arithmetic.
"""

from __future__ import annotations

from typing import Tuple

import torch

from traversability_estimation_tpu_torch.ops.filters import fma_f32, sqrt_f32

# elements of one (B, M, M, M) temporary of hull_edge_matrix per chunk of
# hulls: eager torch materialises every one of them
_CHUNK_ELEMS = 1 << 24


def hull_edge_matrix(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(..., M, M) bool: directed hull edges of the valid points.

    points: (..., M, 2); valid: (..., M) bool mask of real points.
    """
    px = points[..., 0]
    py = points[..., 1]
    # cross((j - i), (k - i)) for all i, j, k
    jx = px[..., None, :, None] - px[..., :, None, None]  # (.., i, j, 1)
    jy = py[..., None, :, None] - py[..., :, None, None]
    kx = px[..., None, None, :] - px[..., :, None, None]  # (.., i, 1, k)
    ky = py[..., None, None, :] - py[..., :, None, None]
    # each sum of two products is one product plus a fused multiply-add, as
    # XLA:CPU compiles it: with near-duplicate points (the conservative
    # sweep's cur - d against prev) the last bit of `cross` decides which
    # side of the band a point falls on, and with it the whole walk
    cross = fma_f32(jx, ky, -(jy * kx))  # (.., i, j, k)
    dot = fma_f32(jx, kx, jy * ky)
    len2 = fma_f32(jx, jx, jy * jy)  # |j - i|^2, broadcast over k

    # a tolerance band for collinearity, not `cross == 0`: vertex coordinates
    # are reproducible only to about an ulp between engines, and an exact
    # test lets that last bit flip edge classifications inconsistently (a
    # successor walk without a valid cycle). The band scales with |j-i||k-i|,
    # the cross product's magnitude: points within ~3e-6 rad of an edge count
    # as collinear, ~25x above float32 rounding noise and narrow enough that
    # distinct geometry is never merged.
    k_len2 = fma_f32(kx, kx, ky * ky)
    eps = 3e-6 * sqrt_f32(len2 * k_len2) + 1e-30
    left = cross > eps
    # near-collinear k allowed only when between i and j (inclusive, with the
    # same tolerance along the edge)
    between = (cross.abs() <= eps) & (dot >= -eps) & (dot <= len2 + eps)
    k_ok = left | between | ~valid[..., None, None, :]
    all_ok = k_ok.all(dim=-1)  # (.., i, j)

    # duplicates: if any k < i equals point i (or k < j equals j), the
    # lower-index copy owns the edge
    M = points.shape[-2]
    same = (px[..., :, None] == px[..., None, :]) & (py[..., :, None] == py[..., None, :])
    idx = torch.arange(M, device=points.device)
    lower = idx[:, None] > idx[None, :]  # (a, b): b < a
    dup_before = (same & lower & valid[..., None, :]).any(dim=-1)  # (.., a)
    return (
        all_ok
        & valid[..., :, None]
        & valid[..., None, :]
        & ~dup_before[..., :, None]
        & ~dup_before[..., None, :]
        & ~same  # no self edges or zero-length duplicate-pair edges
    )


def _convex_hull_chunk(points: torch.Tensor, n_valid: torch.Tensor):
    B, M, _ = points.shape
    idx = torch.arange(M, device=points.device)
    edges = hull_edge_matrix(points, idx < n_valid[:, None])  # (B, M, M)

    has_out = edges.any(dim=-1)  # hull vertices
    # any hull vertex starts the (unique) cycle; the first by index is
    # deterministic (argmax returns the first maximum). Inputs without any
    # hull edge (all points collinear or identical) start at vertex 0, whose
    # self-loop below emits point 0 repeated: the 1-vertex "hull"
    start = torch.argmax(has_out.to(torch.uint8), dim=-1)  # (B,)
    # each vertex's FIRST outgoing edge: with duplicate-heavy inputs (the
    # conservative sweep, where cur - d == prev exactly) the tolerance band
    # can validate more than one. Vertices without one are reached only in
    # the degenerate case and loop onto the start.
    succ = torch.argmax(edges.to(torch.uint8), dim=-1)  # (B, M)
    succ = torch.where(has_out, succ, start[:, None])

    walk = torch.empty((B, M), dtype=torch.int64, device=points.device)
    cur = start
    for t in range(M):
        walk[:, t] = cur
        cur = succ.gather(1, cur[:, None])[:, 0]
    hull = points.gather(1, walk[..., None].expand(B, M, 2))
    # n_hull: the first return to the start after step 0
    back = (walk == start[:, None]) & (idx > 0)
    n_hull = torch.where(back.any(dim=-1), torch.argmax(back.to(torch.uint8), dim=-1), M)
    n_hull = n_hull.clamp_min(1)
    hull = torch.where((idx < n_hull[:, None])[..., None], hull, hull[:, :1])
    return hull, n_hull.to(torch.int32)


def convex_hull_batch(points: torch.Tensor, n_valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Convex hulls of (B, M, 2) point sets (the first n_valid[b] real).

    Returns (hull (B, M, 2) CCW, n_hull (B,) int32), each hull padded by
    repeating its first vertex. Degenerate inputs (all points collinear or
    identical) give a 1-2 vertex "hull": crossing tests then reject
    everything and the shoelace area is 0.
    """
    B, M, _ = points.shape
    n_valid = torch.as_tensor(n_valid, device=points.device).to(torch.int64).expand(B)
    chunk = max(1, _CHUNK_ELEMS // (M * M * M))
    if B <= chunk:
        return _convex_hull_chunk(points, n_valid)
    parts = [
        _convex_hull_chunk(points[b : b + chunk], n_valid[b : b + chunk])
        for b in range(0, B, chunk)
    ]
    return torch.cat([h for h, _ in parts]), torch.cat([n for _, n in parts])


def convex_hull(points: torch.Tensor, n_valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Convex hull of one (M, 2) point set: (hull (M, 2), n_hull scalar)."""
    hull, n_hull = convex_hull_batch(points[None], torch.as_tensor(n_valid).reshape(1))
    return hull[0], n_hull[0]
