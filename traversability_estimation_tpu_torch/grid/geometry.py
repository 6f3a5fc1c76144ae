"""grid_map iterator semantics as static orderings (host numpy) and a batched
Bresenham walk (torch).

- circle -> a static list of integer cell offsets;
- spiral -> a static *ordered* list of offsets reproducing grid_map's exact
  ring-walk visit order (the footprint logic is order-dependent within the
  last ring);
- line   -> Bresenham in closed form over a whole batch of endpoint pairs,
  and for one pair on the host;
- the host's 20-gon circle outline and monotone-chain convex hull, for the
  untraversable-polygon extraction;
- the in-map plane of an array placed in a larger map (a tile with its halo).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch


def global_in_map(shape, origin, global_shape, device=None) -> torch.Tensor:
    """(H, W) bool: which cells of an (H, W) array whose cell (0, 0) is map
    cell `origin` lie inside the `global_shape` map."""
    H, W = shape
    gi = torch.arange(H, device=device) + int(origin[0])
    gj = torch.arange(W, device=device) + int(origin[1])
    rows = (gi >= 0) & (gi < int(global_shape[0]))
    cols = (gj >= 0) & (gj < int(global_shape[1]))
    return rows[:, None] & cols[None, :]


@functools.lru_cache(maxsize=None)
def circle_offsets(radius: float, resolution: float) -> np.ndarray:
    """Integer index offsets of cells whose center lies within `radius` of the
    center cell's center. (K, 2) int32, includes (0, 0) when radius >= 0.

    grid_map's CircleIterator includes a cell iff
    ``(cell_position - center).squaredNorm() <= radius^2``, evaluated here in
    float64 at cell-center distances.
    """
    n = int(math.floor(radius / resolution + 1e-9)) + 1
    offs = []
    r2 = float(radius) * float(radius)
    for di in range(-n, n + 1):
        for dj in range(-n, n + 1):
            d2 = (di * resolution) ** 2 + (dj * resolution) ** 2
            if d2 <= r2 + 1e-12:
                offs.append((di, dj))
    if not offs:
        offs.append((0, 0))
    return np.asarray(offs, dtype=np.int32)


def _signum(x: int) -> int:
    return (x > 0) - (x < 0)


@functools.lru_cache(maxsize=None)
def spiral_order(radius: float, resolution: float) -> Tuple[np.ndarray, np.ndarray]:
    """Exact grid_map SpiralIterator visit order as static offsets.

    Returns ``(offsets (K,2) int32, ring (K,) int32)``: the center first, then
    rings d = 1 .. nRings, each walked as grid_map's ``generateRing`` walks it
    (start at (+d, 0), step along the ring keeping the integer-rounded norm
    equal to d). The two outermost rings are emitted in full and tagged by
    `ring`; the Euclidean re-check against the query center is the caller's.
    """
    n_rings = int(math.ceil(radius / resolution - 1e-12))
    offsets = [(0, 0)]
    rings = [0]
    for d in range(1, n_rings + 1):
        px, py = d, 0
        while True:
            offsets.append((px, py))
            rings.append(d)
            nx, ny = -_signum(py), _signum(px)
            if nx != 0 and int(math.sqrt((px + nx) ** 2 + py**2)) == d:
                px += nx
            elif ny != 0 and int(math.sqrt(px**2 + (py + ny) ** 2)) == d:
                py += ny
            else:
                px += nx
                py += ny
            if px == d and py == 0:
                break
    return np.asarray(offsets, dtype=np.int32), np.asarray(rings, dtype=np.int32)


def line_cells_np(start: np.ndarray, end: np.ndarray) -> np.ndarray:
    """Host Bresenham with grid_map LineIterator parity (float64-free integer form): cells from start to
    end inclusive, ``n = max(|di|,|dj|) + 1`` cells."""
    start = np.asarray(start, dtype=np.int64)
    end = np.asarray(end, dtype=np.int64)
    delta = np.abs(end - start)
    sign = np.where(end >= start, 1, -1)
    if delta[0] >= delta[1]:
        denom, num_add = delta[0], delta[1]
        inc_main = np.array([sign[0], 0])
        inc_over = np.array([0, sign[1]])
    else:
        denom, num_add = delta[1], delta[0]
        inc_main = np.array([0, sign[1]])
        inc_over = np.array([sign[0], 0])
    if denom == 0:
        return start[None, :].astype(np.int32)
    n = int(denom) + 1
    k = np.arange(n)
    num0 = denom // 2
    # overflow count after k numerator increments
    over = (num0 + k * num_add) // denom
    cells = start[None, :] + inc_main[None, :] * k[:, None] + inc_over[None, :] * over[:, None]
    return cells.astype(np.int32)


def line_cells_batch(start_idx: torch.Tensor, end_idx: torch.Tensor, max_cells: int):
    """Bresenham for batches of index pairs, static length `max_cells`.

    start_idx, end_idx: (..., 2) int32 cell indices. Returns
    ``(cells (..., max_cells, 2) int32, valid (..., max_cells) bool,
    n_real (...,))``: cells past the line's ``max(|d|) + 1`` real cells repeat
    the end cell. grid_map LineIterator parity: integer Bresenham with the
    numerator initialised to ``denom // 2``.
    """
    start_idx = start_idx.to(torch.int32)
    end_idx = end_idx.to(torch.int32)
    delta = (end_idx - start_idx).abs()
    sign = torch.where(end_idx >= start_idx, 1, -1).to(torch.int32)
    x_dom = delta[..., 0] >= delta[..., 1]
    denom = torch.where(x_dom, delta[..., 0], delta[..., 1])
    num_add = torch.where(x_dom, delta[..., 1], delta[..., 0])
    zero = torch.zeros_like(sign[..., 0])
    inc_main = torch.stack(
        [torch.where(x_dom, sign[..., 0], zero), torch.where(x_dom, zero, sign[..., 1])],
        dim=-1,
    )
    inc_over = torch.stack(
        [torch.where(x_dom, zero, sign[..., 0]), torch.where(x_dom, sign[..., 1], zero)],
        dim=-1,
    )
    k = torch.arange(max_cells, dtype=torch.int32, device=start_idx.device)
    k = k.reshape((1,) * denom.dim() + (max_cells,))
    denom_e = denom[..., None]
    num_add_e = num_add[..., None]
    safe_denom = torch.clamp_min(denom_e, 1)
    num0 = denom_e // 2
    over_before = (num0 + k * num_add_e) // safe_denom  # overflows before step k
    over_before = torch.where(k == 0, 0, over_before).to(torch.int32)
    cells = (
        start_idx[..., None, :]
        + inc_main[..., None, :] * k[..., None]
        + inc_over[..., None, :] * over_before[..., None]
    )
    valid = k < (denom_e + 1)
    n_real = denom_e[..., 0] + 1
    end_b = end_idx[..., None, :].expand_as(cells)
    cells = torch.where(valid[..., None], cells, end_b)
    return cells, valid, n_real


def _ring_edges(vertices: torch.Tensor, n_vertices):
    """Each vertex with its predecessor in the ring of the first
    `n_vertices` vertices. vertices (..., V, 2); n_vertices an int or a
    (...,) tensor. Returns (vi, vj, real): real (..., V) marks the ring's
    own edges."""
    V = vertices.shape[-2]
    idx = torch.arange(V, device=vertices.device)
    nv = torch.as_tensor(n_vertices, device=vertices.device).to(torch.int64)
    nv = nv.expand(vertices.shape[:-2])[..., None]
    jdx = torch.where(idx == 0, nv - 1, idx - 1)  # previous vertex (wraps)
    vj = torch.gather(vertices, -2, jdx[..., None].expand(vertices.shape))
    return vertices, vj, idx < nv


def polygon_contains(vertices: torch.Tensor, n_vertices, points: torch.Tensor) -> torch.Tensor:
    """Crossing-number point-in-polygon, grid_map Polygon::isInside parity,
    batched over leading dims.

    vertices: (..., V, 2), entries past `n_vertices` (an int or (...,)) are
    masked out; points: (..., K, 2). Returns (..., K) bool.
    """
    vi, vj, real = _ring_edges(vertices, n_vertices)
    px = points[..., :, None, 0]  # (..., K, 1)
    py = points[..., :, None, 1]
    xi, yi = vi[..., None, :, 0], vi[..., None, :, 1]  # (..., 1, V)
    xj, yj = vj[..., None, :, 0], vj[..., None, :, 1]
    cond = (yi > py) != (yj > py)
    denom = yj - yi
    # division-free form of px < (xj-xi)*(py-yi)/denom + xi: both sides times
    # denom, the comparison flipped for a negative denom (denom == 0 is
    # excluded by `cond`)
    lhs = (px - xi) * denom
    rhs = (xj - xi) * (py - yi)
    crossing = cond & torch.where(denom > 0.0, lhs < rhs, lhs > rhs) & real[..., None, :]
    return crossing.sum(dim=-1) % 2 == 1


def polygon_area(vertices: torch.Tensor, n_vertices) -> torch.Tensor:
    """Shoelace area with grid_map Polygon::getArea parity (absolute value),
    batched over leading dims: vertices (..., V, 2) -> (...)."""
    vi, vj, real = _ring_edges(vertices, n_vertices)
    terms = (vj[..., 0] + vi[..., 0]) * (vj[..., 1] - vi[..., 1])
    terms = torch.where(real, terms, 0.0)
    return (terms.sum(dim=-1) * 0.5).abs()


def polygon_from_circle(center: np.ndarray, radius: float, n: int = 20) -> np.ndarray:
    """grid_map Polygon::fromCircle parity: n-gon approximation (n=20)."""
    angles = np.arange(n) * (2.0 * np.pi / n)
    pts = np.stack(
        [center[0] + radius * np.cos(angles), center[1] + radius * np.sin(angles)],
        axis=-1,
    )
    return pts


def convex_hull_np(points: np.ndarray) -> np.ndarray:
    """Andrew monotone chain, grid_map parity: collinear points removed
    (cross <= 0 popped); points returned in counter-clockwise order. Inputs
    with <= 3 points are returned unchanged (grid_map does the same)."""
    pts = np.asarray(points, dtype=np.float64)
    if len(pts) <= 3:
        return pts
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    p = pts[order]

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower: list = []
    for q in p:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], q) <= 0:
            lower.pop()
        lower.append(q)
    upper: list = []
    for q in p[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], q) <= 0:
            upper.pop()
        upper.append(q)
    return np.asarray(lower[:-1] + upper[:-1])
