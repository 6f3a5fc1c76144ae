"""Untraversable-polygon extraction — reference-parity diagnostics.

The reference collects the positions of the untraversable cells a failed
footprint check actually visited and publishes their convex hull
(TraversabilityMap.cpp:634-642 for polygons, :697-737 for circles, :410-412 accumulated across a
circular path, :923-943 publication). This module reproduces those cell
sets exactly against the engine's dense veto plane (verdict-equivalent to
the reference's lazy per-cell cascade), on the host in float64 like the
C++: the estimator hands it one host copy of the plane per map epoch.

It runs only for FAILED paths that set compute_untraversable_polygon, so
it is cold-path by construction (the reference also pays this only on
demand).

Documented deviation (PARITY.md): the reference's per-cell memo can replace
a later sample's failing-cell set with a 20-gon circle (memo-hit 0 ->
Polygon::fromCircle, TraversabilityMap.cpp:673-678); with no stale
memoization here, every sample contributes its true failing-cell set.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from traversability_estimation_tpu_torch.grid.geometry import (
    convex_hull_np,
    line_cells_np,
    polygon_from_circle,
    spiral_order,
)


class _Grid:
    """grid_map index math over the dense fail plane (float64, host)."""

    def __init__(self, fail_mask: np.ndarray, resolution: float, position):
        self.fail = np.asarray(fail_mask, bool)
        self.rows, self.cols = self.fail.shape
        self.res = float(resolution)
        self.position = np.asarray(position, np.float64)
        self.half = np.array([self.rows, self.cols]) * self.res / 2.0
        self.p0 = self.position + self.half

    def index_at(self, pos):
        return np.floor((self.p0 - np.asarray(pos, np.float64)) / self.res).astype(int)

    def cell_position(self, idx):
        # expression order matters: p0 - 0.5*res - idx*res rounds differently
        # from p0 - (idx+0.5)*res in float64, and exact-collinearity
        # tie-breaks in the final hull depend on it (oracle parity)
        return self.p0 - 0.5 * self.res - np.asarray(idx, np.float64) * self.res

    def is_inside(self, pos):
        t = self.p0 - np.asarray(pos, np.float64)
        return bool(np.all(t >= 0.0) and np.all(t < 2.0 * self.half))


def _spiral_collect(
    grid: _Grid, center, radius_max: float, radius_min: float, default: float
) -> tuple:
    """One circle check's collection pass (TraversabilityMap.cpp:688-737).

    Returns (hard_fail, positions): positions are the failing cells with
    radius <= radius_min the walk pushes; the walk runs to the end of the
    spiral once a hard failure exists (no early inflation stop can follow,
    since the inflation branch requires a still-traversable circle).
    An off-map center with default == 0 fails with the 20-gon circle
    outline instead (TraversabilityMap.cpp:662-667,700).
    """
    center = np.asarray(center, np.float64)
    if not grid.is_inside(center):
        if default == 0.0:
            return True, list(polygon_from_circle(center, radius_max))
        return False, []
    idxc = grid.index_at(center)
    offs, rings = spiral_order(radius_max, grid.res)
    n_rings = int(math.ceil(radius_max / grid.res - 1e-12))

    cells = idxc[None, :] + offs
    inmap = (
        (cells[:, 0] >= 0)
        & (cells[:, 0] < grid.rows)
        & (cells[:, 1] >= 0)
        & (cells[:, 1] < grid.cols)
    )
    pos = grid.p0[None, :] - 0.5 * grid.res - cells.astype(np.float64) * grid.res
    d2 = np.sum((pos - center[None, :]) ** 2, axis=1)
    outer = rings >= max(n_rings - 1, 0)
    active = inmap & np.where(outer, d2 <= radius_max * radius_max, True)
    fails = np.zeros(len(offs), bool)
    fails[active] = grid.fail[cells[active, 0], cells[active, 1]]
    if not fails.any():
        return False, []
    r = np.linalg.norm(offs.astype(np.float64), axis=1) * grid.res
    first = int(np.argmax(fails))
    if radius_min > 0.0 and r[first] > radius_min:
        # first failure beyond radius_min: inflation pass, nothing collected
        return False, []
    collect = fails & ((r <= radius_min) | (radius_min == 0.0))
    return True, [pos[k] for k in np.nonzero(collect)[0]]


def _poses_xy_z(poses) -> tuple:
    """Split (N, 2) or (N, 3) poses into (N, 2) xy + mean z (robotHeight,
    computeMeanHeightFromPoses, TraversabilityMap.hpp:311)."""
    p = np.asarray(poses, np.float64)
    p = p.reshape(-1, p.shape[-1])
    if p.shape[-1] >= 3:
        return p[:, :2], float(p[:, 2].mean())
    return p, 0.0


def circular_path_polygons(
    fail_mask: np.ndarray,
    resolution: float,
    position,
    poses: np.ndarray,
    radius: float,
    offset: float,
    default: float,
) -> tuple:
    """Publication streams of a circular path check with publishPolygons
    (TraversabilityMap.cpp:345-462): returns (footprints, untraversables,
    robot_height) where footprints has one 20-gon circle outline
    ``fromCircle(end, radius + offset)`` per evaluated pose (published at
    z = 0, :373-376,:427-431) and untraversables has, per evaluated segment,
    the ACCUMULATED failing-cell hull so far (published at z = robot_height,
    :379,:436; empty accumulations are skipped, :934-936). Evaluation stops
    after the first failing segment, like the reference's early return.
    """
    grid = _Grid(fail_mask, resolution, position)
    xy, robot_height = _poses_xy_z(poses)
    rmax, rmin = radius + offset, radius
    footprints: List[np.ndarray] = []
    untraversables: List[np.ndarray] = []
    collected: List[np.ndarray] = []
    if len(xy) == 1:
        footprints.append(polygon_from_circle(xy[0], rmax))
        _, pts = _spiral_collect(grid, xy[0], rmax, rmin, default)
        if pts:
            untraversables.append(convex_hull_np(np.asarray(pts)))
        return footprints, untraversables, robot_height
    for i in range(1, len(xy)):
        start, end = xy[i - 1], xy[i]
        cells = line_cells_np(grid.index_at(end), grid.index_at(start))
        seg_failed = False
        for k in range(0, len(cells), 4):  # nSkip = 3
            center = grid.cell_position(cells[k])
            hard, pts = _spiral_collect(grid, center, rmax, rmin, default)
            seg_failed = seg_failed or hard
            if pts:
                # accumulate per-SAMPLE hull vertices, not raw points: the
                # reference hulls each sample's cells before merging
                # (TraversabilityMap.cpp:410-412), and on exactly-collinear
                # grid points the float64 tie-break makes hull(hulls) and
                # hull(raw union) keep different (equal-region) vertex sets
                collected.extend(convex_hull_np(np.asarray(pts)))
        footprints.append(polygon_from_circle(end, rmax))
        if collected:
            untraversables.append(convex_hull_np(np.asarray(collected)))
        if seg_failed:
            break
    return footprints, untraversables, robot_height


def circular_path_untraversable_polygon(
    fail_mask: np.ndarray,
    resolution: float,
    position,
    poses_xy: np.ndarray,
    radius: float,
    offset: float,
    default: float,
) -> Optional[np.ndarray]:
    """Untraversable polygon of a FAILED circular path
    (TraversabilityMap.cpp:345-462 with computeUntraversablePolygon):
    failing cells are accumulated across every stride-4 line sample of every
    segment up to and including the first failing segment; the result is
    their convex hull (convexHull of hulls == hull of the union, :410-412).
    Single-pose paths collect from the one spiral walk. Returns (K, 2)
    positions or None when nothing was collected.
    """
    _, untraversables, _ = circular_path_polygons(
        fail_mask, resolution, position, poses_xy, radius, offset, default
    )
    return untraversables[-1] if untraversables else None


def _point_in_polygon(verts: np.ndarray, p) -> bool:
    """Crossing-number test, grid_map Polygon::isInside parity (float64)."""
    n = len(verts)
    inside = False
    j = n - 1
    for i in range(n):
        yi, yj = verts[i][1], verts[j][1]
        if (yi > p[1]) != (yj > p[1]):
            xint = (verts[j][0] - verts[i][0]) * (p[1] - yi) / (yj - yi) + verts[i][0]
            if p[0] < xint:
                inside = not inside
        j = i
    return inside


def _polygon_cells(grid: _Grid, verts: np.ndarray) -> tuple:
    """(inside_cell_count, failing cell positions) inside a polygon
    (PolygonIterator parity: bounding-box cells whose center the crossing
    test includes, TraversabilityMap.cpp:600-612). The count feeds the
    0-cells verdict rule (:625-631): an empty polygon fails iff
    traversability_default == 0."""
    verts = np.asarray(verts, np.float64)
    top = grid.index_at(verts.max(axis=0))
    bot = grid.index_at(verts.min(axis=0))
    i0, i1 = max(0, top[0]), min(grid.rows - 1, bot[0])
    j0, j1 = max(0, top[1]), min(grid.cols - 1, bot[1])
    n_inside = 0
    out = []
    for i in range(i0, i1 + 1):
        for j in range(j0, j1 + 1):
            p = grid.cell_position((i, j))
            if not _point_in_polygon(verts, p):
                continue
            n_inside += 1
            if grid.fail[i, j]:
                out.append(p)
    return n_inside, out


def _quat_to_rot(q) -> np.ndarray:
    x, y, z, w = (float(v) for v in q)
    n = x * x + y * y + z * z + w * w
    s = 2.0 / n if n > 0.0 else 0.0
    return np.array(
        [
            [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
            [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
            [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
        ]
    )


def polygonal_path_polygons(
    fail_mask: np.ndarray,
    resolution: float,
    position,
    poses_xyz: np.ndarray,
    quats_xyzw: Optional[np.ndarray],
    footprint_xy: np.ndarray,
    conservative: bool,
    default: float = 0.5,
) -> tuple:
    """Publication streams of a polygonal path check with publishPolygons
    (TraversabilityMap.cpp:464-584): returns (footprints, untraversables,
    robot_height). footprints has the transformed footprint for single-pose
    paths (published at z = 0, :529) or one consecutive-footprint hull per
    evaluated segment (published at z = robot_height, :558); untraversables
    has the failing-cell hull of a failing polygon (empty ones are skipped
    at publication, :934-936 — a safe polygon never collects cells).
    Evaluation stops after the first failing segment (:565-568); a segment
    with zero inside cells fails iff traversability_default == 0 (:625-631).
    """
    grid = _Grid(fail_mask, resolution, position)
    poses = np.asarray(poses_xyz, np.float64)
    poses = poses.reshape(-1, poses.shape[-1])
    _, robot_height = _poses_xy_z(poses)
    fp = np.asarray(footprint_xy, np.float64).reshape(-1, 2)
    n = len(poses)
    if quats_xyzw is None:
        quats = np.tile(np.array([0.0, 0.0, 0.0, 1.0]), (n, 1))
    else:
        quats = np.asarray(quats_xyzw, np.float64).reshape(-1, 4)

    def transformed(i):
        R = _quat_to_rot(quats[i])
        pts3 = np.concatenate([fp, np.zeros((len(fp), 1))], axis=1)
        pos3 = poses[i] if poses.shape[-1] >= 3 else np.array([*poses[i], 0.0])
        return ((R @ pts3.T).T + pos3)[:, :2]

    footprints: List[np.ndarray] = []
    untraversables: List[np.ndarray] = []
    if n == 1:
        poly = transformed(0)
        footprints.append(poly)
        _, pts = _polygon_cells(grid, poly)
        if pts:
            untraversables.append(convex_hull_np(np.asarray(pts)))
        return footprints, untraversables, robot_height

    for i in range(1, n):
        poly1 = transformed(i - 1)
        poly2 = transformed(i)
        if conservative:
            d = poses[i][:2] - poses[i - 1][:2]
            poly1c = np.concatenate([poly1, poly2 - d], axis=0)
            poly2c = np.concatenate([poly2, poly1 + d], axis=0)
            hull = convex_hull_np(np.concatenate([poly1c, poly2c], axis=0))
        else:
            hull = convex_hull_np(np.concatenate([poly1, poly2], axis=0))
        footprints.append(hull)
        n_inside, pts = _polygon_cells(grid, hull)
        if pts:
            untraversables.append(convex_hull_np(np.asarray(pts)))
            break
        if n_inside == 0 and default == 0.0:
            break
    return footprints, untraversables, robot_height


def polygonal_path_untraversable_polygon(
    fail_mask: np.ndarray,
    resolution: float,
    position,
    poses_xyz: np.ndarray,
    quats_xyzw: Optional[np.ndarray],
    footprint_xy: np.ndarray,
    conservative: bool,
    default: float = 0.5,
) -> Optional[np.ndarray]:
    """Untraversable polygon of a FAILED polygonal path
    (TraversabilityMap.cpp:464-584): the hull of the failing cells inside
    the FIRST failing segment's consecutive-footprint hull (the reference
    returns right after that segment, :565-568); single-pose paths use the
    transformed footprint itself. Returns (K, 2) or None.
    """
    _, untraversables, _ = polygonal_path_polygons(
        fail_mask, resolution, position, poses_xyz, quats_xyzw, footprint_xy,
        conservative, default,
    )
    return untraversables[-1] if untraversables else None
