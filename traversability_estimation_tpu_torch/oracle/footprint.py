"""NumPy oracle for footprint/path traversability queries — the referee.

Faithful re-statement of the reference's query engine
(the reference's traversability_estimation/src/TraversabilityMap.cpp):

- per-cell veto cascade ``isTraversableForFilters`` (:774-792) with
  ``checkForSlope`` (:867), ``checkForStep`` (:794, incl. the bounded gap
  walk), ``checkForRoughness`` (:895);
- circular footprint check with grid_map SpiralIterator order, first-failure
  radius-inflation semantics and per-cell memoization (:647-746);
- polygonal footprint check via polygon rasterization (:586-645);
- path checks: circular (stride-4 line sampling, :345-462) and polygonal
  (convex hull of consecutive footprints, conservative sweep, :464-584).

Documented deviation from the reference: the length-weighted path average
used an uninitialized ``lengthPath`` for paths with >= 3 poses
(TraversabilityMap.cpp:443-448, latent UB); we keep a correct running length.

This is plain Python/NumPy, deliberately sequential where order matters; the
compute path lives in ``traversability_estimation_tpu_torch.ops``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from traversability_estimation_tpu_torch.grid.geometry import (
    circle_offsets,
    convex_hull_np,
    line_cells_np,
    polygon_from_circle,
    spiral_order,
)


@dataclasses.dataclass
class TravResult:
    """traversability_msgs/TraversabilityResult parity."""

    is_safe: bool = False
    traversability: float = 0.0
    area: float = 0.0
    untraversable_polygon: Optional[np.ndarray] = None


class OracleMap:
    """Mutable map state for the oracle: layers + query memo caches.

    Layers must include 'elevation', 'traversability', 'traversability_slope',
    'traversability_step' (+ '_roughness' if check_roughness). The memo layers
    step_footprint / slope_footprint / roughness_footprint /
    traversability_footprint are created NaN, as after computeTraversability
    (TraversabilityMap.cpp:225-228).
    """

    def __init__(
        self,
        layers: Dict[str, np.ndarray],
        resolution: float,
        position=(0.0, 0.0),
        *,
        critical_step_height: float = 0.12,
        max_gap_width: float = 0.3,
        traversability_default: float = 0.5,
        check_roughness: bool = False,
        memoize: bool = True,
    ):
        """`memoize=False` disables the reference's per-cell query memo
        caches — the referee mode for the engine's documented
        no-stale-memoization deviation (PARITY.md item 3): every circle
        check is computed fresh, so untraversable-polygon collection always
        yields true failing-cell sets (never the memo-hit 20-gon fallback,
        TraversabilityMap.cpp:673-678)."""
        self.layers = {k: np.array(v, dtype=np.float32) for k, v in layers.items()}
        shape = self.layers["elevation"].shape
        for memo in (
            "step_footprint",
            "slope_footprint",
            "roughness_footprint",
            "traversability_footprint",
        ):
            self.layers.setdefault(memo, np.full(shape, np.nan, dtype=np.float32))
        self.resolution = float(resolution)
        self.position = np.asarray(position, dtype=np.float64)
        self.rows, self.cols = shape
        self.critical_step_height = critical_step_height
        self.max_gap_width = max_gap_width
        self.traversability_default = traversability_default
        self.check_roughness = check_roughness
        self.memoize = memoize

    # -- geometry ---------------------------------------------------------
    def cell_position(self, idx) -> np.ndarray:
        i, j = int(idx[0]), int(idx[1])
        half = np.array([self.rows, self.cols]) * self.resolution / 2.0
        return self.position + half - 0.5 * self.resolution - np.array([i, j]) * self.resolution

    def index_at(self, pos) -> Optional[np.ndarray]:
        half = np.array([self.rows, self.cols]) * self.resolution / 2.0
        v = (self.position + half - np.asarray(pos, dtype=np.float64)) / self.resolution
        idx = np.floor(v).astype(int)
        return idx

    def in_map(self, idx) -> bool:
        return 0 <= idx[0] < self.rows and 0 <= idx[1] < self.cols

    def is_inside(self, pos) -> bool:
        half = np.array([self.rows, self.cols]) * self.resolution / 2.0
        t = self.position + half - np.asarray(pos, dtype=np.float64)
        return bool(np.all(t >= 0.0) and np.all(t < 2.0 * half))

    def at(self, layer, idx) -> float:
        return float(self.layers[layer][int(idx[0]), int(idx[1])])

    def set(self, layer, idx, value):
        self.layers[layer][int(idx[0]), int(idx[1])] = value

    def valid(self, layer, idx) -> bool:
        return bool(np.isfinite(self.layers[layer][int(idx[0]), int(idx[1])]))

    def circle_cells(self, center_pos, radius) -> List[np.ndarray]:
        """CircleIterator parity: cells whose center lies within `radius` of
        `center_pos` (arbitrary position), clipped to the map."""
        c_idx = self.index_at(center_pos)
        n = int(math.floor(radius / self.resolution)) + 1
        out = []
        for di in range(-n - 1, n + 2):
            for dj in range(-n - 1, n + 2):
                idx = np.array([c_idx[0] + di, c_idx[1] + dj])
                if not self.in_map(idx):
                    continue
                p = self.cell_position(idx)
                if np.sum((p - center_pos) ** 2) <= radius * radius:
                    out.append(idx)
        return out

    # -- veto cascade (TraversabilityMap.cpp:774-921) ---------------------
    def is_traversable_for_filters(self, idx) -> bool:
        if not self.check_for_slope(idx):
            return False
        if not self.check_for_step(idx):
            return False
        if self.check_roughness and not self.check_for_roughness(idx):
            return False
        return True

    def _count_veto(self, idx, layer_name, memo_name, factor) -> bool:
        layer = self.layers[layer_name]
        if layer[idx[0], idx[1]] != 0.0:  # NaN compares False -> passes
            return True
        memo = self.layers[memo_name]
        if np.isfinite(memo[idx[0], idx[1]]):
            return memo[idx[0], idx[1]] != 0.0
        window_radius = 3.0 * self.resolution
        critical_length = self.max_gap_width / 3.0
        n_critical = math.floor(
            factor * window_radius * critical_length / self.resolution**2
        )
        # Deviation (documented): cells at EXACTLY the window radius are
        # included via the static offset rule shared with the device path;
        # the C++ CircleIterator's accumulated double arithmetic tie-breaks
        # these boundary cells unpredictably.
        n = 0
        for di, dj in circle_offsets(window_radius, self.resolution):
            cidx = (idx[0] + di, idx[1] + dj)
            if not self.in_map(cidx):
                continue
            if layer[cidx[0], cidx[1]] == 0.0:
                n += 1
            if n > n_critical:
                memo[idx[0], idx[1]] = 0.0
                return False
        memo[idx[0], idx[1]] = 1.0
        return True

    def check_for_slope(self, idx) -> bool:
        return self._count_veto(idx, "traversability_slope", "slope_footprint", 2.0)

    def check_for_roughness(self, idx) -> bool:
        return self._count_veto(
            idx, "traversability_roughness", "roughness_footprint", 1.5
        )

    def check_for_step(self, idx) -> bool:
        """TraversabilityMap.cpp:794-865 — the bounded gap walk."""
        step = self.layers["traversability_step"]
        if step[idx[0], idx[1]] != 0.0:
            return True
        memo = self.layers["step_footprint"]
        if np.isfinite(memo[idx[0], idx[1]]):
            return memo[idx[0], idx[1]] != 0.0

        res = self.resolution
        window_radius = 2.5 * res
        center = self.cell_position(idx)
        height = self.at("elevation", idx)
        candidates = []
        for di, dj in circle_offsets(window_radius, res):
            cidx = np.array([idx[0] + di, idx[1] + dj])
            if not self.in_map(cidx):
                continue
            if (
                self.at("elevation", cidx) > self.critical_step_height + height
                and step[cidx[0], cidx[1]] == 0.0
            ):
                candidates.append(cidx)
        if not candidates:
            candidates.append(np.array(idx))

        for cand in candidates:
            submap_pos = self.cell_position(cand)
            to_center = center - submap_pos
            # the reference reassigns `height` to the candidate's elevation
            # (TraversabilityMap.cpp:823); drop, wall, and gap thresholds are
            # all relative to the candidate, not the query cell
            h = self.at("elevation", cand)
            # submap of length 2.5res x 2.5res centered at cand -> 3x3 window
            for di in (-1, 0, 1):
                for dj in (-1, 0, 1):
                    s = np.array([cand[0] + di, cand[1] + dj])
                    if not self.in_map(s):
                        continue
                    if not (
                        step[s[0], s[1]] == 0.0
                        and self.at("elevation", s) < h - self.critical_step_height
                    ):
                        continue
                    if math.hypot(di, dj) * res < 0.025:
                        continue
                    # toCenter . vec = -res^2 * (o . d) with o = cand - idx:
                    # evaluated exactly in integers (the C++ computes it from
                    # float position differences, which tie-breaks the
                    # mathematically-perpendicular case unpredictably)
                    o = np.asarray(cand) - np.asarray(idx)
                    if np.linalg.norm(to_center) > 0.025 and (o[0] * di + o[1] * dj) > 0:
                        continue
                    # Walk bound in integer cells (same rule as the device
                    # path): largest m with (m+1)*|d|*res < max_gap_width,
                    # clipped at the map edge. Deviation (documented): the
                    # C++ accumulates `pos += vec` in doubles and re-floors,
                    # which can land one cell off at exact edge crossings.
                    d = np.array([di, dj])
                    step_len = math.hypot(di, dj) * res
                    k_max = max(1, math.ceil(self.max_gap_width / step_len - 1e-12) - 1)
                    m = 1
                    while m < k_max and self.in_map(np.asarray(cand) + d * (m + 1)):
                        m += 1
                    end_idx = np.asarray(cand) + d * m
                    gap_start = False
                    gap_end = False
                    for cell in line_cells_np(cand, end_idx):
                        e = self.at("elevation", cell)
                        if e > h + self.critical_step_height:
                            memo[idx[0], idx[1]] = 0.0
                            return False
                        if (e < h - self.critical_step_height) or not np.isfinite(e):
                            gap_start = True
                        elif gap_start:
                            gap_end = True
                            break
                    if gap_start and not gap_end:
                        memo[idx[0], idx[1]] = 0.0
                        return False
        memo[idx[0], idx[1]] = 1.0
        return True

    # -- circular footprint (TraversabilityMap.cpp:647-746) ---------------
    def is_traversable_circle(
        self, center, radius_max, radius_min=0.0, compute_untraversable=False
    ) -> Tuple[bool, float, Optional[np.ndarray]]:
        """Returns (is_traversable, traversability, untraversable_hull).

        Radius-inflation semantics (radius_min > 0, first spiral failure at
        r > radius_min): we implement the INTENDED behavior — verdict
        traversable with traversability = running_mean * factor, where
        factor = ((r - rMin)/(rMax - rMin) + 1)/2. The reference's code has
        two inconsistent bugs here (TraversabilityMap.cpp:705-717,732-735):
        with computeUntraversablePolygon=false it writes that positive memo
        but returns false for the first query (later queries hit the memo and
        return true); with =true it divides by nCells twice. Documented
        deviation: we always return (true, mean * factor).
        """
        center = np.asarray(center, dtype=np.float64)
        if not self.is_inside(center):
            t = self.traversability_default
            hull = None
            if compute_untraversable and t == 0.0:
                # off-map failure publishes the circle outline
                # (TraversabilityMap.cpp:662-667)
                hull = polygon_from_circle(center, radius_max)
            return t != 0.0, t, hull
        idx_center = self.index_at(center)
        memo = self.layers["traversability_footprint"]
        if self.memoize and np.isfinite(memo[idx_center[0], idx_center[1]]):
            t = float(memo[idx_center[0], idx_center[1]])
            hull = None
            if compute_untraversable and t == 0.0:
                # memo-hit failure publishes the circle outline instead of
                # failing cells (TraversabilityMap.cpp:673-678,700-703)
                hull = polygon_from_circle(center, radius_max)
            return t != 0.0, t, hull

        n_cells = 0
        traversability = 0.0
        untraversable_positions = []
        circle_ok = True
        offsets, rings = spiral_order(radius_max, self.resolution)
        n_rings = int(math.ceil(radius_max / self.resolution - 1e-12))
        trav_layer = self.layers["traversability"]
        for off, ring in zip(offsets, rings):
            cidx = np.array([idx_center[0] + off[0], idx_center[1] + off[1]])
            if not self.in_map(cidx):
                continue
            if ring >= n_rings - 1:
                # outermost two rings: true Euclidean check vs query center
                p = self.cell_position(cidx)
                if np.sum((p - center) ** 2) > radius_max * radius_max:
                    continue
            ok = self.is_traversable_for_filters(cidx)
            if not ok:
                r = float(np.linalg.norm(off.astype(np.float64))) * self.resolution
                if radius_min == 0.0:
                    memo[idx_center[0], idx_center[1]] = 0.0
                    circle_ok = False
                    untraversable_positions.append(self.cell_position(cidx))
                else:
                    if r <= radius_min:
                        memo[idx_center[0], idx_center[1]] = 0.0
                        circle_ok = False
                        untraversable_positions.append(self.cell_position(cidx))
                    elif circle_ok:
                        factor = ((r - radius_min) / (radius_max - radius_min) + 1.0) / 2.0
                        traversability *= factor / n_cells
                        memo[idx_center[0], idx_center[1]] = np.float32(traversability)
                        return True, traversability, None
                if not compute_untraversable:
                    return False, traversability, None
            else:
                n_cells += 1
                if not np.isfinite(trav_layer[cidx[0], cidx[1]]):
                    traversability += self.traversability_default
                else:
                    traversability += float(trav_layer[cidx[0], cidx[1]])

        hull = None
        if compute_untraversable and not circle_ok and untraversable_positions:
            hull = convex_hull_np(np.array(untraversable_positions))
        if circle_ok:
            traversability /= n_cells
            memo[idx_center[0], idx_center[1]] = np.float32(traversability)
        return circle_ok, traversability, hull

    # -- polygonal footprint (TraversabilityMap.cpp:586-645) --------------
    def is_traversable_polygon(
        self, vertices: np.ndarray, compute_untraversable=False
    ) -> Tuple[bool, float, Optional[np.ndarray]]:
        verts = np.asarray(vertices, dtype=np.float64)
        n_cells = 0
        traversability = 0.0
        ok = True
        untraversable_positions = []
        trav_layer = self.layers["traversability"]
        # PolygonIterator: bounding box cells whose center is inside polygon
        mins = verts.min(axis=0)
        maxs = verts.max(axis=0)
        # indices covering the bounding box (clipped)
        top = self.index_at(maxs)
        bot = self.index_at(mins)
        i0, i1 = max(0, top[0]), min(self.rows - 1, bot[0])
        j0, j1 = max(0, top[1]), min(self.cols - 1, bot[1])
        for i in range(i0, i1 + 1):
            for j in range(j0, j1 + 1):
                p = self.cell_position((i, j))
                if not _point_in_polygon(verts, p):
                    continue
                if not self.is_traversable_for_filters((i, j)):
                    ok = False
                    if compute_untraversable:
                        untraversable_positions.append(p)
                    else:
                        return False, 0.0, None
                else:
                    n_cells += 1
                    if not np.isfinite(trav_layer[i, j]):
                        traversability += self.traversability_default
                    else:
                        traversability += float(trav_layer[i, j])
        if ok:
            if n_cells == 0:
                traversability = self.traversability_default
                ok = self.traversability_default != 0.0
            else:
                traversability /= n_cells
        hull = None
        if compute_untraversable and not ok and untraversable_positions:
            hull = convex_hull_np(np.array(untraversable_positions))
        return ok, traversability, hull

    # -- path checks (TraversabilityMap.cpp:320-584) -----------------------
    def check_circular_footprint_path(
        self, poses_xy: np.ndarray, radius: float, offset: float = 0.15,
        compute_untraversable: bool = False,
    ) -> TravResult:
        result = TravResult()
        poses = np.asarray(poses_xy, dtype=np.float64).reshape(-1, 2)
        n = len(poses)
        if n == 0:
            return result
        if n == 1:
            ok, trav, hull = self.is_traversable_circle(
                poses[0], radius + offset, radius, compute_untraversable
            )
            if not ok:
                result.untraversable_polygon = hull
                return result
            result.is_safe = True
            result.traversability = trav
            return result

        length_path = 0.0
        accumulated: list = []  # untraversable hull vertices across samples
        for i in range(1, n):
            start, end = poses[i - 1], poses[i]
            start_idx = self.index_at(start)
            end_idx = self.index_at(end)
            cells = line_cells_np(end_idx, start_idx)  # end -> start, reference order
            trav_sum, n_line = 0.0, 0
            seg_ok = True
            k = 0
            while k < len(cells):
                center = self.cell_position(cells[k])
                ok, trav, hull = self.is_traversable_circle(
                    center, radius + offset, radius, compute_untraversable
                )
                seg_ok = seg_ok and ok
                if not seg_ok and not compute_untraversable:
                    return result
                if compute_untraversable and hull is not None and len(hull):
                    # convexHull(accumulated, aux) per sample == hull of the
                    # union of vertices (TraversabilityMap.cpp:410-412)
                    accumulated.extend(np.asarray(hull))
                trav_sum += trav
                n_line += 1
                k += 4  # nSkip = 3 (TraversabilityMap.cpp:401,421-425)
            if not seg_ok:
                if accumulated:
                    result.untraversable_polygon = convex_hull_np(
                        np.asarray(accumulated)
                    )
                return result
            seg_trav = trav_sum / n_line
            seg_len = float(np.linalg.norm(end - start))
            # deviation from reference: correct running path length (the C++
            # reads an uninitialized local for >= 3 poses)
            prev_len = length_path
            length_path += seg_len
            if i > 1:
                result.traversability = (
                    seg_len * seg_trav + prev_len * result.traversability
                ) / length_path
            else:
                result.traversability = seg_trav
        result.is_safe = True
        return result

    def check_polygonal_footprint_path(
        self,
        poses_xyz: np.ndarray,
        quats_xyzw: np.ndarray,
        footprint_xy: np.ndarray,
        conservative: bool = False,
        compute_untraversable: bool = False,
    ) -> TravResult:
        result = TravResult()
        poses = np.asarray(poses_xyz, dtype=np.float64).reshape(-1, 3)
        quats = np.asarray(quats_xyzw, dtype=np.float64).reshape(-1, 4)
        fp = np.asarray(footprint_xy, dtype=np.float64).reshape(-1, 2)
        n = len(poses)
        if n == 0:
            return result

        def transformed(i):
            R = _quat_to_rot(quats[i])
            pts3 = np.concatenate([fp, np.zeros((len(fp), 1))], axis=1)
            world = (R @ pts3.T).T + poses[i]
            return world[:, :2]

        prev_poly = None
        prev_area = 0.0
        for i in range(n):
            poly2 = transformed(i)
            end = poses[i][:2]
            if conservative and i > 0:
                start = poses[i - 1][:2]
                d = end - start
                poly1 = np.concatenate([transformed(i - 1), poly2 - d], axis=0)
                poly2 = np.concatenate([poly2, transformed(i - 1) + d], axis=0)
            else:
                poly1 = transformed(i - 1) if i > 0 else None

            if n == 1:
                ok, trav, hull = self.is_traversable_polygon(poly2, compute_untraversable)
                if not ok:
                    result.untraversable_polygon = hull
                    return result
                result.is_safe = True
                result.traversability = trav
                result.area = _shoelace_area(poly2)
                return result

            if i > 0:
                hull_poly = convex_hull_np(np.concatenate([poly1, poly2], axis=0))
                ok, trav, hull = self.is_traversable_polygon(
                    hull_poly, compute_untraversable
                )
                if not ok:
                    result.untraversable_polygon = hull
                    return result
                hull_area = _shoelace_area(hull_poly)
                # grid_map Polygon::getArea is shoelace over the stored vertex
                # order (TraversabilityMap.cpp:572 uses polygon1 as built)
                poly1_area = _shoelace_area(poly1)
                if i > 1:
                    area_prev_total = result.area
                    area_new = hull_area - poly1_area
                    result.area += area_new
                    result.traversability = (
                        area_new * trav + area_prev_total * result.traversability
                    ) / result.area
                else:
                    result.area = hull_area
                    result.traversability = trav
        result.is_safe = True
        return result


def _point_in_polygon(verts: np.ndarray, p: np.ndarray) -> bool:
    """grid_map Polygon::isInside crossing-number parity."""
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


def _shoelace_area(verts: np.ndarray) -> float:
    v = np.asarray(verts, dtype=np.float64)
    j = np.roll(np.arange(len(v)), 1)
    return float(abs(np.sum((v[j, 0] + v[:, 0]) * (v[j, 1] - v[:, 1])) / 2.0))


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0.0 else 2.0 / n
    return np.array(
        [
            [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
            [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
            [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
        ]
    )
