"""TraversabilityEstimator: map update, query state, circular and polygonal
path checks, and the dense footprint services.

A plain class holding tensors on one device. ``update`` runs the fused map
update (kernel 1 on CUDA); circular path queries read the dense circle
field of the current map epoch (kernel 2 on CUDA), cached per (radius,
offset) until the next update; polygonal path batches are dispatched from
host-visible batch statistics to the grouped (one window per path) or the
per-segment evaluator. Untraversable polygons and the inclination check are
later slices of the port and raise NotImplementedError naming their ROADMAP
item.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from traversability_estimation_tpu_torch.device import DeviceLike, resolve_device
from traversability_estimation_tpu_torch.grid.gridmap import GridMap
from traversability_estimation_tpu_torch.ops import footprint as fp_ops
from traversability_estimation_tpu_torch.ops.field_kernel import dense_circle_field
from traversability_estimation_tpu_torch.ops.update_kernel import fused_update
from traversability_estimation_tpu_torch.utils.config import EstimatorConfig

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class FootprintPath:
    """traversability_msgs/FootprintPath."""

    poses: np.ndarray  # (N, 2) or (N, 3) positions
    orientations: Optional[np.ndarray] = None  # (N, 4) xyzw quaternions
    radius: float = 0.0
    footprint: Optional[np.ndarray] = None  # (V, 2) polygon in the base frame
    conservative: bool = False
    compute_untraversable_polygon: bool = False


@dataclasses.dataclass
class TraversabilityResult:
    """traversability_msgs/TraversabilityResult."""

    is_safe: bool = False
    traversability: float = 0.0
    area: float = 0.0
    untraversable_polygon: Optional[np.ndarray] = None


def _pose_crop_geometry(flat_xy, margin, H, W, res, p0, bucket):
    """Bucketed query crop covering every pose's `margin` reach: its shape is
    rounded up to `bucket` multiples and pulled back inside the (H, W) map;
    an entirely off-map batch gets a minimal corner crop.

    flat_xy: (K, 2) pose positions; p0: map-frame origin corner (float64).
    Returns (i_lo, j_lo, hc, wc, crop_center_position (2,) f32).
    """
    i_lo = max(int(np.floor((p0[0] - (flat_xy[:, 0].max() + margin)) / res)), 0)
    i_hi = min(int(np.floor((p0[0] - (flat_xy[:, 0].min() - margin)) / res)) + 1, H)
    j_lo = max(int(np.floor((p0[1] - (flat_xy[:, 1].max() + margin)) / res)), 0)
    j_hi = min(int(np.floor((p0[1] - (flat_xy[:, 1].min() - margin)) / res)) + 1, W)
    if i_hi <= i_lo or j_hi <= j_lo:
        i_lo, j_lo, i_hi, j_hi = 0, 0, min(64, H), min(64, W)
    hc = min(((i_hi - i_lo + bucket - 1) // bucket) * bucket, H)
    wc = min(((j_hi - j_lo + bucket - 1) // bucket) * bucket, W)
    i_lo = min(i_lo, H - hc)
    j_lo = min(j_lo, W - wc)
    qpos = np.array(
        [p0[0] - (i_lo + hc / 2.0) * res, p0[1] - (j_lo + wc / 2.0) * res],
        np.float32,
    )
    return i_lo, j_lo, hc, wc, qpos


# one fetched window per path costs gwi*gwj*P floats; past this budget the
# per-segment evaluator (windows sized to one segment) is the better trade
_GROUPED_ELEMS_CAP = 32_000_000


def _dispatch_polygonal(
    query_state, pos3, quats, n_poses, fp, resolution, conservative, identity,
    stats_out: Optional[dict] = None,
):
    """Pick the grouped (per-path window) or the per-segment polygonal
    evaluator from host-visible batch statistics; returns (safe, trav, area)
    tensors on the query state's device.

    pos3, quats, fp are host arrays: the window planners read them here, and
    the evaluator uploads them once. When `stats_out` is given it is filled
    with which evaluator ran and why: the slower per-segment evaluator (a
    non-convex footprint, a per-path window past ``_GROUPED_ELEMS_CAP``) is
    silent in the results."""
    convex = fp_ops.is_convex_polygon(fp)
    translate_only = identity and not conservative and convex
    ext = pos3[..., :2].max(axis=1) - pos3[..., :2].min(axis=1)  # (P, 2)
    if identity:
        gw = fp_ops.path_group_window(fp, ext, resolution, True)
    else:
        # rotated batches: the exact per-path vertex bbox from the realised
        # yaws, not pose extent + worst-case circumradius
        gw = fp_ops.path_group_window_exact(fp, pos3, quats, resolution)
    B = pos3.shape[0]
    # block-window mode, per-(path, 8-segment-block) windows: the middle tier
    # when the per-path window exceeds the cap (long paths) and the block
    # window does not
    bw = fp_ops.path_block_window(fp, pos3, resolution, identity)
    use_blocks = (
        pos3.shape[1] > 2
        and gw[0] * gw[1] * B > _GROUPED_ELEMS_CAP
        and bw[0] * bw[1] * B <= _GROUPED_ELEMS_CAP
    )
    eff_w = bw if use_blocks else gw
    grouped = convex and eff_w[0] * eff_w[1] * B <= _GROUPED_ELEMS_CAP
    if stats_out is not None:
        stats_out.update(
            evaluator="grouped" if grouped else "per_segment",
            reason=(
                "ok" if grouped
                else ("non_convex_footprint" if not convex else "window_cap")
            ),
            paths=int(B),
            translate_only=bool(translate_only),
            group_window=(int(gw[0]), int(gw[1])),
            block_window=(int(bw[0]), int(bw[1])) if use_blocks else None,
            group_window_elems=int(eff_w[0] * eff_w[1] * B),
        )
    if grouped:
        return fp_ops.check_polygonal_paths_grouped(
            query_state, pos3, quats, n_poses, fp, gw, bool(conservative), translate_only,
            bw if use_blocks else None,
        )
    seg = np.linalg.norm(np.diff(pos3[..., :2], axis=1), axis=-1)
    seg_max = float(seg.max()) if seg.size else 0.0
    window = fp_ops.polygon_window_cells(
        fp, seg_max, resolution, conservative, identity_orientation=identity
    )
    return fp_ops.check_polygonal_paths(
        query_state, pos3, quats, n_poses, fp, window, bool(conservative), translate_only
    )


class TraversabilityEstimator:
    def __init__(self, config: Optional[EstimatorConfig] = None, device: DeviceLike = None):
        self.config = config or EstimatorConfig()
        self.device = resolve_device(device)
        self._map: Optional[GridMap] = None
        self._query_state: Optional[fp_ops.QueryState] = None
        self._field_cache: Dict[tuple, tuple] = {}
        self._elevation: Optional[torch.Tensor] = None
        self._extra_layers: Dict[str, torch.Tensor] = {}
        self._position = np.zeros(2, dtype=np.float32)
        self._traversability_default = self.config.footprint.traversability_default
        self.initialized = False
        self.last_update_seconds: float = float("nan")
        self.last_footprint_seconds: float = float("nan")
        # which polygonal evaluator ran last, and per-estimator totals
        self.last_polygonal_dispatch: Dict = {}
        self.polygonal_dispatch_counts: Dict[str, int] = {}

    def _plane(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(
            np.array(a, dtype=np.float32), dtype=torch.float32, device=self.device
        )

    # ------------------------------------------------------------------
    # ingestion and update
    # ------------------------------------------------------------------
    def set_elevation_map(
        self,
        elevation,
        position=(0.0, 0.0),
        extra_layers: Optional[Dict[str, np.ndarray]] = None,
    ) -> bool:
        """TraversabilityMap::setElevationMap: adopt an (H, W) elevation plane
        (NaN unknown) centred at `position`."""
        self._elevation = self._plane(elevation)
        self._position = np.asarray(position, dtype=np.float32)
        self._extra_layers = {k: self._plane(v) for k, v in (extra_layers or {}).items()}
        return True

    def update(self, elevation=None, position=None) -> bool:
        """Run the filter chain + dense veto fields and swap in the new map
        (computeTraversability)."""
        if elevation is not None:
            self.set_elevation_map(
                elevation, position if position is not None else self._position
            )
        if self._elevation is None:
            return False
        t0 = time.perf_counter()
        layers = fused_update(self._elevation, self.config.chain, self.config.veto)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_update_seconds = time.perf_counter() - t0

        all_layers = {"elevation": self._elevation, **layers}
        for k, v in self._extra_layers.items():
            all_layers.setdefault(k, v)
        if "upper_bound" in all_layers and "lower_bound" in all_layers:
            all_layers["uncertainty_range"] = (
                all_layers["upper_bound"] - all_layers["lower_bound"]
            )
        position = torch.as_tensor(self._position, dtype=torch.float32, device=self.device)
        self._map = GridMap(
            layers=all_layers,
            resolution=self.config.chain.resolution,
            position=position,
            frame_id=self.config.map_frame_id,
        )
        self._query_state = fp_ops.QueryState(
            traversability=all_layers["traversability"],
            traversable_mask=layers["traversable_mask"],
            position=position,
            resolution=self.config.chain.resolution,
            default_traversability=self._traversability_default,
        )
        # a new map epoch invalidates the cached dense circle fields
        self._field_cache.clear()
        self.initialized = True
        return True

    @property
    def traversability_map(self) -> GridMap:
        if self._map is None:
            raise RuntimeError("traversability map not initialized; call update()")
        return self._map

    @property
    def query_state(self) -> fp_ops.QueryState:
        if self._query_state is None:
            raise RuntimeError("traversability map not initialized; call update()")
        return self._query_state

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def check_footprint_path(
        self, paths: Sequence[FootprintPath] | FootprintPath
    ) -> List[TraversabilityResult]:
        """check_footprint_path service: each path checked independently,
        circular when it has no polygon. Paths are batched per radius, or per
        (footprint, conservative), and dispatched to the batch evaluators."""
        if isinstance(paths, FootprintPath):
            paths = [paths]
        results = [TraversabilityResult() for _ in paths]
        if not self.initialized:
            return results
        circular: Dict[float, List[int]] = {}
        # ragged pose counts pad to a bucketed common N (repeat the last
        # pose, masked by n_poses), so grouping is by footprint alone
        polygonal: Dict[tuple, List[int]] = {}
        for i, p in enumerate(paths):
            if p.compute_untraversable_polygon:
                raise NotImplementedError(
                    "untraversable polygons are not ported yet (ROADMAP A16)"
                )
            poses = np.atleast_2d(np.asarray(p.poses, dtype=np.float32))
            if poses.shape[0] == 0 or poses.size == 0:
                continue
            if p.footprint is None or len(p.footprint) == 0:
                circular.setdefault(float(p.radius), []).append(i)
            else:
                fp = np.asarray(p.footprint, np.float32)
                key = (fp.shape[0], fp.tobytes(), bool(p.conservative))
                polygonal.setdefault(key, []).append(i)
        for radius, ids in circular.items():
            self._run_circular(paths, results, ids, radius)
        for ids in polygonal.values():
            self._run_polygonal(paths, results, ids)
        return results

    @staticmethod
    def _bucket_pose_count(n: int) -> int:
        """Pose counts padded to {1, 2, 4, 8, 16, ...}: ragged planner
        batches then share a handful of batch shapes."""
        if n <= 1:
            return n
        b = 2
        while b < n:
            b *= 2
        return b

    def _check_inclination_unported(self) -> None:
        if self.config.footprint.check_robot_inclination:
            raise NotImplementedError(
                "check_robot_inclination is not ported yet (ROADMAP A16)"
            )

    def _run_circular(self, paths, results, ids, radius):
        self._check_inclination_unported()
        offset = self.config.footprint.circular_footprint_offset
        N = max(np.atleast_2d(np.asarray(paths[i].poses)).shape[0] for i in ids)
        P = len(ids)
        poses = np.zeros((P, N, 2), np.float32)
        n_poses = np.zeros((P,), np.int32)
        for b, i in enumerate(ids):
            pp = np.atleast_2d(np.asarray(paths[i].poses, dtype=np.float32))[:, :2]
            poses[b, : len(pp)] = pp
            poses[b, len(pp) :] = pp[-1]
            n_poses[b] = len(pp)
        max_cells = self._max_segment_cells(poses, n_poses)
        field = self._circle_field(float(radius), float(offset))
        safe, trav = fp_ops.check_circular_paths(
            self.query_state, poses, n_poses, float(radius), float(offset),
            int(max_cells), field, bool(np.any(n_poses <= 1)),
        )
        safe = safe.cpu().numpy()
        trav = trav.cpu().numpy()
        for b, i in enumerate(ids):
            results[i].is_safe = bool(safe[b])
            results[i].traversability = float(trav[b])

    def _run_polygonal(self, paths, results, ids):
        """One dispatch for paths sharing (footprint, conservative)."""
        first = paths[ids[0]]
        fp = np.asarray(first.footprint, np.float32)
        counts = [np.atleast_2d(np.asarray(paths[i].poses)).shape[0] for i in ids]
        N = self._bucket_pose_count(max(counts))
        pos3 = np.zeros((len(ids), N, 3), np.float32)
        quats = np.zeros((len(ids), N, 4), np.float32)
        quats[..., 3] = 1.0
        for b, i in enumerate(ids):
            poses = np.atleast_2d(np.asarray(paths[i].poses, dtype=np.float32))
            n = poses.shape[0]
            pos3[b, :n, : poses.shape[1]] = poses
            pos3[b, n:] = pos3[b, n - 1]
            if paths[i].orientations is not None:
                q = np.asarray(paths[i].orientations, np.float32).reshape(n, 4)
                quats[b, :n] = q
                quats[b, n:] = q[-1]
        safe, trav, area = self.check_polygonal_paths_batch(
            pos3, quats, np.asarray(counts, np.int32), fp, bool(first.conservative)
        )
        safe = safe.cpu().numpy()
        trav = trav.cpu().numpy()
        area = area.cpu().numpy()
        for b, i in enumerate(ids):
            results[i].is_safe = bool(safe[b])
            results[i].traversability = float(trav[b])
            results[i].area = float(area[b])

    def check_polygonal_paths_batch(
        self,
        positions: np.ndarray,
        quaternions: np.ndarray,
        n_poses: np.ndarray,
        footprint: np.ndarray,
        conservative: bool = False,
    ):
        """Batched polygonal path checks: positions (P, N, 3), quaternions
        (P, N, 4) xyzw, the first n_poses[p] poses valid and the rest
        repeating the last valid one, footprint (V, 2) in the base frame.
        Returns (is_safe (P,), trav (P,), area (P,)) tensors on the
        estimator's device; ``last_polygonal_dispatch`` says which evaluator
        ran."""
        self._check_inclination_unported()
        quats_np = np.asarray(quaternions)
        identity = bool(np.all(np.abs(quats_np - np.asarray([0, 0, 0, 1])) < 1e-12))
        stats: Dict = {}
        out = _dispatch_polygonal(
            self.query_state, np.asarray(positions, np.float32), quats_np,
            np.asarray(n_poses), np.asarray(footprint, np.float32),
            self.config.chain.resolution, conservative, identity, stats_out=stats,
        )
        self._record_polygonal_dispatch(stats)
        return out

    def _record_polygonal_dispatch(self, stats: Dict) -> None:
        self.last_polygonal_dispatch = stats
        key = f"paths_{stats['evaluator']}"
        counts = self.polygonal_dispatch_counts
        counts[key] = counts.get(key, 0) + stats["paths"]
        rkey = f"batches_{stats['reason']}"
        counts[rkey] = counts.get(rkey, 0) + 1
        if stats["evaluator"] == "per_segment":
            logger.debug(
                "polygonal batch (%d paths) went to the per-segment evaluator: %s",
                stats["paths"], stats["reason"],
            )

    def check_circular_paths_batch(
        self, poses: np.ndarray, n_poses: np.ndarray, radius: float, crop: Optional[bool] = None
    ):
        """Batched circular path checks; returns (is_safe (P,), trav (P,))
        tensors on the estimator's device. On large maps (`crop` defaults to
        True above 4M cells) the query state and the dense field are built on
        a crop covering the pose bounding box + the spiral reach, so a
        batch's cost scales with its footprint, not the map size; results
        are identical (every touched cell lies inside the crop)."""
        self._check_inclination_unported()
        offset = self.config.footprint.circular_footprint_offset
        poses = np.asarray(poses, np.float32)
        n_poses = np.asarray(n_poses, np.int32)
        max_cells = self._max_segment_cells(poses, n_poses)
        H, W = self.query_state.shape
        if crop is None:
            crop = H * W > 4_000_000
        if crop:
            state, field = self._cropped_state_and_field(poses, radius, offset)
        else:
            state = self.query_state
            field = self._circle_field(float(radius), float(offset))
        return fp_ops.check_circular_paths(
            state, poses, n_poses, float(radius), float(offset), int(max_cells),
            field, bool(np.any(n_poses <= 1)),
        )

    def _cropped_state_and_field(self, poses: np.ndarray, radius, offset):
        """Crop the query planes to the pose bbox + spiral reach (bucketed to
        512s so jittering batches reuse one crop) and build the field on it."""
        res = self.config.chain.resolution
        H, W = self.query_state.shape
        flat = np.asarray(poses, np.float32).reshape(-1, 2)
        margin = radius + offset + 3 * res
        half = np.array([H, W]) * res / 2.0
        p0 = np.asarray(self._position, np.float64) + half
        i_lo, j_lo, hc, wc, pos_crop = _pose_crop_geometry(
            flat, margin, H, W, res, p0, bucket=512
        )
        key = ("crop", float(radius), float(offset), i_lo, j_lo, hc, wc)
        if key not in self._field_cache:
            full = self.query_state
            state = fp_ops.QueryState(
                traversability=full.traversability[i_lo : i_lo + hc, j_lo : j_lo + wc],
                traversable_mask=full.traversable_mask[i_lo : i_lo + hc, j_lo : j_lo + wc],
                position=torch.as_tensor(pos_crop, dtype=torch.float32, device=self.device),
                resolution=res,
                default_traversability=self._traversability_default,
            )
            field = dense_circle_field(state, float(radius + offset), float(radius))
            self._field_cache[key] = (state, field)
        return self._field_cache[key]

    def _circle_field(self, radius: float, offset: float):
        """Dense circle field cached per map epoch (the reference's
        traversability_footprint memo cache, computed densely)."""
        key = (radius, offset)
        if key not in self._field_cache:
            self._field_cache[key] = dense_circle_field(
                self.query_state, radius + offset, radius
            )
        return self._field_cache[key]

    def _max_segment_cells(self, poses, n_poses) -> int:
        res = self.config.chain.resolution
        if poses.shape[1] < 2:
            return 4
        seg = np.linalg.norm(np.diff(np.asarray(poses), axis=1), axis=-1)
        longest = float(seg.max()) if seg.size else 0.0
        n = int(np.ceil(longest / res)) + 3
        # multiples of 8: a stable sample count across batches
        return ((n + 7) // 8) * 8

    # ------------------------------------------------------------------
    # dense footprint services
    # ------------------------------------------------------------------
    def traversability_footprint(self, footprint_yaw: Optional[float] = None) -> GridMap:
        """Dense polygonal footprint scoring at every cell: adds the
        ``traversability_x`` layer (the footprint as configured) and
        ``traversability_rot`` (turned by `footprint_yaw`)."""
        yaw = self.config.footprint_yaw if footprint_yaw is None else footprint_yaw
        fp = np.asarray(self.config.footprint.footprint_polygon, np.float64)
        c, s = np.cos(yaw), np.sin(yaw)
        fp_rot = fp @ np.array([[c, -s], [s, c]]).T
        t0 = time.perf_counter()
        layers = {}
        for name, verts in (("traversability_x", fp), ("traversability_rot", fp_rot)):
            ok, trav = fp_ops.dense_polygon_field(self.query_state, verts)
            layers[name] = torch.where(ok, trav, 0.0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_footprint_seconds = time.perf_counter() - t0
        self._map = self.traversability_map.add_all(layers)
        return self._map

    def traversability_footprint_circle(
        self, radius: Optional[float] = None, offset: Optional[float] = None
    ) -> GridMap:
        """Dense circular variant: adds the ``traversability_footprint``
        layer (the dense circle field; kernel 2 on CUDA)."""
        fcfg = self.config.footprint
        r = fcfg.circular_footprint_radius_inscribed if radius is None else radius
        o = fcfg.circular_footprint_offset if offset is None else offset
        layer = fp_ops.traversability_footprint_circles(self.query_state, float(r), float(o))
        self._map = self.traversability_map.add_all({"traversability_footprint": layer})
        return self._map
