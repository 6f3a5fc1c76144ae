"""TraversabilityEstimator, main-path slice: map update, query state, dense
circle field and circular path checks.

A plain class holding tensors on one device. ``update`` runs the fused map
update (kernel 1 on CUDA); circular path queries read the dense circle
field of the current map epoch (kernel 2 on CUDA), cached per (radius,
offset) until the next update. Polygonal paths, untraversable polygons and
the inclination check are later slices of the port and raise
NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
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
        circular paths batched per radius."""
        if isinstance(paths, FootprintPath):
            paths = [paths]
        results = [TraversabilityResult() for _ in paths]
        if not self.initialized:
            return results
        circular: Dict[float, List[int]] = {}
        for i, p in enumerate(paths):
            if p.footprint is not None and len(p.footprint) > 0:
                raise NotImplementedError(
                    "polygonal footprint paths are not ported yet (ROADMAP A9)"
                )
            if p.compute_untraversable_polygon:
                raise NotImplementedError(
                    "untraversable polygons are not ported yet (ROADMAP A16)"
                )
            poses = np.atleast_2d(np.asarray(p.poses, dtype=np.float32))
            if poses.shape[0] == 0 or poses.size == 0:
                continue
            circular.setdefault(float(p.radius), []).append(i)
        for radius, ids in circular.items():
            self._run_circular(paths, results, ids, radius)
        return results

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
