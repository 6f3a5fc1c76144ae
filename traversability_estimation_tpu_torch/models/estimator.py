"""TraversabilityEstimator: map update, submaps and the online tick, query
state, circular and polygonal path checks, the dense footprint services and
the map-management services.

A plain class holding tensors on one device. ``update`` runs the fused map
update (kernel 1 on CUDA); circular path queries read the dense circle
field of the current map epoch (kernel 2 on CUDA), cached per (radius,
offset) until the map changes; polygonal path batches are dispatched from
host-visible batch statistics to the grouped (one window per path) or the
per-segment evaluator.

The online path keeps a persistent map and refreshes it from robot-centric
submaps: ``merge_submap`` / ``recenter`` / ``update_with_submap`` one step
at a time, or ``online_tick`` for the whole tick ([roll +] merge +
incremental refresh through kernel 1 on the crop + the tick's path batch,
through kernel 2 on the query crop for circular paths), queued on the current
stream without a synchronise. Map state is never written in place: every
tick swaps in new tensors, so a map or query state taken earlier keeps its
values.

Not ported yet, each raising NotImplementedError with its ROADMAP item where
a caller can reach it: the generic filter chain (A11, refused by
``EstimatorConfig``), the node, service, persistence and message ingest
(A13), multi-GPU (A14), untraversable polygons and the inclination check
(A16).
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
from traversability_estimation_tpu_torch.ops import veto as veto_ops
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


def _patch_origin(position, shape, patch_shape, center_xy, res):
    """Map index (i0, j0) of a patch's top-left cell when the patch is
    centred at `center_xy` in a map of `shape` centred at `position`; the
    index may lie outside the map."""
    H, W = shape
    ph, pw = patch_shape
    half = np.array([H, W]) * res / 2.0
    i0 = int(np.floor((position[0] + half[0] - (center_xy[0] + ph * res / 2)) / res))
    j0 = int(np.floor((position[1] + half[1] - (center_xy[1] + pw * res / 2)) / res))
    return i0, j0


def _check_region(what, start, shape, H, W):
    """Slices do not clamp their start as a dynamic slice does: a region
    that leaves the map is an error of the caller's geometry."""
    if not (0 <= start[0] and start[0] + shape[0] <= H
            and 0 <= start[1] and start[1] + shape[1] <= W):
        raise ValueError(f"online tick: {what} {tuple(start)}+{tuple(shape)} leaves the {H}x{W} map")


def _replaced(plane: torch.Tensor, piece: torch.Tensor, start, fresh: bool) -> torch.Tensor:
    """`plane` with `piece` written at `start`, as a new tensor of the
    piece's dtype; `plane` itself is written only when it is `fresh` (made
    in this tick, seen by no one else)."""
    out = plane.to(piece.dtype, copy=not fresh)
    out[start[0] : start[0] + piece.shape[0], start[1] : start[1] + piece.shape[1]] = piece
    return out


def _online_tick(
    elevation, layers, extra_layers, patch, roll_shift, merge_start, crop_start,
    write_start, qcrop_start, qpos, poses, n_poses, quats=None, *,
    chain_cfg, veto_cfg, crop_shape, inner, qcrop_shape, radius, offset, max_cells,
    has_single, default_trav, do_roll, footprint=None, pwindow=None,
    translate_only=False, conservative=False,
):
    """One online tick on tensors: [recenter roll +] submap merge +
    incremental refresh of the merged region + the tick's path batch on the
    query crop. Everything is queued on the current stream; nothing here
    waits for the device.

    elevation (H, W) f32, layers / extra_layers dicts of (H, W) planes and
    patch (ph, pw) f32 are tensors on one device; the region starts are host
    integers and all region shapes are static per (patch shape, query-crop
    bucket). The inputs are left as they are: the outputs are new tensors
    (layers the tick does not touch are shared).

    On CUDA the refresh is kernel 1 on the (ph + 4 halo, pw + 4 halo) crop
    and, for circular paths, the field is kernel 2 on the query crop.
    Returns (elevation, layers, extra_layers, safe (P,), trav (P,)).
    """
    H, W = elevation.shape
    fresh = bool(do_roll)
    if do_roll:
        # the roll and the per-dtype fill are GridMap's, shared so fused and
        # unfused roaming stay equal by construction
        si, sj = int(roll_shift[0]), int(roll_shift[1])
        ok = GridMap.roll_valid_mask(H, W, si, sj, elevation.device)

        def _roll(a):
            return GridMap.roll_layer(a, si, sj, ok)

        elevation = _roll(elevation)
        layers = {k: _roll(v) for k, v in layers.items()}
        extra_layers = {k: _roll(v) for k, v in extra_layers.items()}

    _check_region("merge region", merge_start, patch.shape, H, W)
    _check_region("update crop", crop_start, crop_shape, H, W)
    elev2 = _replaced(elevation, patch, merge_start, fresh)
    crop = elev2[
        crop_start[0] : crop_start[0] + crop_shape[0],
        crop_start[1] : crop_start[1] + crop_shape[1],
    ]
    crop_layers = fused_update(crop, chain_cfg, veto_cfg)
    wi0, wi1, wj0, wj1 = inner
    _check_region("write region", write_start, (wi1 - wi0, wj1 - wj0), H, W)
    new_layers = dict(layers)
    for name, plane in crop_layers.items():
        if name in new_layers:
            new_layers[name] = _replaced(
                new_layers[name], plane[wi0:wi1, wj0:wj1], write_start, fresh
            )
    new_layers["elevation"] = elev2

    _check_region("query crop", qcrop_start, qcrop_shape, H, W)
    qi, qj = int(qcrop_start[0]), int(qcrop_start[1])
    state = fp_ops.QueryState(
        # contiguous once, here: the field kernel and the path gathers both
        # read the crop as a dense plane
        traversability=new_layers["traversability"][
            qi : qi + qcrop_shape[0], qj : qj + qcrop_shape[1]].contiguous(),
        traversable_mask=new_layers["traversable_mask"][
            qi : qi + qcrop_shape[0], qj : qj + qcrop_shape[1]].contiguous(),
        position=qpos,
        resolution=chain_cfg.resolution,
        default_traversability=default_trav,
    )
    if footprint is not None:
        # polygonal tick: the grouped evaluator on the query crop (window and
        # translate_only were resolved on the host)
        pos3 = np.concatenate([poses, np.zeros(poses.shape[:2] + (1,), np.float32)], -1)
        safe, trav, _area = fp_ops.check_polygonal_paths_grouped(
            state, pos3, quats, n_poses, np.asarray(footprint, np.float32), pwindow,
            conservative, translate_only,
        )
    else:
        field = dense_circle_field(state, radius + offset, radius)
        safe, trav = fp_ops.check_circular_paths(
            state, poses, n_poses, radius, offset, max_cells, field, has_single
        )
    return elev2, new_layers, extra_layers, safe, trav


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
        # online_tick's monotone high-water marks: the polygonal window per
        # (footprint, identity) and the circular sample count stop growing
        # after a few ticks, so a tick's shapes repeat
        self._pwindow_hwm: Dict[tuple, tuple] = {}
        self._max_cells_hwm: int = 0
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

    def set_elevation_from_image(
        self, image, min_height: float = 0.0, max_height: float = 1.0, position=(0.0, 0.0)
    ) -> bool:
        """Grayscale image -> elevation (imageCallback): values scaled to
        [min_height, max_height]; NaN where the image is NaN."""
        img = np.asarray(image, dtype=np.float32)
        if img.max() > 1.0:
            img = img / 255.0
        elev = min_height + img * (max_height - min_height)
        return self.set_elevation_map(elev, position)

    def _position_tensor(self) -> torch.Tensor:
        return torch.as_tensor(self._position, dtype=torch.float32, device=self.device)

    def _set_query_state(self, layers: Dict[str, torch.Tensor]) -> None:
        """The query state of `layers` at the current position; a changed
        map invalidates the cached dense circle fields."""
        self._query_state = fp_ops.QueryState(
            traversability=layers["traversability"],
            traversable_mask=layers["traversable_mask"],
            position=self._position_tensor(),
            resolution=self.config.chain.resolution,
            default_traversability=self._traversability_default,
        )
        self._field_cache.clear()

    def _merge_geometry(self, patch, center_xy):
        """Where a patch centred at `center_xy` lands: its origin (i0, j0),
        which may lie outside the map, and the index bounds (si0, si1, sj0,
        sj1) it will occupy, clipped to the map. None when it lies entirely
        outside."""
        H, W = self._elevation.shape
        ph, pw = np.asarray(patch).shape
        i0, j0 = _patch_origin(
            self._position, (H, W), (ph, pw), center_xy, self.config.chain.resolution
        )
        si0, sj0 = max(i0, 0), max(j0, 0)
        si1, sj1 = min(i0 + ph, H), min(j0 + pw, W)
        if si1 <= si0 or sj1 <= sj0:
            return None
        return (i0, j0), (si0, si1, sj0, sj1)

    def _merge_bounds(self, patch, center_xy):
        """Index bounds (si0, si1, sj0, sj1) the patch will occupy."""
        geometry = self._merge_geometry(patch, center_xy)
        return None if geometry is None else geometry[1]

    def merge_submap(self, patch, center_xy) -> bool:
        """Merge a robot-centric elevation submap into the persistent map
        (the ingest side of requestElevationMap, for the online loop). The
        patch is placed by world position; cells outside the map are
        dropped."""
        if self._elevation is None:
            return False
        patch = np.asarray(patch, np.float32)
        geometry = self._merge_geometry(patch, center_xy)
        if geometry is None:
            return False
        (i0, j0), (si0, si1, sj0, sj1) = geometry
        clipped = self._plane(patch[si0 - i0 : si1 - i0, sj0 - j0 : sj1 - j0])
        self._elevation = _replaced(self._elevation, clipped, (si0, sj0), fresh=False)
        return True

    def recenter(self, new_center) -> bool:
        """Bounded-memory roaming: translate the persistent map window to
        the grid-aligned centre nearest `new_center` (``GridMap.recenter``,
        grid_map's ``move()``). Overlapping cells keep every computed layer
        (all layers are local functions of elevation at fixed world
        positions, so rolled values stay exact); freshly exposed cells are
        unknown (NaN, vetoes passing) until a merged submap covers them and
        ``update_with_submap`` refreshes the region."""
        if self._elevation is None:
            return False
        res = self.config.chain.resolution
        target = np.asarray(new_center, np.float32)
        shift = np.round((target - self._position) / res).astype(np.int64)
        if shift[0] == 0 and shift[1] == 0:
            return True
        snapped = (self._position + shift.astype(np.float32) * res).astype(np.float32)
        helper = GridMap(
            layers={"elevation": self._elevation, **self._extra_layers},
            resolution=res,
            position=self._position_tensor(),
        ).recenter(snapped)
        self._elevation = helper.layers["elevation"]
        self._extra_layers = {k: v for k, v in helper.layers.items() if k != "elevation"}
        self._position = snapped
        if self._map is not None:
            self._map = self._map.recenter(snapped)
            self._set_query_state(self._map.layers)
        self._field_cache.clear()
        return True

    def update_with_submap(
        self, patch, center_xy, incremental: bool = True, sync: bool = True
    ) -> bool:
        """Merge a fresh submap and refresh traversability.

        `incremental=True` recomputes only the affected region: every output
        cell within `halo` of a changed elevation cell, computed from an
        input crop expanded by one more halo so no crop-edge artifact
        survives (halo = the largest stencil reach, ``veto.required_halo``).
        Every layer is a local function of elevation, so the result equals a
        full update of the merged map.

        `sync=False` skips the trailing synchronise, so the refresh is only
        queued and overlaps with whatever the caller does next;
        `last_update_seconds` then records the time to queue it."""
        if self._elevation is None:
            return False
        if not self.initialized or not incremental:
            if not self.merge_submap(patch, center_xy):
                return False
            return self.update()

        bounds = self._merge_bounds(patch, center_xy)
        if bounds is None:
            return False
        if not self.merge_submap(patch, center_xy):
            return False
        si0, si1, sj0, sj1 = bounds
        halo = veto_ops.required_halo(self.config.chain, self.config.veto)
        H, W = self._elevation.shape
        # output region: changed cells + halo; input crop: one more halo out
        oi0, oi1 = max(si0 - halo, 0), min(si1 + halo, H)
        oj0, oj1 = max(sj0 - halo, 0), min(sj1 + halo, W)
        ci0, ci1 = max(oi0 - halo, 0), min(oi1 + halo, H)
        cj0, cj1 = max(oj0 - halo, 0), min(oj1 + halo, W)
        # the crop's shape in buckets of 64, so that ticks repeat few shapes
        # (the row start alone is pulled back, as the reference does)
        ci1 = min(ci0 + ((ci1 - ci0 + 63) // 64) * 64, H)
        cj1 = min(cj0 + ((cj1 - cj0 + 63) // 64) * 64, W)
        ci0 = max(min(ci0, ci1 - ((ci1 - ci0) // 64) * 64), 0)
        _check_region("update crop", (ci0, cj0), (ci1 - ci0, cj1 - cj0), H, W)
        if not (ci0 <= oi0 and oi1 <= ci1 and cj0 <= oj0 and oj1 <= cj1):
            raise ValueError("update_with_submap: the write region leaves the crop")

        t0 = time.perf_counter()
        crop_layers = fused_update(
            self._elevation[ci0:ci1, cj0:cj1], self.config.chain, self.config.veto
        )
        # write back only the inner (artifact-free) region
        wi0, wi1 = oi0 - ci0, oi1 - ci0
        wj0, wj1 = oj0 - cj0, oj1 - cj0
        new_layers = dict(self._map.layers)
        for name, plane in crop_layers.items():
            if name in new_layers:
                new_layers[name] = _replaced(
                    new_layers[name], plane[wi0:wi1, wj0:wj1], (oi0, oj0), fresh=False
                )
        new_layers["elevation"] = self._elevation
        if sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_update_seconds = time.perf_counter() - t0

        self._map = dataclasses.replace(self._map, layers=new_layers)
        self._set_query_state(new_layers)
        return True

    def online_tick(
        self,
        patch,
        center_xy,
        poses,
        n_poses,
        radius: Optional[float] = None,
        recenter_to=None,
        footprint=None,
        quaternions=None,
        conservative: bool = False,
    ):
        """One online tick: [optional recenter +] submap merge + incremental
        traversability refresh + the tick's batched path checks, queued on
        the current stream as one sequence with static shapes and no
        synchronise; the caller's fetch of ``safe`` is the only wait.

        Query type: pass `radius` for circular paths, or `footprint` ((V, 2)
        CONVEX polygon, optional per-pose `quaternions`) for polygonal paths
        through the grouped evaluator. Equal to ``recenter(recenter_to)`` +
        ``update_with_submap`` + ``check_circular_paths_batch`` /
        ``check_polygonal_paths_batch`` in the map state, and in the path
        results up to the float32 rounding of the query crop's origin (a
        pose on a cell border may fall into the neighbouring cell); falls
        back to exactly that sequence before the first update, when the merge region runs within
        two halos of a map edge, when the footprint is non-convex, or when
        the per-path window exceeds the grouped evaluator's cap.

        Returns (safe (P,), trav (P,)) as tensors on the estimator's device,
        or None when the fallback's update failed (the patch off the map)."""
        if (radius is None) == (footprint is None):
            raise ValueError("pass exactly one of radius= or footprint=")
        poses = np.asarray(poses, np.float32)
        if footprint is not None and quaternions is None:
            quaternions = np.zeros(poses.shape[:2] + (4,), np.float32)
            quaternions[..., 3] = 1.0

        def _unfused():
            ok = True
            if recenter_to is not None:
                ok = self.recenter(recenter_to) and ok
            ok = self.update_with_submap(patch, center_xy) and ok
            if not ok:
                return None
            if footprint is not None:
                pos3 = np.concatenate([poses, np.zeros(poses.shape[:2] + (1,), np.float32)], -1)
                safe, trav, _area = self.check_polygonal_paths_batch(
                    pos3, quaternions, n_poses, footprint, conservative
                )
                return safe, trav
            return self.check_circular_paths_batch(poses, n_poses, radius)

        if self._elevation is None or not self.initialized or self._map is None:
            return _unfused()

        res = self.config.chain.resolution
        H, W = self._elevation.shape
        patch = np.asarray(patch, np.float32)
        ph, pw = patch.shape
        pos = np.asarray(self._position, np.float64)

        shift = np.zeros((2,), np.int64)
        if recenter_to is not None:
            target = np.asarray(recenter_to, np.float64)
            shift = np.round((target - pos) / res).astype(np.int64)
        snapped = (pos + shift.astype(np.float64) * res).astype(np.float32)

        half = np.array([H, W]) * res / 2.0
        i0, j0 = _patch_origin(snapped, (H, W), (ph, pw), center_xy, res)
        halo = veto_ops.required_halo(self.config.chain, self.config.veto)
        # fused geometry: write region = merge + halo, crop = write + halo, all
        # shapes static. Needs 2*halo of interior margin around the patch.
        if not (
            i0 >= 2 * halo and j0 >= 2 * halo
            and i0 + ph + 2 * halo <= H and j0 + pw + 2 * halo <= W
        ):
            return _unfused()

        # polygonal mode: resolve the grouped evaluator's static dispatch on
        # the host exactly as _dispatch_polygonal would
        fp_np = None
        pwindow = None
        translate_only = False
        if footprint is not None:
            fp_np = np.asarray(footprint, np.float32)
            quats_np = np.asarray(quaternions, np.float32)
            identity = bool(np.all(np.abs(quats_np - np.asarray([0, 0, 0, 1])) < 1e-12))
            if not fp_ops.is_convex_polygon(fp_np):
                return _unfused()
            ext = poses.max(axis=1) - poses.min(axis=1)
            if identity:
                pwindow = fp_ops.path_group_window(fp_np, ext, res, True)
            else:
                # exact rotated window from the realised yaws
                pwindow = fp_ops.path_group_window_exact(fp_np, poses, quats_np, res)
            # the window follows the tick's pose extents, so random planner
            # batches would change its size, and every shape downstream, tick
            # to tick. Keep a monotone high-water window per (footprint,
            # mode): after the first couple of ticks it covers every batch
            # the planner produces and the tick's shapes repeat.
            hwm_key = (fp_np.tobytes(), identity)
            hwm = self._pwindow_hwm.get(hwm_key)
            if hwm is None:
                # first sighting: over-allocate 1.5x so the tail of the
                # planner's per-path extents stays under the mark
                hwm = (int(pwindow[0] * 1.5), int(pwindow[1] * 1.5))
            # buckets of 16, so a marginally larger batch rarely grows the mark
            pwindow = (
                ((max(pwindow[0], hwm[0]) + 15) // 16) * 16,
                ((max(pwindow[1], hwm[1]) + 15) // 16) * 16,
            )
            if pwindow[0] * pwindow[1] * poses.shape[0] > _GROUPED_ELEMS_CAP:
                # an over-cap batch falls back for THIS tick only: storing
                # the mark first would let one outlier batch push it past
                # the cap and send every later tick to the fallback
                return _unfused()
            self._pwindow_hwm[hwm_key] = pwindow
            translate_only = identity and not conservative

        crop_shape = (ph + 4 * halo, pw + 4 * halo)
        inner = (halo, halo + ph + 2 * halo, halo, halo + pw + 2 * halo)
        write_start = (i0 - halo, j0 - halo)
        crop_start = (i0 - 2 * halo, j0 - 2 * halo)

        # query crop: pose bbox + spiral or footprint reach, in buckets of 256
        # (clamped inside the map)
        offset = self.config.footprint.circular_footprint_offset
        flat = poses.reshape(-1, 2)
        if footprint is not None:
            margin = float(np.max(np.linalg.norm(fp_np, axis=1))) + 3 * res
        else:
            margin = radius + offset + 3 * res
        p0 = snapped.astype(np.float64) + half
        qi_lo, qj_lo, hc, wc, qpos = _pose_crop_geometry(flat, margin, H, W, res, p0, bucket=256)

        n_poses_np = np.asarray(n_poses, np.int32)
        if footprint is None:
            # monotone high-water sample count (the same reason as the window)
            max_cells = max(self._max_segment_cells(poses, n_poses_np), self._max_cells_hwm)
            self._max_cells_hwm = max_cells
            has_single = bool(np.any(n_poses_np <= 1))
        else:
            max_cells, has_single, radius, offset = 4, False, 0.0, 0.0

        elev2, new_layers, extra2, safe, trav = _online_tick(
            self._elevation,
            dict(self._map.layers),
            dict(self._extra_layers),
            self._plane(patch),
            (int(shift[0]), int(shift[1])),
            (i0, j0),
            crop_start,
            write_start,
            (qi_lo, qj_lo),
            torch.as_tensor(qpos, dtype=torch.float32, device=self.device),
            poses,
            n_poses_np,
            np.asarray(quaternions, np.float32) if footprint is not None else None,
            chain_cfg=self.config.chain,
            veto_cfg=self.config.veto,
            crop_shape=crop_shape,
            inner=inner,
            qcrop_shape=(hc, wc),
            radius=float(radius),
            offset=float(offset),
            max_cells=int(max_cells),
            has_single=has_single,
            default_trav=float(self._traversability_default),
            do_roll=recenter_to is not None,
            footprint=fp_np,
            pwindow=pwindow,
            translate_only=translate_only,
            conservative=bool(conservative) if footprint is not None else False,
        )
        self._elevation = elev2
        self._extra_layers = extra2
        self._position = snapped
        self._map = dataclasses.replace(
            self._map, layers=new_layers, position=self._position_tensor()
        )
        self._set_query_state(new_layers)
        return safe, trav

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
        self._map = GridMap(
            layers=all_layers,
            resolution=self.config.chain.resolution,
            position=self._position_tensor(),
            frame_id=self.config.map_frame_id,
        )
        self._set_query_state(all_layers)
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

    # ------------------------------------------------------------------
    # map-management services
    # ------------------------------------------------------------------
    def set_traversability_map(self, layers: Dict[str, np.ndarray], position=(0.0, 0.0)) -> bool:
        """setTraversabilityMap: adopt externally computed traversability
        layers without running the chain; False when a required layer is
        missing. The veto fields are recomputed from the given layers (they
        are pure functions of them)."""
        required = ("traversability", "traversability_slope", "traversability_step", "elevation")
        if any(r not in layers for r in required):
            return False
        planes = {k: self._plane(v) for k, v in layers.items()}
        veto_in = ["elevation", "traversability_slope", "traversability_step"]
        if self.config.veto.check_roughness:
            veto_in.append("traversability_roughness")
        veto = veto_ops.compute_veto_fields({k: planes[k] for k in veto_in}, self.config.veto)
        self._position = np.asarray(position, dtype=np.float32)
        all_layers = {**planes, **veto}
        self._map = GridMap(
            layers=all_layers,
            resolution=self.config.chain.resolution,
            position=self._position_tensor(),
            frame_id=self.config.map_frame_id,
        )
        self._elevation = planes["elevation"]
        self._set_query_state(all_layers)
        self.initialized = True
        return True

    def reset_footprint_layers(self) -> None:
        """resetTraversabilityFootprintLayers: drop the cached dense circle
        fields and NaN-clear any footprint layers on the map."""
        self._field_cache.clear()
        if self._map is not None:
            for layer in ("step_footprint", "slope_footprint", "traversability_footprint"):
                if layer in self._map.layers:
                    self._map = self._map.clear(layer)

    def restore_default_traversability(self) -> None:
        """restoreDefaultTraversabilityUnknownRegionsReadAtInit."""
        self.set_default_traversability(self.config.footprint.traversability_default)

    def update_parameters(self, config: EstimatorConfig) -> bool:
        """Hot reload (the update_parameters service): the next update runs
        with the new configuration."""
        self.config = config
        self._traversability_default = config.footprint.traversability_default
        return True

    def set_default_traversability(self, value: float) -> None:
        """The score of unknown cells for later map updates, bounded to
        [0, 1]."""
        self._traversability_default = min(max(value, 0.0), 1.0)

    def map_has_valid_traversability_at(self, x: float, y: float) -> bool:
        """mapHasValidTraversabilityAt: (x, y) lies on the map and its cell
        has a finite traversability."""
        if self._map is None:
            return False
        i, j = self._map.index_of(np.float32([x, y])).tolist()
        rows, cols = self._map.size
        if not (0 <= i < rows and 0 <= j < cols):
            return False
        return bool(torch.isfinite(self._map["traversability"][i, j]))
