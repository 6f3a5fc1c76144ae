"""TraversabilityEstimator: map update, submaps and the online tick, query
state, circular and polygonal path checks, the dense footprint services and
the map-management services.

A plain class holding tensors on one device. ``update`` runs the fused map
update (kernel 1 on CUDA); circular path queries read the dense circle
field of the current map epoch (kernel 2 on CUDA), cached per (radius,
offset) until the map changes; polygonal path batches are dispatched from
host-visible batch statistics to the grouped (one window per path; kernel
3 on CUDA) or the per-segment evaluator.

The online path keeps a persistent map and refreshes it from robot-centric
submaps: ``merge_submap`` / ``recenter`` / ``update_with_submap`` one step
at a time, or ``online_tick`` for the whole tick ([roll +] merge +
incremental refresh through kernel 1 on the crop + the tick's path batch,
through kernel 2 on the query crop for circular paths), queued on the current
stream without a synchronise. Map state is never written in place: every
tick swaps in new tensors, so a map or query state taken earlier keeps its
values.

A configuration whose filter list is not the canonical chain
(``use_generic_chain``) updates through ``ops/chain.py`` instead (torch ops
on either device). Failed paths can report their untraversable polygon
(``models/untraversable.py``, on the host, from one copy of the veto plane
per map epoch); ``save`` / ``load_elevation_map`` checkpoint the map as a
rosbag or an NPZ file.

Threads: a node's timer thread swaps in new map state while service threads
query. Each map epoch's query state, map position and cached dense fields
are one object, replaced as a whole, so a query reads one epoch throughout
and a field computed for an old epoch never lands in a new one's cache.

Not ported yet: multi-GPU (ROADMAP A14).
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
from traversability_estimation_tpu_torch.models import untraversable
from traversability_estimation_tpu_torch.ops import chain as spec_chain
from traversability_estimation_tpu_torch.ops import footprint as fp_ops
from traversability_estimation_tpu_torch.ops import poly_kernel
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


@dataclasses.dataclass(frozen=True)
class _Epoch:
    """One map epoch as queries see it: the query state, the map position on
    the host, and the dense fields (and the host veto plane) cached for this
    state. A changed map swaps in a new epoch; nothing in one is replaced."""

    state: Optional[fp_ops.QueryState]
    position: np.ndarray
    fields: Dict[tuple, object]


def _update_step_generic(elevation, filter_specs, resolution, veto_cfg):
    """Map update through the declarative chain (``ops/chain.py``), for a
    configured chain the fused update cannot represent (extra filters, custom
    layer names, reordered stages). Torch ops on the card too: the JAX
    package computes this route outside any Pallas kernel, so there is no
    kernel to port here. The veto cascade consumes whichever canonical layers
    the chain produced; a layer it does not produce is a NaN plane, which
    every veto passes (they fire only where a layer is exactly 0)."""
    produced = spec_chain.compile_chain(filter_specs, resolution)({"elevation": elevation})
    nanplane = torch.full_like(elevation, float("nan"))
    produced.setdefault("traversability", nanplane)
    veto_in = {
        "elevation": elevation,
        "traversability_slope": produced.get("traversability_slope", nanplane),
        "traversability_step": produced.get("traversability_step", nanplane),
    }
    if veto_cfg.check_roughness:
        veto_in["traversability_roughness"] = produced.get("traversability_roughness", nanplane)
    veto = veto_ops.compute_veto_fields(veto_in, veto_cfg)
    produced.pop("elevation", None)
    produced.update(veto)
    return produced


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
    chain_cfg, veto_cfg, crop_shape, inner, qcrop_shape, radius, offset, has_single,
    default_trav, do_roll, footprint=None, pwindow=None, translate_only=False,
    conservative=False,
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
    Returns (elevation, layers, extra_layers, safe (P,), trav (P,), the query
    crop's state, its circle field (None for polygonal paths)).
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
    field = None
    if footprint is not None:
        # polygonal tick: the grouped evaluator (kernel 3 on CUDA) on the
        # query crop (window and translate_only were resolved on the host)
        pos3 = np.concatenate([poses, np.zeros(poses.shape[:2] + (1,), np.float32)], -1)
        safe, trav, _area = poly_kernel.check_polygonal_paths_grouped(
            state, pos3, quats, n_poses, np.asarray(footprint, np.float32), pwindow,
            conservative, translate_only,
        )
    else:
        field = dense_circle_field(state, radius + offset, radius)
        safe, trav = fp_ops.check_circular_paths(
            state, poses, n_poses, radius, offset, None, field, has_single
        )
    return elev2, new_layers, extra_layers, safe, trav, state, field


def _dispatch_polygonal(
    query_state, pos3, quats, n_poses, fp, resolution, conservative,
    stats_out: Optional[dict] = None,
):
    """Pick the grouped (per-path window; kernel 3 on CUDA) or the
    per-segment polygonal evaluator; returns (safe, trav, area) tensors on
    the query state's device.

    pos3 (float32), quats and fp (float32) are host arrays, uploaded here
    once: ``fp_ops.path_window_plan`` reduces the window planners' inputs on
    the uploaded tensors to one small fetch, and the evaluator reads the same
    tensors. When `stats_out` is given it is filled with which evaluator ran
    and why: the slower per-segment evaluator (a non-convex footprint, a
    per-path window past ``_GROUPED_ELEMS_CAP``) is silent in the results."""
    dev = query_state.device
    pos3_t = torch.as_tensor(pos3, device=dev)
    # the caller's quaternion dtype, as the NumPy planners read it; the
    # evaluators round it to float32 on the device
    quats_t = torch.as_tensor(
        quats, dtype=torch.float32 if quats.dtype == np.float32 else torch.float64, device=dev)
    fp_t = torch.as_tensor(fp, device=dev)
    plan = fp_ops.path_window_plan(pos3_t, quats_t, fp_t).cpu().tolist()
    identity, gw, bw = fp_ops.planned_windows(plan, fp, resolution)
    convex = fp_ops.is_convex_polygon(fp)
    translate_only = identity and not conservative and convex
    B = pos3.shape[0]
    # block-window mode, per-(path, 8-segment-block) windows: the middle tier
    # when the per-path window exceeds the cap (long paths) and the block
    # window does not
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
        return poly_kernel.check_polygonal_paths_grouped(
            query_state, pos3_t, quats_t, n_poses, fp_t, gw, bool(conservative), translate_only,
            bw if use_blocks else None,
        )
    seg = np.linalg.norm(np.diff(pos3[..., :2], axis=1), axis=-1)
    seg_max = float(seg.max()) if seg.size else 0.0
    window = fp_ops.polygon_window_cells(
        fp, seg_max, resolution, conservative, identity_orientation=identity
    )
    return fp_ops.check_polygonal_paths(
        query_state, pos3_t, quats_t, n_poses, fp_t, window, bool(conservative), translate_only
    )


class TraversabilityEstimator:
    def __init__(self, config: Optional[EstimatorConfig] = None, device: DeviceLike = None):
        self.config = config or EstimatorConfig()
        self.device = resolve_device(device)
        self._map: Optional[GridMap] = None
        self._epoch = _Epoch(None, np.zeros(2, dtype=np.float32), {})
        # online_tick's monotone high-water mark: the polygonal window per
        # (footprint, identity) stops growing after a few ticks, so a tick's
        # shapes repeat
        self._pwindow_hwm: Dict[tuple, tuple] = {}
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

    @property
    def _query_state(self) -> Optional[fp_ops.QueryState]:
        return self._epoch.state

    @property
    def _field_cache(self) -> Dict[tuple, object]:
        return self._epoch.fields

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

    def set_elevation_map_msg(self, msg) -> bool:
        """GridMapMessage ingest with the reference's validation
        (TraversabilityMap::setElevationMap): rejected on a frame-id mismatch
        and on any missing required elevation layer (fused: elevation,
        upper_bound, lower_bound; raw adds the variances and time)."""
        if msg.frame_id and msg.frame_id != self.config.map_frame_id:
            return False
        if any(layer not in msg.data for layer in self.config.elevation_layers):
            return False
        extra = {k: v for k, v in msg.data.items() if k != "elevation"}
        return self.set_elevation_map(
            msg.data["elevation"], np.asarray(msg.position[:2], np.float32), extra_layers=extra
        )

    def initialize_from_grid_map_msg(self, msg) -> bool:
        """loadElevationMap's lenient path: MISSING required layers are
        padded with 0.0 before ingest
        (initializeTraversabilityMapFromGridMap)."""
        data = dict(msg.data)
        first = next(iter(data.values()))
        for layer in self.config.elevation_layers:
            if layer not in data:
                data[layer] = np.zeros_like(np.asarray(first, np.float32))
        extra = {k: v for k, v in data.items() if k != "elevation"}
        return self.set_elevation_map(
            data["elevation"], np.asarray(msg.position[:2], np.float32), extra_layers=extra
        )

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
        """A new map epoch: the query state of `layers` at the current
        position, with an empty cache of dense circle fields."""
        state = fp_ops.QueryState(
            traversability=layers["traversability"],
            traversable_mask=layers["traversable_mask"],
            position=self._position_tensor(),
            resolution=self.config.chain.resolution,
            default_traversability=self._traversability_default,
        )
        self._epoch = _Epoch(state, np.array(self._position, np.float32), {})

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
        full update of the merged map. The refresh runs the canonical chain
        (``fused_update``) also under ``use_generic_chain``, as the JAX
        package's does: only ``update()`` routes to the generic chain.

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
        two halos of a map edge, under a generic filter chain, when the
        footprint is non-convex, or when the per-path window exceeds the
        grouped evaluator's cap.

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
        ) or (self.config.use_generic_chain and self.config.filter_specs):
            return _unfused()

        # polygonal mode: resolve the grouped evaluator's static dispatch on
        # the host with the NumPy planners (the integers _dispatch_polygonal
        # plans on the device; planning there would sync inside the tick)
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
            self._check_pose_bounds(poses, n_poses_np)
            has_single = bool(np.any(n_poses_np <= 1))
        else:
            has_single, radius, offset = False, 0.0, 0.0

        elev2, new_layers, extra2, safe, trav, qstate, field = _online_tick(
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
        if field is not None:
            # the query crop and field this tick answered on, kept with the
            # map epoch they belong to
            key = ("tick_crop", float(radius), float(offset), qi_lo, qj_lo, hc, wc)
            self._epoch.fields[key] = (qstate, field)
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
        if self.config.use_generic_chain and self.config.filter_specs:
            layers = _update_step_generic(
                self._elevation, self.config.filter_specs, self.config.chain.resolution,
                self.config.veto,
            )
        else:
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
        return self._current_epoch().state

    def _current_epoch(self) -> _Epoch:
        epoch = self._epoch
        if epoch.state is None:
            raise RuntimeError("traversability map not initialized; call update()")
        return epoch

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
            poses = np.atleast_2d(np.asarray(p.poses, dtype=np.float32))
            if poses.shape[0] == 0 or poses.size == 0:
                continue
            if p.footprint is None or len(p.footprint) == 0:
                circular.setdefault(float(p.radius), []).append(i)
            else:
                fp = np.asarray(p.footprint, np.float32)
                key = (fp.shape[0], fp.tobytes(), bool(p.conservative))
                polygonal.setdefault(key, []).append(i)
        epoch = self._current_epoch()  # one epoch for the whole request
        for radius, ids in circular.items():
            self._run_circular(epoch, paths, results, ids, radius)
        for ids in polygonal.values():
            self._run_polygonal(epoch, paths, results, ids)
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

    def _run_circular(self, epoch, paths, results, ids, radius):
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
        self._check_pose_bounds(poses, n_poses)
        field = self._circle_field(float(radius), float(offset), epoch)
        safe, trav = fp_ops.check_circular_paths(
            epoch.state, poses, n_poses, float(radius), float(offset),
            None, field, bool(np.any(n_poses <= 1)),
        )
        safe = safe.cpu().numpy()
        trav = trav.cpu().numpy()
        incl = self._inclination_ok(epoch, poses, n_poses)
        if incl is not None:
            trav = np.where(incl, trav, 0.0)
            safe = safe & incl
        for b, i in enumerate(ids):
            results[i].is_safe = bool(safe[b])
            results[i].traversability = float(trav[b])
            if paths[i].compute_untraversable_polygon and not safe[b]:
                # the failing cells the check's spiral walks push
                results[i].untraversable_polygon = (
                    untraversable.circular_path_untraversable_polygon(
                        self._fail_mask_host(epoch),
                        self.config.chain.resolution,
                        epoch.position,
                        poses[b, : n_poses[b]],
                        float(radius),
                        float(offset),
                        epoch.state.default_traversability,
                    )
                )

    def _run_polygonal(self, epoch, paths, results, ids):
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
        n_poses = np.asarray(counts, np.int32)
        conservative = bool(first.conservative)
        safe, trav, area = self._polygonal_batch(epoch, pos3, quats, n_poses, fp, conservative)
        safe = safe.cpu().numpy()
        trav = trav.cpu().numpy()
        area = area.cpu().numpy()
        incl = self._inclination_ok(epoch, pos3[..., :2], n_poses)
        if incl is not None:
            trav = np.where(incl, trav, 0.0)
            area = np.where(incl, area, 0.0)
            safe = safe & incl
        for b, i in enumerate(ids):
            results[i].is_safe = bool(safe[b])
            results[i].traversability = float(trav[b])
            results[i].area = float(area[b])
            if paths[i].compute_untraversable_polygon and not safe[b]:
                # failing cells of the first failing segment's hull
                results[i].untraversable_polygon = (
                    untraversable.polygonal_path_untraversable_polygon(
                        self._fail_mask_host(epoch),
                        self.config.chain.resolution,
                        epoch.position,
                        pos3[b, : n_poses[b]],
                        quats[b, : n_poses[b]],
                        fp,
                        conservative,
                        epoch.state.default_traversability,
                    )
                )

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
        return self._polygonal_batch(
            self._current_epoch(), positions, quaternions, n_poses, footprint, conservative
        )

    def _polygonal_batch(self, epoch, positions, quaternions, n_poses, footprint, conservative):
        stats: Dict = {}
        out = _dispatch_polygonal(
            epoch.state, np.asarray(positions, np.float32), np.asarray(quaternions),
            np.asarray(n_poses), np.asarray(footprint, np.float32),
            self.config.chain.resolution, conservative, stats_out=stats,
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
        epoch = self._current_epoch()
        offset = self.config.footprint.circular_footprint_offset
        poses = np.asarray(poses, np.float32)
        n_poses = np.asarray(n_poses, np.int32)
        self._check_pose_bounds(poses, n_poses)
        H, W = epoch.state.shape
        if crop is None:
            crop = H * W > 4_000_000
        if crop:
            state, field = self._cropped_state_and_field(epoch, poses, radius, offset)
        else:
            state = epoch.state
            field = self._circle_field(float(radius), float(offset), epoch)
        return fp_ops.check_circular_paths(
            state, poses, n_poses, float(radius), float(offset), None,
            field, bool(np.any(n_poses <= 1)),
        )

    def _cropped_state_and_field(self, epoch, poses: np.ndarray, radius, offset):
        """Crop the query planes to the pose bbox + spiral reach (bucketed to
        512s so jittering batches reuse one crop) and build the field on it."""
        res = self.config.chain.resolution
        H, W = epoch.state.shape
        flat = np.asarray(poses, np.float32).reshape(-1, 2)
        margin = radius + offset + 3 * res
        half = np.array([H, W]) * res / 2.0
        p0 = np.asarray(epoch.position, np.float64) + half
        i_lo, j_lo, hc, wc, pos_crop = _pose_crop_geometry(
            flat, margin, H, W, res, p0, bucket=512
        )
        key = ("crop", float(radius), float(offset), i_lo, j_lo, hc, wc)
        if key not in epoch.fields:
            full = epoch.state
            state = fp_ops.QueryState(
                traversability=full.traversability[i_lo : i_lo + hc, j_lo : j_lo + wc],
                traversable_mask=full.traversable_mask[i_lo : i_lo + hc, j_lo : j_lo + wc],
                position=torch.as_tensor(pos_crop, dtype=torch.float32, device=self.device),
                resolution=res,
                default_traversability=full.default_traversability,
            )
            field = dense_circle_field(state, float(radius + offset), float(radius))
            epoch.fields[key] = (state, field)
        return epoch.fields[key]

    def _circle_field(self, radius: float, offset: float, epoch: Optional[_Epoch] = None):
        """Dense circle field cached per map epoch (the reference's
        traversability_footprint memo cache, computed densely). Two threads
        that miss together both compute it; either result serves."""
        epoch = epoch or self._current_epoch()
        key = (radius, offset)
        if key not in epoch.fields:
            epoch.fields[key] = dense_circle_field(epoch.state, radius + offset, radius)
        return epoch.fields[key]

    def _check_pose_bounds(self, poses: np.ndarray, n_poses) -> None:
        """The check a circular batch passes before it is walked: every
        segment is walked whole (``max_segment_cells=None``), so no pass
        over the poses' lengths is needed, but a batch with a pose beyond
        1e18 (NaN and inf among them) takes ``_max_segment_cells``, which
        raises what a capped walk raised (a NaN length's ValueError, an
        infinite one's OverflowError); within it no length overflows."""
        if poses.size and not (-1e18 <= poses.min() and poses.max() <= 1e18):
            self._max_segment_cells(poses, n_poses)

    def _max_segment_cells(self, poses, n_poses) -> int:
        res = self.config.chain.resolution
        if poses.shape[1] < 2:
            return 4
        seg = np.linalg.norm(np.diff(np.asarray(poses), axis=1), axis=-1)
        longest = float(seg.max()) if seg.size else 0.0
        n = int(np.ceil(longest / res)) + 3
        # multiples of 8: a stable sample count across batches
        return ((n + 7) // 8) * 8

    def _fail_mask_host(self, epoch: Optional[_Epoch] = None) -> np.ndarray:
        """Host copy of the dense veto-fail plane, cached per map epoch: the
        cell set the untraversable-polygon extraction reads. The one
        device-to-host copy of a whole plane on the query path."""
        epoch = epoch or self._current_epoch()
        key = ("fail_mask_host",)
        if key not in epoch.fields:
            epoch.fields[key] = ~epoch.state.traversable_mask.cpu().numpy()
        return epoch.fields[key]

    def path_polygons(self, path: FootprintPath):
        """Publication streams (footprints, untraversables, robot_height) of
        one path check, the reference's publishPolygons side channel: the
        footprint polygon of every evaluated pose or segment and the hulls of
        the failing cells. Host geometry against the dense veto-fail plane;
        a node calls this only when polygon subscribers exist."""
        if not self.initialized:
            return [], [], 0.0
        poses = np.atleast_2d(np.asarray(path.poses, np.float64))
        if poses.shape[0] == 0 or poses.size == 0:
            return [], [], 0.0
        epoch = self._current_epoch()
        default = epoch.state.default_traversability
        res = self.config.chain.resolution
        if path.footprint is None or len(path.footprint) == 0:
            return untraversable.circular_path_polygons(
                self._fail_mask_host(epoch), res, epoch.position, poses, float(path.radius),
                self.config.footprint.circular_footprint_offset, default,
            )
        return untraversable.polygonal_path_polygons(
            self._fail_mask_host(epoch), res, epoch.position, poses, path.orientations,
            np.asarray(path.footprint, np.float64), bool(path.conservative), default,
        )

    def _inclination_ok(self, epoch: _Epoch, poses: np.ndarray, n_poses: np.ndarray):
        """checkInclination gate, only when configured and a `robot_slope`
        layer exists: (P,) bool on the host, else None."""
        if not self.config.footprint.check_robot_inclination:
            return None
        gmap = self._map
        if gmap is None or "robot_slope" not in gmap.layers:
            return None
        max_cells = self._max_segment_cells(poses, n_poses)
        ok = fp_ops.check_inclination_paths(
            epoch.state, gmap["robot_slope"], poses, n_poses, int(max_cells)
        )
        return ok.cpu().numpy()

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
        self._epoch = dataclasses.replace(self._epoch, fields={})
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

    def save(self, path: str) -> None:
        """Snapshot the full map state: ``.bag`` writes the reference's own
        checkpoint format (save_traversability_map_to_bag: loadable by stock
        ROS tooling and by ``load_elevation_map``; float layers only, as
        grid_map holds them); anything else writes an NPZ snapshot of every
        layer. Every layer is copied to the host for it."""
        if self._map is None:
            raise RuntimeError("nothing to save")
        host = {k: v.cpu().numpy() for k, v in self._map.layers.items()}
        if path.endswith(".bag"):
            from traversability_estimation_tpu_torch.utils.rosbag import save_grid_map_bag

            save_grid_map_bag(
                path,
                {k: v for k, v in host.items() if v.dtype != np.bool_},
                self.config.chain.resolution,
                np.asarray(self._position),
                frame_id=self.config.map_frame_id,
                topic="grid_map",
            )
            return
        np.savez_compressed(
            path,
            resolution=self.config.chain.resolution,
            position=np.asarray(self._position),
            **{f"layer_{k}": v for k, v in host.items()},
        )

    def load_elevation_map(self, path: str) -> bool:
        """Load from a rosbag (the reference's checkpoint format) or an NPZ
        snapshot, then recompute traversability (loadElevationMap: recompute
        on load). False on unreadable input."""
        try:
            if path.endswith(".bag"):
                from traversability_estimation_tpu_torch.utils.rosbag import load_grid_map_bag

                if not self.initialize_from_grid_map_msg(load_grid_map_bag(path)):
                    return False
            else:
                with np.load(path) as blob:
                    self.set_elevation_map(blob["layer_elevation"], blob["position"])
        except (OSError, ValueError, KeyError) as e:
            logger.error("load_elevation_map(%s): %s", path, e)
            return False
        return self.update()

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
