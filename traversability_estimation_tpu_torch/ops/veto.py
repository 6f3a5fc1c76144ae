"""Dense per-cell veto fields as whole-plane torch ops: the plain version of
kernel 1's veto half, and the CPU path.

The reference computes its veto cascade lazily per queried cell
(slope -> step -> roughness). Each cell's verdict is a pure function of the
map layers, so it is computed densely once per map update: window scans are
static-offset shifted reductions and the step filter's data-dependent gap
walk is a bounded set of ray analyses (8 directions x <= ceil(max_gap/res)
steps) for all cells at once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from traversability_estimation_tpu_torch.grid.geometry import circle_offsets
from traversability_estimation_tpu_torch.ops.filters import ChainConfig, _shifted, f32


@dataclasses.dataclass(frozen=True)
class VetoConfig:
    resolution: float
    critical_step_height: float = 0.12  # stepFilter critical_value
    max_gap_width: float = 0.3  # robot.yaml max_gap_width
    check_roughness: bool = False  # footprint/verify_roughness_footprint

    @property
    def slope_n_critical(self) -> int:
        window_radius = 3.0 * self.resolution
        critical_length = self.max_gap_width / 3.0
        return math.floor(2.0 * window_radius * critical_length / self.resolution**2)

    @property
    def roughness_n_critical(self) -> int:
        window_radius = 3.0 * self.resolution
        critical_length = self.max_gap_width / 3.0
        return math.floor(1.5 * window_radius * critical_length / self.resolution**2)


def count_disc(resolution: float) -> List[Tuple[int, int]]:
    """Offsets of the 3*res disc the slope/roughness count vetoes scan."""
    return [tuple(o) for o in circle_offsets(3.0 * resolution, resolution).tolist()]


def _count_veto_ok(layer: torch.Tensor, resolution: float, n_critical: int) -> torch.Tensor:
    """A zero cell fails iff the count of zero cells in the 3*res disc
    exceeds n_critical. The disc count is a horizontal box sum per distinct
    row span, then a vertical combine; counts are small integers in float32,
    so any grouping is exact. NaN layer values are not zero."""
    is_zero = layer == 0.0
    zf = is_zero.to(torch.float32)
    rows: Dict[int, List[int]] = {}
    for di, dj in count_disc(resolution):
        rows.setdefault(int(di), []).append(int(dj))
    box_cache: Dict[Tuple[int, int], torch.Tensor] = {}
    count = torch.zeros_like(zf)
    for di in sorted(rows):
        djs = sorted(rows[di])
        key = (djs[0], djs[-1])
        if key not in box_cache:
            acc = torch.zeros_like(zf)
            for dj in range(key[0], key[1] + 1):
                acc = acc + (zf if dj == 0 else _shifted(zf, 0, dj, 0.0))
            box_cache[key] = acc
        b = box_cache[key]
        count = count + (b if di == 0 else _shifted(b, di, 0, 0.0))
    fail = is_zero & (count > f32(n_critical))
    return ~fail


def _ray_directions(cfg: VetoConfig) -> List[Tuple[int, int, int]]:
    """(di, dj, K) for the 8 walk directions; K = number of line cells beyond
    the candidate. Mirrors the reference's walk bound
    ``(k+1)*|vec| < max_gap_width``; directions with |d|*res < 0.025 are
    skipped by its minimum-vector guard."""
    out = []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di == 0 and dj == 0:
                continue
            step_len = math.hypot(di, dj) * cfg.resolution
            if step_len < 0.025:
                continue
            k = max(1, math.ceil(cfg.max_gap_width / step_len - 1e-12) - 1)
            out.append((di, dj, k))
    return out


def candidate_sectors(cfg: VetoConfig) -> List[Tuple[int, int, Tuple[int, ...]]]:
    """(oi, oj, allowed direction indices) for every candidate offset of the
    2.5*res disc but the center, in disc order. A walk direction d is
    allowed from candidate o iff o . d <= 0, or for every direction when
    |o|*res <= 0.025 (the reference skips its filter there)."""
    dirs = _ray_directions(cfg)
    out = []
    for oi, oj in circle_offsets(2.5 * cfg.resolution, cfg.resolution).tolist():
        if oi == 0 and oj == 0:
            continue
        to_center_small = math.hypot(oi, oj) * cfg.resolution <= 0.025
        allowed = tuple(
            d_idx for d_idx, (di, dj, _) in enumerate(dirs)
            if to_center_small or (oi * di + oj * dj) <= 0
        )
        out.append((int(oi), int(oj), allowed))
    return out


def step_veto_ok(
    elevation: torch.Tensor,
    step_layer: torch.Tensor,
    cfg: VetoConfig,
    in_map: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """checkForStep as a dense field, sentinel-folded.

    ``selev`` = elevation where the cell is a legal drop/candidate cell
    (step == 0, inside the global map), NaN otherwise. ``welev`` = elevation
    with in-map invalid cells coded -inf ("gap") and out-of-map cells coded
    NaN ("walk ends"); NaN compares false everywhere.

    Per cell q with step == 0: candidate cells c in a 2.5*res circle higher
    than q by the critical step (fallback: q itself); per candidate, 8
    bounded ray walks relative to the candidate's elevation; a ray fails on a
    blocking wall before the gap closes, or on a gap that never closes
    within max_gap_width. q is untraversable iff any active (candidate, ray)
    fails. `in_map` marks cells inside the global map (None: all of them).
    """
    elev = elevation.to(torch.float32)
    step0 = step_layer == 0.0
    crit = f32(cfg.critical_step_height)
    nan = float("nan")

    if in_map is None:
        selev = torch.where(step0, elev, nan)
        welev = torch.where(torch.isfinite(elev), elev, -math.inf)
    else:
        selev = torch.where(step0 & in_map, elev, nan)
        welev = torch.where(
            in_map, torch.where(torch.isfinite(elev), elev, -math.inf), nan
        )

    ray_fail = []
    for di, dj, K in _ray_directions(cfg):
        h = elev
        trigger = _shifted(selev, di, dj, nan) < h - crit
        gap_started = torch.zeros(elev.shape, dtype=torch.bool, device=elev.device)
        ended = torch.zeros_like(gap_started)
        wall_fail = torch.zeros_like(gap_started)
        any_gap = torch.zeros_like(gap_started)
        for t in range(1, K + 1):
            w_t = _shifted(welev, di * t, dj * t, nan)
            wall_t = w_t > h + crit  # NaN/-inf -> False
            gap_t = w_t < h - crit  # -inf -> True, NaN -> False
            mid_t = ~torch.isnan(w_t) & ~wall_t & ~gap_t
            end_t = mid_t & gap_started & ~ended
            # wall cells checked only until the walk breaks at the gap end
            wall_fail = wall_fail | (wall_t & ~ended)
            any_gap = any_gap | (gap_t & ~ended)
            gap_started = gap_started | gap_t
            ended = ended | end_t
        unclosed = any_gap & ~ended
        ray_fail.append(trigger & (wall_fail | unclosed))

    sectors: Dict[Tuple[int, ...], List[Tuple[int, int]]] = {}
    for oi, oj, allowed in candidate_sectors(cfg):
        sectors.setdefault(allowed, []).append((oi, oj))
    has_cand = torch.zeros(elev.shape, dtype=torch.bool, device=elev.device)
    fail_from_cand = torch.zeros_like(has_cand)
    for allowed, offs in sectors.items():
        plane = torch.zeros_like(has_cand)
        for d_idx in allowed:
            plane = plane | ray_fail[d_idx]
        for oi, oj in offs:
            active = _shifted(selev, oi, oj, nan) > elev + crit
            has_cand = has_cand | active
            fail_from_cand = fail_from_cand | (active & _shifted(plane, oi, oj, False))

    # self-fallback (no candidate): all directions allowed, relative to self
    fail_self = torch.zeros_like(has_cand)
    for rf in ray_fail:
        fail_self = fail_self | rf

    fail = step0 & (fail_from_cand | (~has_cand & fail_self))
    return ~fail


def step_veto_ok_v1(
    elevation: torch.Tensor,
    step_layer: torch.Tensor,
    cfg: VetoConfig,
    in_map: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """checkForStep as a dense field in the bool-plane formulation: the JAX
    package's retained referee of the sentinel-folded ``step_veto_ok``,
    which it must equal cell for cell.

    Triggers, walks and candidates test ``in_map``, ``step == 0`` and the
    elevation as separate planes instead of reading them folded into
    ``selev`` / ``welev``; a non-finite in-map cell is a gap, an out-of-map
    cell ends the walk.
    """
    elev = elevation.to(torch.float32)
    step0 = step_layer == 0.0
    crit = f32(cfg.critical_step_height)
    nan = float("nan")
    if in_map is None:
        in_map = torch.ones(elev.shape, dtype=torch.bool, device=elev.device)

    dirs = _ray_directions(cfg)
    ray_fail = []
    for di, dj, K in dirs:
        h = elev
        trigger = (
            _shifted(in_map, di, dj, False)
            & _shifted(step0, di, dj, False)
            & (_shifted(elev, di, dj, nan) < h - crit)
        )
        gap_started = torch.zeros_like(step0)
        ended = torch.zeros_like(step0)
        wall_fail = torch.zeros_like(step0)
        any_gap = torch.zeros_like(step0)
        for t in range(1, K + 1):
            e_t = _shifted(elev, di * t, dj * t, nan)
            active = _shifted(in_map, di * t, dj * t, False)  # the walk stops at the map's edge
            wall_t = active & (e_t > h + crit)
            gap_t = active & ((e_t < h - crit) | ~torch.isfinite(e_t))
            mid_t = active & ~wall_t & ~gap_t
            end_t = mid_t & gap_started & ~ended
            wall_fail = wall_fail | (wall_t & ~ended)
            any_gap = any_gap | (gap_t & ~ended)
            gap_started = gap_started | gap_t
            ended = ended | end_t
        ray_fail.append(trigger & (wall_fail | (any_gap & ~ended)))

    has_cand = torch.zeros_like(step0)
    fail_from_cand = torch.zeros_like(step0)
    for oi, oj, allowed in candidate_sectors(cfg):
        plane = torch.zeros_like(step0)
        for d_idx in allowed:
            plane = plane | ray_fail[d_idx]
        active = (
            _shifted(in_map, oi, oj, False)
            & _shifted(step0, oi, oj, False)
            & (_shifted(elev, oi, oj, nan) > elev + crit)
        )
        has_cand = has_cand | active
        fail_from_cand = fail_from_cand | (active & _shifted(plane, oi, oj, False))

    fail_self = torch.zeros_like(step0)
    for rf in ray_fail:
        fail_self = fail_self | rf
    fail = step0 & ((has_cand & fail_from_cand) | (~has_cand & fail_self))
    return ~fail


def compute_veto_fields(
    layers: Dict[str, torch.Tensor],
    cfg: VetoConfig,
    in_map: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """All veto fields + the combined traversable mask.

    Input layers: elevation, traversability_slope, traversability_step
    (+ traversability_roughness when cfg.check_roughness). Returns bool
    planes slope_ok / step_ok / (roughness_ok) / traversable_mask and the
    float ``*_footprint`` layers (1.0 pass, 0.0 fail, NaN where the layer is
    nonzero, i.e. where the reference never computes them)."""
    res = cfg.resolution
    slope_ok = _count_veto_ok(layers["traversability_slope"], res, cfg.slope_n_critical)
    step_ok = step_veto_ok(layers["elevation"], layers["traversability_step"], cfg, in_map)
    out: Dict[str, torch.Tensor] = {"slope_ok": slope_ok, "step_ok": step_ok}
    mask = slope_ok & step_ok
    if cfg.check_roughness:
        rough_ok = _count_veto_ok(
            layers["traversability_roughness"], res, cfg.roughness_n_critical
        )
        out["roughness_ok"] = rough_ok
        mask = mask & rough_ok
    out["traversable_mask"] = mask
    out.update(footprint_layers(layers, out, cfg))
    return out


def footprint_layers(
    layers: Dict[str, torch.Tensor], veto: Dict[str, torch.Tensor], cfg: VetoConfig
) -> Dict[str, torch.Tensor]:
    """The float ``*_footprint`` parity layers from the veto planes."""
    nan = float("nan")
    pairs = [("slope", "traversability_slope"), ("step", "traversability_step")]
    if cfg.check_roughness:
        pairs.append(("roughness", "traversability_roughness"))
    return {
        f"{name}_footprint": torch.where(
            layers[layer] == 0.0, veto[f"{name}_ok"].to(torch.float32), nan
        )
        for name, layer in pairs
    }


def required_halo(chain_cfg: ChainConfig, veto_cfg: VetoConfig) -> int:
    """Halo width in cells covering every stencil's reach of the update
    (chain windows, then the count window and the candidate circle plus the
    bounded gap walk); 14 cells at the defaults."""
    res = chain_cfg.resolution
    chain_reach = max(
        int(math.floor(chain_cfg.normals_radius / res + 1e-9)),
        int(math.floor(chain_cfg.step_first_window_radius / res + 1e-9))
        + int(math.floor(chain_cfg.step_second_window_radius / res + 1e-9)),
        int(math.floor(chain_cfg.roughness_estimation_radius / res + 1e-9)),
    ) + 1
    cand = int(math.floor(2.5 + 1e-9))
    walk = max(k for _, _, k in _ray_directions(veto_cfg))
    count_window = 3
    veto_reach = max(count_window, cand + walk)
    return chain_reach + veto_reach
