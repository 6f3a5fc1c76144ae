"""The map update (filter chain + dense veto fields) and its CUDA kernel.

``fused_update`` is the update the estimator runs: on a CUDA tensor it
launches kernel 1 (``csrc/fused_update.cu``, the port of the TPU kernel
``ops/pallas_chain.py::fused_update``); on a CPU tensor it runs
``fused_update_plain``, the same function as whole-plane torch ops, which
is also the kernel's referee on the card.

Both return the layer set of the JAX ``_update_step``: the chain layers,
``slope_ok`` / ``step_ok`` / (``roughness_ok``) / ``traversable_mask`` and
the float ``*_footprint`` layers.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from traversability_estimation_tpu_torch.grid.geometry import circle_offsets
from traversability_estimation_tpu_torch.kernels import build
from traversability_estimation_tpu_torch.ops import filters, veto
from traversability_estimation_tpu_torch.ops.filters import ChainConfig, f32, rcp
from traversability_estimation_tpu_torch.ops.veto import VetoConfig

# capacities of the kernel's stencil tables (csrc/fused_update.cu)
MAX_WIN, MAX_COUNT, MAX_CAND, MAX_DIRS, MAX_FUSE = 32, 128, 64, 8, 8
TILE = 32

_FUSE_LAYERS = {
    "traversability_slope": 0,
    "traversability_step": 1,
    "traversability_roughness": 2,
}


def _ints(n):
    return ctypes.c_int * n


def _floats(n):
    return ctypes.c_float * n


class FusedParams(ctypes.Structure):
    """Mirror of ``struct FusedParams`` in csrc/fused_update.cu (all fields
    4 bytes wide, so the layouts agree without padding)."""

    _fields_ = [
        ("halo", ctypes.c_int), ("r_sh", ctypes.c_int),
        ("r_mid", ctypes.c_int), ("r_ray", ctypes.c_int),
        ("n_mom_n", ctypes.c_int), ("n_mom_r", ctypes.c_int),
        ("rough_shared", ctypes.c_int), ("compute_roughness", ctypes.c_int),
        ("check_roughness", ctypes.c_int),
        ("n_s1", ctypes.c_int), ("n_s2", ctypes.c_int), ("n_cnt", ctypes.c_int),
        ("n_dirs", ctypes.c_int), ("n_cand", ctypes.c_int), ("n_fuse", ctypes.c_int),
        ("mom_n", _ints(2 * MAX_WIN)), ("mom_n_d", _floats(2 * MAX_WIN)),
        ("mom_r", _ints(2 * MAX_WIN)), ("mom_r_d", _floats(2 * MAX_WIN)),
        ("s1", _ints(2 * MAX_WIN)), ("s2", _ints(2 * MAX_WIN)),
        ("cnt", _ints(2 * MAX_COUNT)),
        ("dirs", _ints(3 * MAX_DIRS)),
        ("cand", _ints(3 * MAX_CAND)),
        ("fuse_layer", _ints(MAX_FUSE)), ("fuse_w", _floats(MAX_FUSE)),
        ("slope_crit", ctypes.c_float), ("slope_rcp", ctypes.c_float),
        ("step_crit", ctypes.c_float), ("step_rcp", ctypes.c_float),
        ("ccn_rcp", ctypes.c_float), ("rough_crit", ctypes.c_float),
        ("rough_rcp", ctypes.c_float), ("veto_crit", ctypes.c_float),
        ("slope_ncrit", ctypes.c_float), ("rough_ncrit", ctypes.c_float),
    ]


def _fill(arr, rows, cap: int, what: str) -> int:
    flat = [x for row in rows for x in row]
    if len(rows) > cap:
        raise ValueError(f"fused_update: {len(rows)} {what} exceed the kernel's cap of {cap}")
    for i, x in enumerate(flat):
        arr[i] = x
    return len(rows)


def _reach(offsets) -> int:
    return max((max(abs(int(a)), abs(int(b))) for a, b in offsets), default=0)


@functools.lru_cache(maxsize=None)
def kernel_params(chain_cfg: ChainConfig, veto_cfg: VetoConfig) -> FusedParams:
    """The kernel's parameter block: stencil tables, stage reaches and
    float32 constants, all derived on the host exactly as the plain version
    derives them."""
    if veto_cfg.check_roughness and not chain_cfg.compute_roughness:
        raise ValueError("check_roughness needs chain.compute_roughness")
    res = chain_cfg.resolution
    p = FusedParams()
    mom_n = circle_offsets(chain_cfg.normals_radius, res).tolist()
    mom_r = circle_offsets(chain_cfg.roughness_estimation_radius, res).tolist()
    s1 = circle_offsets(chain_cfg.step_first_window_radius, res).tolist()
    s2 = circle_offsets(chain_cfg.step_second_window_radius, res).tolist()
    cnt = veto.count_disc(veto_cfg.resolution)
    dirs = veto._ray_directions(veto_cfg)
    cand = veto.candidate_sectors(veto_cfg)

    p.n_mom_n = _fill(p.mom_n, mom_n, MAX_WIN, "normals offsets")
    _fill(p.mom_n_d, [(f32(-di * res), f32(-dj * res)) for di, dj in mom_n], MAX_WIN, "")
    p.compute_roughness = int(chain_cfg.compute_roughness)
    p.rough_shared = int(filters.shares_moments(chain_cfg))
    if chain_cfg.compute_roughness and not p.rough_shared:
        p.n_mom_r = _fill(p.mom_r, mom_r, MAX_WIN, "roughness offsets")
        _fill(p.mom_r_d, [(f32(-di * res), f32(-dj * res)) for di, dj in mom_r], MAX_WIN, "")
    p.check_roughness = int(veto_cfg.check_roughness)
    p.n_s1 = _fill(p.s1, s1, MAX_WIN, "step window offsets")
    p.n_s2 = _fill(p.s2, s2, MAX_WIN, "step window offsets")
    p.n_cnt = _fill(p.cnt, cnt, MAX_COUNT, "count-veto offsets")
    p.n_dirs = _fill(p.dirs, dirs, MAX_DIRS, "ray directions")
    masks = [(oi, oj, sum(1 << d for d in allowed)) for oi, oj, allowed in cand]
    p.n_cand = _fill(p.cand, masks, MAX_CAND, "candidate offsets")
    terms = filters.fusion_terms(chain_cfg)
    p.n_fuse = _fill(
        p.fuse_layer, [(_FUSE_LAYERS[k],) for k, _ in terms], MAX_FUSE, "fusion terms"
    )
    _fill(p.fuse_w, [(w,) for _, w in terms], MAX_FUSE, "")

    p.slope_crit = f32(chain_cfg.slope_critical_value)
    p.slope_rcp = rcp(chain_cfg.slope_critical_value)
    p.step_crit = f32(chain_cfg.step_critical_value)
    p.step_rcp = rcp(chain_cfg.step_critical_value)
    p.ccn_rcp = rcp(float(chain_cfg.step_critical_cell_number))
    p.rough_crit = f32(chain_cfg.roughness_critical_value)
    p.rough_rcp = rcp(chain_cfg.roughness_critical_value)
    p.veto_crit = f32(veto_cfg.critical_step_height)
    p.slope_ncrit = f32(veto_cfg.slope_n_critical)
    p.rough_ncrit = f32(veto_cfg.roughness_n_critical)

    # stage reaches (cells beyond the output tile each stage must cover)
    r_cand = _reach([(oi, oj) for oi, oj, _ in cand])
    walk = max((k * max(abs(di), abs(dj)) for di, dj, k in dirs), default=0)
    p.r_ray = r_cand
    p.r_mid = max(r_cand + (1 if dirs else 0), _reach(cnt))
    p.r_sh = p.r_mid + _reach(s2)
    p.halo = max(
        p.r_sh + _reach(s1),
        p.r_mid + max(_reach(mom_n), _reach(mom_r) if chain_cfg.compute_roughness else 0),
        p.r_ray + walk,
    )
    return p


def fused_update_plain(
    elevation: torch.Tensor, chain_cfg: ChainConfig, veto_cfg: VetoConfig
) -> Dict[str, torch.Tensor]:
    """The update as whole-plane torch ops (the JAX ``_update_step``)."""
    elevation = elevation.to(torch.float32)
    layers = filters.run_chain(elevation, chain_cfg)
    veto_in = {
        "elevation": elevation,
        "traversability_slope": layers["traversability_slope"],
        "traversability_step": layers["traversability_step"],
    }
    if veto_cfg.check_roughness:
        veto_in["traversability_roughness"] = layers["traversability_roughness"]
    layers.update(veto.compute_veto_fields(veto_in, veto_cfg))
    return layers


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("fused_update")
        lib.te_fused_update.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.POINTER(FusedParams),
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.te_fused_update.restype = ctypes.c_int
        lib.te_fused_update_params_size.restype = ctypes.c_int
        lib.te_fused_update_error_string.argtypes = [ctypes.c_int]
        lib.te_fused_update_error_string.restype = ctypes.c_char_p
        if lib.te_fused_update_params_size() != ctypes.sizeof(FusedParams):
            raise RuntimeError("FusedParams layout differs between Python and CUDA")
        _lib = lib
    return _lib


def launch_kernel(
    elevation: torch.Tensor, chain_cfg: ChainConfig, veto_cfg: VetoConfig
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One launch of kernel 1 on a CUDA elevation plane: the four float
    layers and the uint8 veto bit plane (bit 0 slope_ok, 1 step_ok,
    2 roughness_ok, 3 traversable_mask)."""
    if elevation.device.type != "cuda" or elevation.dim() != 2:
        raise ValueError("fused_update kernel: needs an (H, W) CUDA tensor")
    params = kernel_params(chain_cfg, veto_cfg)
    elev = elevation.to(torch.float32).contiguous()
    H, W = elev.shape
    names = ("traversability", "traversability_slope", "traversability_step",
             "traversability_roughness")
    out = {n: torch.empty((H, W), dtype=torch.float32, device=elev.device) for n in names}
    bits = torch.empty((H, W), dtype=torch.uint8, device=elev.device)
    if H * W:
        lib = _library()
        with torch.cuda.device(elev.device):
            rc = lib.te_fused_update(
                elev.data_ptr(), H, W, ctypes.byref(params),
                *(out[n].data_ptr() for n in names), bits.data_ptr(),
                torch.cuda.current_stream(elev.device).cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(
                f"fused_update kernel: {lib.te_fused_update_error_string(rc).decode()}"
            )
        fused_update.launches += 1
    if not chain_cfg.compute_roughness:
        del out["traversability_roughness"]
    return out, bits


def fused_update(
    elevation: torch.Tensor, chain_cfg: ChainConfig, veto_cfg: VetoConfig
) -> Dict[str, torch.Tensor]:
    """The map update. CPU tensor: the plain version. CUDA tensor: one launch
    of kernel 1, then the ``*_ok`` planes unpacked from its veto bit plane and
    the ``*_footprint`` layers derived by torch elementwise ops."""
    if elevation.device.type == "cpu":
        return fused_update_plain(elevation, chain_cfg, veto_cfg)
    out, bits = launch_kernel(elevation, chain_cfg, veto_cfg)
    out["slope_ok"] = (bits & 1) != 0
    out["step_ok"] = (bits & 2) != 0
    if veto_cfg.check_roughness:
        out["roughness_ok"] = (bits & 4) != 0
    out["traversable_mask"] = (bits & 8) != 0
    out.update(veto.footprint_layers(out, out, veto_cfg))
    return out


fused_update.launches = 0


def kernel_bytes(H: int, W: int) -> int:
    """Bytes kernel 1 must move: the elevation read once, four f32 layers and
    the uint8 veto plane written once."""
    return H * W * (4 + 4 * 4 + 1)


def kernel_operations(chain_cfg: ChainConfig, veto_cfg: VetoConfig, H: int, W: int) -> int:
    """Float32 operations kernel 1 does for an (H, W) map, each stage counted
    once per cell (no halo recomputation): arithmetic, comparisons and
    square roots of the plain formulation; boolean logic is not counted."""
    p = kernel_params(chain_cfg, veto_cfg)
    moments = 23 * p.n_mom_n + (0 if p.rough_shared else 23 * p.n_mom_r)
    covariance = 22
    jacobi = 12 * 62 + 16  # 12 rotations, then the eigenvalue pick
    slope = 24
    step = 4 * p.n_s1 + 3 + 4 * p.n_s2 + 8
    rough = 46 if p.compute_roughness else 0
    fusion = 2 * p.n_fuse
    counts = 2 * p.n_cnt * (2 if p.check_roughness else 1)
    walk = sum(3 + 4 * p.dirs[3 * d + 2] for d in range(p.n_dirs)) + 2
    candidates = 2 * p.n_cand + 1
    per_cell = (
        moments + covariance + jacobi + slope + step + rough + fusion + counts
        + walk + candidates
    )
    return per_cell * H * W

