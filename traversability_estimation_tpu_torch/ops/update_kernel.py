"""The map update (filter chain + dense veto fields) and its CUDA kernels.

``fused_update`` is the update the estimator runs: on a CUDA tensor it
launches kernel 1 (``csrc/fused_update.cu``, the port of the TPU kernel
``ops/pallas_chain.py::fused_update``: a layers kernel, then a veto kernel);
on a CPU tensor it runs ``fused_update_plain``, the same function as
whole-plane torch ops, which is also the kernels' referee on the card.

Both return the layer set of the JAX ``_update_step``: the chain layers,
``slope_ok`` / ``step_ok`` / (``roughness_ok``) / ``traversable_mask`` and
the float ``*_footprint`` layers. On CUDA the kernels write every one of
them; nothing else runs. The launch geometry (``launch_plan``) is computed
here, on the host, so the CPU tests reach it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from traversability_estimation_tpu_torch.grid.geometry import circle_offsets, global_in_map
from traversability_estimation_tpu_torch.kernels import build
from traversability_estimation_tpu_torch.ops import expr, filters, veto
from traversability_estimation_tpu_torch.ops.filters import ChainConfig, f32, rcp
from traversability_estimation_tpu_torch.ops.veto import VetoConfig

# the kernels' tiles, one cell per thread, and the capacities of their
# stencil tables and of the fusion program (csrc/fused_update.cu checks every
# launch plan against its own tiles; the caps fix the size of FusedParams,
# checked at load)
TILE_W = 32
TILE_H = (8, 16)  # layers kernel, veto kernel
MAX_WIN, MAX_COUNT, MAX_CAND, MAX_DIRS, MAX_FUSE = 32, 128, 64, 8, 8
MAX_PROG, MAX_STACK = expr.MAX_PROG, expr.MAX_STACK
SMEM_LIMIT = 232_448  # dynamic + static shared memory one block may use on an H100

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
    """Mirror of ``struct FusedParams`` in csrc/fused_update.cu (every field
    4 bytes wide but the program's opcodes, MAX_PROG single bytes, so the
    layouts agree without padding)."""

    _fields_ = [
        ("halo", ctypes.c_int), ("r_sh", ctypes.c_int),
        ("r_mid", ctypes.c_int), ("r_ray", ctypes.c_int),
        ("n_mom_n", ctypes.c_int), ("n_mom_r", ctypes.c_int),
        ("rough_shared", ctypes.c_int), ("compute_roughness", ctypes.c_int),
        ("check_roughness", ctypes.c_int),
        ("n_s1", ctypes.c_int), ("n_s2", ctypes.c_int), ("n_cnt", ctypes.c_int),
        ("n_dirs", ctypes.c_int), ("n_cand", ctypes.c_int), ("n_fuse", ctypes.c_int),
        ("n_prog", ctypes.c_int),
        ("mom_n", _ints(2 * MAX_WIN)), ("mom_n_d", _floats(2 * MAX_WIN)),
        ("mom_r", _ints(2 * MAX_WIN)), ("mom_r_d", _floats(2 * MAX_WIN)),
        ("s1", _ints(2 * MAX_WIN)), ("s2", _ints(2 * MAX_WIN)),
        ("cnt", _ints(2 * MAX_COUNT)),
        ("dirs", _ints(3 * MAX_DIRS)),
        ("cand", _ints(3 * MAX_CAND)),
        ("fuse_layer", _ints(MAX_FUSE)), ("fuse_w", _floats(MAX_FUSE)),
        ("prog_op", ctypes.c_uint8 * MAX_PROG), ("prog_arg", _floats(MAX_PROG)),
        ("slope_crit", ctypes.c_float), ("slope_rcp", ctypes.c_float),
        ("step_crit", ctypes.c_float), ("step_rcp", ctypes.c_float),
        ("ccn_rcp", ctypes.c_float), ("rough_crit", ctypes.c_float),
        ("rough_rcp", ctypes.c_float), ("veto_crit", ctypes.c_float),
        ("slope_ncrit", ctypes.c_float), ("rough_ncrit", ctypes.c_float),
        ("gi0", ctypes.c_int), ("gj0", ctypes.c_int), ("gh", ctypes.c_int), ("gw", ctypes.c_int),
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


def fusion_program(chain_cfg: ChainConfig) -> Tuple[Tuple[int, ...], Tuple[float, ...]]:
    """The postfix program ``(ops, args)`` of the configuration's fusion
    expression for kernel 1, empty without one. Its variables are the layers
    the chain produces, numbered as the kernel numbers them. Raises
    ExpressionError for any other name, and ValueError for a program the
    kernel cannot hold."""
    if not chain_cfg.fusion_expression:
        return (), ()
    layers = [
        k for k in _FUSE_LAYERS
        if chain_cfg.compute_roughness or k != "traversability_roughness"
    ]
    ops, args = expr.to_program(expr.parse(chain_cfg.fusion_expression), layers)
    if len(ops) > MAX_PROG:
        raise ValueError(
            f"fused_update: the fusion expression compiles to {len(ops)} program entries, "
            f"more than the kernel's cap of {MAX_PROG}"
        )
    depth = expr.stack_depth(ops)
    if depth > MAX_STACK:
        raise ValueError(
            f"fused_update: the fusion expression needs a stack of {depth} values, "
            f"more than the kernel's cap of {MAX_STACK}"
        )
    return ops, args


@functools.lru_cache(maxsize=None)
def kernel_params(chain_cfg: ChainConfig, veto_cfg: VetoConfig) -> FusedParams:
    """The kernel's parameter block: stencil tables, stage reaches and
    float32 constants, all derived on the host exactly as the plain version
    derives them. Shared: ``fused_update`` sets the map frame on a copy."""
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
    ops, args = fusion_program(chain_cfg)
    p.n_prog = _fill(p.prog_op, [(op,) for op in ops], MAX_PROG, "fusion program entries")
    _fill(p.prog_arg, [(a,) for a in args], MAX_PROG, "")

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

    # reaches (cells beyond the output tile each kernel's planes must cover)
    r_cand = _reach([(oi, oj) for oi, oj, _ in cand])
    walk = max((k * max(abs(di), abs(dj)) for di, dj, k in dirs), default=0)
    p.r_sh = _reach(s2)
    p.halo = max(
        p.r_sh + _reach(s1),
        _reach(mom_n),
        _reach(mom_r) if chain_cfg.compute_roughness else 0,
        walk,
    )
    p.r_ray = r_cand
    p.r_mid = max(r_cand + (1 if dirs else 0), _reach(cnt))
    return p


def _frame(shape, origin, global_shape) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """(origin, global shape) of an (H, W) array in its map; the defaults
    (0, 0) and None make the array the whole map."""
    gi0, gj0 = (int(v) for v in origin)
    gh, gw = (int(v) for v in (shape if global_shape is None else global_shape))
    return (gi0, gj0), (gh, gw)


def fused_update_plain(
    elevation: torch.Tensor,
    chain_cfg: ChainConfig,
    veto_cfg: VetoConfig,
    origin: Tuple[int, int] = (0, 0),
    global_shape: Optional[Tuple[int, int]] = None,
) -> Dict[str, torch.Tensor]:
    """The update as whole-plane torch ops (the JAX ``_update_step``).

    `origin` and `global_shape` place the array in a larger map, as a tile
    with its halo: array cell (i, j) is map cell (i + origin[0], j +
    origin[1]) of a `global_shape` map (default: the array is the map).
    Cells beyond the map hold no elevation (NaN) and end the step veto's
    walk: the JAX tile body's ``in_map`` plane (``parallel/sharding.py``)."""
    elevation = elevation.to(torch.float32)
    origin, global_shape = _frame(elevation.shape, origin, global_shape)
    in_map = None
    if origin != (0, 0) or global_shape != tuple(elevation.shape):
        in_map = global_in_map(elevation.shape, origin, global_shape, elevation.device)
        elevation = torch.where(in_map, elevation, math.nan)
    layers = filters.run_chain(elevation, chain_cfg)
    veto_in = {
        "elevation": elevation,
        "traversability_slope": layers["traversability_slope"],
        "traversability_step": layers["traversability_step"],
    }
    if veto_cfg.check_roughness:
        veto_in["traversability_roughness"] = layers["traversability_roughness"]
    layers.update(veto.compute_veto_fields(veto_in, veto_cfg, in_map))
    return layers


@dataclasses.dataclass(frozen=True)
class UpdatePlan:
    """The two launches of kernel 1: each one's grid (x over columns, y over
    rows) and block, and each kernel's dynamic shared memory (planes) and
    static shared memory (linear tap tables)."""

    grid_layers: Tuple[int, int]
    block_layers: Tuple[int, int]
    grid_veto: Tuple[int, int]
    block_veto: Tuple[int, int]
    smem_layers: int
    smem_veto: int
    static_layers: int = 4 * (4 * MAX_WIN + MAX_DIRS)
    static_veto: int = 4 * (MAX_COUNT + MAX_CAND + MAX_DIRS)

    @property
    def warps(self) -> Tuple[int, int]:
        """Warps each launch starts (layers, vetoes), over all its blocks."""
        return tuple(
            g[0] * g[1] * -(-b[0] * b[1] // 32)
            for g, b in ((self.grid_layers, self.block_layers), (self.grid_veto, self.block_veto))
        )

    def as_c_ints(self):
        """The plan as ``te_fused_update`` takes it: per launch (layers,
        vetoes) grid x, y, block x, y and dynamic shared memory."""
        return (ctypes.c_int * 10)(
            *self.grid_layers, *self.block_layers, self.smem_layers,
            *self.grid_veto, *self.block_veto, self.smem_veto,
        )


def launch_plan(params: FusedParams, H: int, W: int) -> UpdatePlan:
    """Kernel 1's launches for an (H, W) map. The layers kernel holds the
    walk-coded elevation window (tile + halo) and the step-height plane
    (tile + r_sh) in f32; the veto kernel the raw elevation and candidate
    planes (f32) and the zero-flag and ray-bit planes (u8), all over the
    tile + r_mid. Raises where a block would need more shared memory than
    the card has."""
    th_l, th_v = TILE_H

    def plane(reach, th):
        return (TILE_W + 2 * reach) * (th + 2 * reach)

    plan = UpdatePlan(
        grid_layers=(-(-W // TILE_W), -(-H // th_l)),
        block_layers=(TILE_W, th_l),
        grid_veto=(-(-W // TILE_W), -(-H // th_v)),
        block_veto=(TILE_W, th_v),
        smem_layers=4 * (plane(params.halo, th_l) + plane(params.r_sh, th_l)),
        smem_veto=(2 * 4 + 2) * plane(params.r_mid, th_v),
    )
    need = max(plan.smem_layers + plan.static_layers, plan.smem_veto + plan.static_veto)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"fused_update: the stencils' reach (halo {params.halo}) needs {need} bytes of "
            f"shared memory per block, more than the {SMEM_LIMIT} an H100 block has"
        )
    return plan


_lib = None


def library() -> ctypes.CDLL:
    """Kernel 1's library, built at first use, with its C interface."""
    global _lib
    if _lib is None:
        lib = build.load("fused_update")
        ptr = ctypes.c_void_p
        lib.te_fused_update.argtypes = [
            ptr, ctypes.c_int, ctypes.c_int, ctypes.POINTER(FusedParams),
            ctypes.POINTER(ctypes.c_int), *([ptr] * 13),
        ]
        lib.te_fused_update.restype = ctypes.c_int
        lib.te_fused_update_params_size.restype = ctypes.c_int
        lib.te_fused_update_occupancy.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.te_fused_update_occupancy.restype = ctypes.c_int
        lib.te_fused_update_error_string.argtypes = [ctypes.c_int]
        lib.te_fused_update_error_string.restype = ctypes.c_char_p
        if lib.te_fused_update_params_size() != ctypes.sizeof(FusedParams):
            raise RuntimeError("FusedParams layout differs between Python and CUDA")
        _lib = lib
    return _lib


def fused_update(
    elevation: torch.Tensor,
    chain_cfg: ChainConfig,
    veto_cfg: VetoConfig,
    origin: Tuple[int, int] = (0, 0),
    global_shape: Optional[Tuple[int, int]] = None,
) -> Dict[str, torch.Tensor]:
    """The map update. CPU tensor: the plain version. CUDA tensor: kernel 1,
    which writes every layer. `origin` and `global_shape` place the array in
    a larger map (``fused_update_plain``); the kernel tests each cell against
    them. ``fused_update.launches`` counts updates that ran kernel 1 (each is
    two kernel launches: layers, then vetoes)."""
    if elevation.device.type == "cpu":
        return fused_update_plain(elevation, chain_cfg, veto_cfg, origin, global_shape)
    if elevation.device.type != "cuda" or elevation.dim() != 2:
        raise ValueError("fused_update kernel: needs an (H, W) CUDA tensor")
    params = FusedParams.from_buffer_copy(kernel_params(chain_cfg, veto_cfg))
    elev = elevation.to(torch.float32).contiguous()
    H, W = elev.shape
    (params.gi0, params.gj0), (params.gh, params.gw) = _frame((H, W), origin, global_shape)
    plan = launch_plan(params, H, W)
    rough = chain_cfg.compute_roughness
    check = veto_cfg.check_roughness
    dev = elev.device

    def plane(dtype):
        return torch.empty((H, W), dtype=dtype, device=dev)

    f32_names = ["traversability", "traversability_slope", "traversability_step"]
    f32_names += ["traversability_roughness"] if rough else []
    ok_names = ["slope_ok", "step_ok"] + (["roughness_ok"] if check else []) + ["traversable_mask"]
    fp_names = ["slope_footprint", "step_footprint"] + (["roughness_footprint"] if check else [])
    out = {n: plane(torch.float32) for n in f32_names + fp_names}
    out.update({n: plane(torch.bool) for n in ok_names})
    if H * W == 0:
        return out
    walk = plane(torch.uint8)

    def ptr(name):
        return out[name].data_ptr() if name in out else None

    lib = library()
    with torch.cuda.device(dev):
        rc = lib.te_fused_update(
            elev.data_ptr(), H, W, ctypes.byref(params), plan.as_c_ints(),
            *(ptr(n) for n in ("traversability", "traversability_slope",
                               "traversability_step", "traversability_roughness")),
            walk.data_ptr(),
            *(ptr(n) for n in ("slope_ok", "step_ok", "roughness_ok", "traversable_mask",
                               "slope_footprint", "step_footprint", "roughness_footprint")),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_update kernel: {lib.te_fused_update_error_string(rc).decode()}")
    build.count_launch(fused_update)
    return out


fused_update.launches = 0


def occupancy(plan: UpdatePlan) -> Tuple[int, int]:
    """Resident blocks per SM of the layers and the veto kernel for this
    plan."""
    lib = library()
    return (lib.te_fused_update_occupancy(0, plan.smem_layers),
            lib.te_fused_update_occupancy(1, plan.smem_veto))


def kernel_bytes(chain_cfg: ChainConfig, veto_cfg: VetoConfig, H: int, W: int) -> int:
    """Bytes kernel 1 must move: the elevation read once; the f32 layers,
    the uint8 ``*_ok`` and mask planes and the f32 ``*_footprint`` layers
    written once (the ray-walk scratch plane between its two launches is
    not counted)."""
    n_f32 = 4 if chain_cfg.compute_roughness else 3
    n_ok = 4 if veto_cfg.check_roughness else 3
    return H * W * (4 + 4 * n_f32 + n_ok + 4 * (n_ok - 1))


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
    # each program entry that is not a push is one operation
    fusion = sum(op > expr.OP_LAYER for op in p.prog_op[: p.n_prog]) if p.n_prog else 2 * p.n_fuse
    counts = 2 * p.n_cnt * (2 if p.check_roughness else 1)
    walk = sum(3 + 4 * p.dirs[3 * d + 2] for d in range(p.n_dirs)) + 2
    candidates = 2 * p.n_cand + 1
    per_cell = (
        moments + covariance + jacobi + slope + step + rough + fusion + counts
        + walk + candidates
    )
    return per_cell * H * W

