"""Speed-of-light accounting on the H100: the card's peaks, measured and
from the spec sheet, and the work counts of the two kernels' functions.

Two bounds are kept apart:

- the spec-sheet bound, ``bound(nbytes, ops)``: bytes over the data sheet's
  3.35 TB/s and float32 operations over its 67 TFLOP/s, the larger of the
  two, for the byte and operation counts the port's kernel wrappers give
  (``update_kernel.kernel_bytes`` / ``kernel_operations``,
  ``field_kernel.kernel_bytes`` / ``kernel_operations``);
- the measured bound, ``sol_report``: the JAX package's per-cell counts
  (``update_op_estimate``, ``circle_field_op_estimate``), whose arithmetic
  is copied here unchanged, priced at the peaks ``measure_peaks`` reads off
  this card. The counts depend on the configuration only, not on what
  implements it, so a kernel's bound reads the same work whichever package
  runs it.

Counting conventions (the JAX package's): one op per elementwise
arithmetic, compare, select or int add (an FMA is one op and two FLOPs), a
separate class for boolean mask ops, ZERO for a shifted-window read unless
a shift cost is given; the memory floor counts each input read once and
each output written once.

Peaks: ``peaks.cu`` (built by ``kernels/build.py`` like the kernels)
holds a chain of explicit FMAs, a chain of 3-input logic instructions and a
streaming copy; each measurement is the two-point slope of CUDA events over
two loop lengths (``profiling.adaptive_slope_stats``), so launch and
synchronisation costs cancel. A peak is a capability: ``measure_peaks``
keeps the best of its repeats. Every measurement needs the card.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from traversability_estimation_tpu_torch.device import DeviceLike, resolve_device
from traversability_estimation_tpu_torch.utils import profiling

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3
SM_CLOCK_MAX_HZ = 1.98e9  # the SXM part's boost clock
# 32-bit AND / OR / XOR results per SM per clock on compute capability 9.0
# (the CUDA C++ Programming Guide's arithmetic-instruction throughput table)
LOGIC_PER_SM_PER_CLOCK = 64

_THREADS = 256
_BLOCKS_PER_SM = 16
_COPY_FLOATS = 1 << 27  # 512 MB a plane, ten times the L2 cache


def bound(nbytes: float, ops: float, peak_flops: float = PEAK_F32_FLOPS,
          peak_bytes: float = PEAK_BYTES) -> Tuple[float, str]:
    """The least time in ms the card could take for `nbytes` moved and
    `ops` float32 operations, and what bounds it ("bytes" or
    "operations"): the larger of bytes over `peak_bytes` and operations
    over `peak_flops` (the data sheet's rates by default)."""
    t_bytes, t_ops = nbytes / peak_bytes, ops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def spec_peaks(device: DeviceLike = None) -> Dict[str, float]:
    """The spec sheet's peaks in ``measure_peaks``' names: float32 FLOP/s
    and HBM bytes/s from the data sheet, the logic-instruction rate from
    the per-SM throughput at the boost clock over this card's SMs."""
    dev = _card(device)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return {
        "vpu_f32_flops_per_s": PEAK_F32_FLOPS,
        "bool_ops_per_s": LOGIC_PER_SM_PER_CLOCK * n_sms * SM_CLOCK_MAX_HZ,
        "hbm_bytes_per_s": PEAK_BYTES,
    }


# ---------------------------------------------------------------------------
# measured peaks
# ---------------------------------------------------------------------------

_lib = None


def _card(device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the roofline's peaks are the card's: measure them on a CUDA device")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _peaks():
    global _lib
    if _lib is None:
        from traversability_estimation_tpu_torch.kernels import build

        lib = build.load("peaks")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.te_peaks_error_string.argtypes = [ci]
        lib.te_peaks_error_string.restype = ctypes.c_char_p
        lib.te_peaks_steps_per_iter.argtypes = []
        lib.te_peaks_steps_per_iter.restype = ci
        lib.te_peaks_fma.argtypes = [vp, ci, ci, ci, ctypes.c_float, ctypes.c_float, vp]
        lib.te_peaks_logic.argtypes = [vp, ci, ci, ci, ctypes.c_uint32, vp]
        lib.te_peaks_shift_sum.argtypes = [vp, vp, ci, ci, ci, vp, ci, ci, vp]
        lib.te_peaks_copy.argtypes = [vp, vp, ctypes.c_longlong, ci, ci, vp]
        for fn in (lib.te_peaks_fma, lib.te_peaks_logic, lib.te_peaks_shift_sum,
                   lib.te_peaks_copy):
            fn.restype = ci
        _lib = lib
    return _lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: {_peaks().te_peaks_error_string(err).decode()}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _chain_rate(kernel: str, k1: int, k2: int, device: DeviceLike) -> float:
    """Steps per second of one chain kernel over a grid that fills every SM."""
    dev = _card(device)
    lib = _peaks()
    blocks = _BLOCKS_PER_SM * torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(blocks * _THREADS, dtype=torch.float32, device=dev)

    def make(k):
        def run(o):
            if kernel == "fma":
                err = lib.te_peaks_fma(o.data_ptr(), blocks, _THREADS, k, 0.9999999, 1e-7,
                                       _stream(dev))
            else:
                err = lib.te_peaks_logic(o.data_ptr(), blocks, _THREADS, k, 12345, _stream(dev))
            _check(err, f"peaks {kernel}")
        return run

    with torch.cuda.device(dev):
        slope = profiling.adaptive_slope_stats(make, out, k1, k2, 5e-3, reps=3)["slope_s"]
    return lib.te_peaks_steps_per_iter() * blocks * _THREADS / slope


def measure_vpu_f32_flops(k1: int = 1000, k2: int = 5000, device: DeviceLike = None) -> float:
    """Measured float32 FMA throughput [FLOP/s]: eight independent chains of
    explicit FMAs per thread, 16 blocks of 256 threads per SM, the slope of
    two loop lengths (k1, k2 iterations of 128 FMAs a thread)."""
    return 2.0 * _chain_rate("fma", k1, k2, device)


def measure_vpu_bool_ops(k1: int = 1000, k2: int = 5000, device: DeviceLike = None) -> float:
    """Measured logic throughput [ops/s]: the same grid as the FMA probe with
    one 3-input logic instruction (lop3) per step, four truth tables in
    turn, each step reading two fresh operands so that no two steps fold
    into one instruction. One op is one logic instruction: the rate at
    which the card issues the mask logic of the update's veto walk."""
    return _chain_rate("logic", k1, k2, device)


def measure_hbm_bw(k1: int = 8, k2: int = 40, device: DeviceLike = None) -> float:
    """Measured device-memory read+write bandwidth [B/s]: a float4 copy of
    one 512 MB plane into another (ten times the L2 cache), the slope of
    two launch counts; each copy moves 2 x 512 MB."""
    dev = _card(device)
    lib = _peaks()
    blocks = _BLOCKS_PER_SM * torch.cuda.get_device_properties(dev).multi_processor_count
    src = torch.ones(_COPY_FLOATS, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)

    def make(k):
        def run(s):
            for _ in range(k):
                _check(lib.te_peaks_copy(s.data_ptr(), dst.data_ptr(), _COPY_FLOATS, blocks,
                                         _THREADS, _stream(dev)), "peaks copy")
        return run

    with torch.cuda.device(dev):
        slope = profiling.adaptive_slope_stats(make, src, k1, k2, 5e-3, reps=3)["slope_s"]
    return 2.0 * 4.0 * _COPY_FLOATS / slope


def measure_peaks(
    k1: int = 1000, k2: int = 5000, repeats: int = 3, device: DeviceLike = None
) -> Dict[str, float]:
    """The peaks block, one measurement feeding every roofline number.

    - ``vpu_f32_flops_per_s``: FMA-chain throughput in FLOP/s;
    - ``vpu_f32_ops_per_s``: FLOP/s / 2, the float32 issue rate at which
      every f32 op of the counts is priced (FMA or not);
    - ``bool_ops_per_s``: the logic-instruction issue rate;
    - ``hbm_bytes_per_s``: read+write streaming bandwidth.

    Each probe runs `repeats` times and the best is kept: a peak is a
    capability, so the estimator is the best observed rate.
    """
    flops = max(measure_vpu_f32_flops(k1, k2, device) for _ in range(repeats))
    bools = max(measure_vpu_bool_ops(k1, k2, device) for _ in range(repeats))
    hbm = max(measure_hbm_bw(device=device) for _ in range(repeats))
    return {
        "vpu_f32_flops_per_s": flops,
        "vpu_f32_ops_per_s": flops / 2.0,
        "bool_ops_per_s": bools,
        "bool_to_f32_ratio": round(bools / (flops / 2.0), 3),
        "hbm_bytes_per_s": hbm,
        "convention": (
            "FMA chain; ops = FLOPs/2 = issue rate (all f32 bounds price "
            "per-op at this); bool = 3-input logic-instruction chain; each "
            f"peak = max of {repeats} probe repeats (a capability, not a sample)"
        ),
    }


def _shift_sum_slope(shape, offsets: np.ndarray, pad: int, k1: int, k2: int,
                     device: DeviceLike) -> float:
    """Seconds per pass of ``len(offsets)`` shifted reads over an (H, W)
    plane (``peaks.cu``'s shift-sum kernel, slope over pass counts)."""
    dev = _card(device)
    lib = _peaks()
    H, W = shape
    rng = np.random.default_rng(0)
    padded = torch.as_tensor(
        rng.random((H + 2 * pad, W + 2 * pad)).astype(np.float32), device=dev)
    table = torch.as_tensor(np.concatenate([offsets, offsets]).astype(np.int32), device=dev)
    out = torch.empty((H, W), dtype=torch.float32, device=dev)

    def make(k):
        def run(p):
            _check(lib.te_peaks_shift_sum(p.data_ptr(), out.data_ptr(), H, W, pad,
                                          table.data_ptr(), len(offsets), k, _stream(dev)),
                   "peaks shift sum")
        return run

    with torch.cuda.device(dev):
        return profiling.adaptive_slope_stats(make, padded, k1, k2, 2e-3, reps=3)["slope_s"]


def measure_static_shift_cost(
    shape: tuple, n_shifts: int = 16, k1: int = 16, k2: int = 64,
    vpu_f32_ops_per_s: float | None = None, device: DeviceLike = None,
) -> float:
    """Seconds per shifted-plane read at `shape` on this card.

    The update's stencils read shifted neighbours. On the card a shifted
    read is a load at another address of a plane that sits in L1 / L2, not
    a relayout: this measures it as passes of `n_shifts` reads at the JAX
    probe's offsets (rows and columns in -3..3, never 0) over a padded
    (H, W) plane, one add each, the slope over pass counts. The add is
    charged at the f32 issue rate when `vpu_f32_ops_per_s` is given and
    taken off."""
    offs = np.array([((i % 7) - 3 or 1, (i % 5) - 2 or 1) for i in range(n_shifts)], np.int32)
    per_pass = _shift_sum_slope(shape, offs, 3, k1, k2, device)
    H, W = shape
    t_adds = n_shifts * H * W / vpu_f32_ops_per_s if vpu_f32_ops_per_s else 0.0
    return max(per_pass - t_adds, 0.0) / n_shifts


def measure_shift_floor(
    shape: tuple, n_offsets: int, pad: int, k1: int = 8, k2: int = 24,
    device: DeviceLike = None,
) -> float:
    """Seconds for `n_offsets` shifted reads of an (H, W) plane, one add
    each, at random offsets within `pad` of the cell: the read floor of a
    field kernel that walks `n_offsets` spiral offsets per cell in order
    (the slope over pass counts of ``peaks.cu``'s shift-sum kernel)."""
    rng = np.random.default_rng(0)
    offs = rng.integers(-pad, pad + 1, size=(n_offsets, 2)).astype(np.int32)
    return _shift_sum_slope(shape, offs, pad, k1, k2, device)


# ---------------------------------------------------------------------------
# analytic op counts (per cell): the JAX package's, unchanged
# ---------------------------------------------------------------------------


def _n_offsets(radius: float, resolution: float) -> int:
    from traversability_estimation_tpu_torch.grid.geometry import circle_offsets

    return len(circle_offsets(radius, resolution))


def update_op_estimate(chain_cfg, veto_cfg) -> Dict[str, float]:
    """Per-cell op / shifted-plane / byte counts of the fused update step
    (the filter chain + the dense veto fields), per stage, in three issue
    classes:

    - ``f32``: float arithmetic, comparisons, selects, int adds / ors;
    - ``bool``: and / or / xor mask ops;
    - ``shifts``: shifted-plane reads (priced only when ``sol_report`` is
      given a shift cost).

    The constants are the JAX package's instruction counts of its own loop
    bodies, kept unchanged so that both packages' kernels are held to the
    same work.
    """
    res = chain_cfg.resolution

    # surface normals: per offset ~12 arithmetic ops (centred z, 9 moment
    # accumulations, z*z) + 2 shifted reads (validity, elevation); finishing:
    # 6 covariance normalizations (~16), Jacobi 4 sweeps x 3 rotations x ~30
    # ops + eigenvector pick (~380 total)
    n_norm = _n_offsets(chain_cfg.normals_radius, res)
    st_normals = (12 * n_norm + 16 + 380, 0, 2 * n_norm)

    # slope: acos polynomial (8 FMAs + sqrt + selects ~14) + 1 - slope/critical (~4)
    st_slope = (18, 0, 0)

    # step: input planes 2 selects + isfinite; pass 1 per offset max + min (2
    # shifted reads); pass 2 per offset max + compare + select + add (1
    # shifted read); finishing ~11
    n_s1 = _n_offsets(chain_cfg.step_first_window_radius, res)
    n_s2 = _n_offsets(chain_cfg.step_second_window_radius, res)
    st_step = (3 + 2 * n_s1 + 4 * n_s2 + 11, 2, 2 * n_s1 + n_s2)

    # roughness: when its radius matches the normals radius the moment planes
    # are shared, so only the finishing math counts (~35: scatter-matrix
    # assembly, quadratic form, sqrt + map); otherwise the full moment loop
    n_rgh = (
        _n_offsets(chain_cfg.roughness_estimation_radius, res)
        if chain_cfg.compute_roughness
        else 0
    )
    moments_shared = (
        chain_cfg.compute_roughness
        and chain_cfg.roughness_estimation_radius == chain_cfg.normals_radius
    )
    if not chain_cfg.compute_roughness:
        st_rough = (0, 0, 0)
    elif moments_shared:
        st_rough = (35, 0, 0)
    else:
        st_rough = (12 * n_rgh + 30, 0, 2 * n_rgh)

    # fusion + NaN handling (~8)
    st_fuse = (8, 0, 0)

    # slope / roughness count vetoes (row-span box sums): the 3-cell disc as
    # box sums per distinct row span (10 column adds + column shifts) + a
    # vertical combine (6 row adds + row shifts); prep compare + cast, finish
    # compare + 2
    mult = 2 if veto_cfg.check_roughness else 1
    st_veto_cnt = ((10 + 6 + 5) * mult, 0, 16 * mult)

    # step veto (the sentinel-folded walk): sentinel planes ~6 f32 ops once;
    # per walk step 1 shifted read + 3 f32 compares + ~9 mask ops; triggers
    # 8 x (compare on a shifted read) + ~3 masks each; candidate combine per
    # non-centre offset 2 shifted reads + 2 compares + ~3 masks; sector planes
    # ~45 bool + casts; self-fallback 8 + final ~4
    from traversability_estimation_tpu_torch.ops.veto import _ray_directions

    walk_steps = sum(k for _, _, k in _ray_directions(veto_cfg))
    n_cand_nc = _n_offsets(2.5 * res, res) - 1  # (0,0) never a candidate
    st_walk = (
        3 * walk_steps + 8 + 2 * n_cand_nc + 6,
        9 * walk_steps + 3 * 8 + 3 * n_cand_nc + 45 + 8 + 4,
        walk_steps + 2 * n_cand_nc,
    )

    breakdown = {
        "normals": st_normals,
        "slope": st_slope,
        "step": st_step,
        "roughness": st_rough,
        "fusion": st_fuse,
        "veto_counts": st_veto_cnt,
        "veto_step_walk": st_walk,
    }
    f32_ops = float(sum(f for f, _, _ in breakdown.values()))
    bool_ops = float(sum(b for _, b, _ in breakdown.values()))
    shifts = float(sum(s for _, _, s in breakdown.values()))

    # memory floor: read elevation once; write traversability, slope, step,
    # [roughness] and the bool veto mask once
    n_out_f32 = 3 + (1 if chain_cfg.compute_roughness else 0)
    bytes_per_cell = 4 + 4 * n_out_f32 + 1

    return {
        "ops_per_cell": f32_ops + bool_ops,
        "f32_ops_per_cell": f32_ops,
        "bool_ops_per_cell": bool_ops,
        "shifted_planes": shifts,
        "hbm_bytes_per_cell": float(bytes_per_cell),
        "breakdown": {
            k: {"f32": f, "bool": b, "shifts": s}
            for k, (f, b, s) in breakdown.items()
        },
    }


def circle_field_op_estimate(
    radius_max: float, resolution: float
) -> Dict[str, float]:
    """Per-cell counts of the dense circle field: per in-window offset ~4
    ops (fail OR with the radius class, pass-count add, traversability
    add); ~20 finishing ops (inflation factor, means, verdict selects). The
    memory floor reads one packed query plane (4 B) and writes the verdict
    (1 B) and value (4 B) planes."""
    n_window = _n_offsets(radius_max, resolution)
    return {
        "ops_per_cell": 4.0 * n_window + 20.0,
        # read the packed query plane; write verdict + value planes
        "hbm_bytes_per_cell": 4.0 + 1.0 + 4.0,
        "n_offsets": float(n_window),
    }


def sol_report(
    cells: int,
    t_measured: float,
    counts: Dict[str, float],
    vpu_flops: float,
    hbm_bw: float,
    bool_ops_per_s: float | None = None,
    shift_cost_s: float | None = None,
) -> Dict[str, float]:
    """Roofline verdict: pct_sol = (the larger floor) / measured time.

    f32 ops are priced at `vpu_flops` / 2 (one FMA issue per lane per
    cycle; compares, selects and int adds issue at the same rate). Mask ops
    are priced at `bool_ops_per_s` when given and the counts carry a
    ``bool_ops_per_cell`` class, else at the f32 rate. When `shift_cost_s`
    (seconds per shifted plane at this `cells`) and a ``shifted_planes``
    count are given, the shifted reads ADD to the compute bound."""
    vpu_ops_per_s = vpu_flops / 2.0
    if bool_ops_per_s and "bool_ops_per_cell" in counts:
        t_compute = cells * (
            counts["f32_ops_per_cell"] / vpu_ops_per_s
            + counts["bool_ops_per_cell"] / bool_ops_per_s
        )
    else:
        t_compute = cells * counts["ops_per_cell"] / vpu_ops_per_s
    t_shift = (
        counts.get("shifted_planes", 0.0) * shift_cost_s
        if shift_cost_s
        else 0.0
    )
    t_compute = t_compute + t_shift
    t_memory = cells * counts["hbm_bytes_per_cell"] / hbm_bw
    bound_s = max(t_compute, t_memory)
    return {
        "t_compute_bound_s": t_compute,
        "t_shift_bound_s": t_shift,
        "t_memory_bound_s": t_memory,
        "binding": "compute" if t_compute >= t_memory else "memory",
        "pct_sol": 100.0 * bound_s / max(t_measured, 1e-12),
    }
