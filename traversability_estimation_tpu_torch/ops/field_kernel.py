"""The dense circle field and its CUDA kernel.

``dense_circle_field`` is the field every circular path batch reads: on a
CUDA map it launches kernel 2 (``csrc/circle_field.cu``, the port of the
TPU kernel ``ops/pallas_field.py::dense_circle_field_pallas``); on a CPU map
it runs the plain version, ``ops/footprint.py::dense_circle_field``, which
is also the kernel's referee on the card (bit-identical: the sums are
plain adds in one fixed spiral order).

The launch geometry (``launch_plan``) and the kernel's offset table
(``delta_table``) are computed here, on the host, so the CPU tests reach
them; the tables go to the device once per (radius, resolution, stride,
device) and stay there (``device_tables``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from traversability_estimation_tpu_torch.kernels import build
from traversability_estimation_tpu_torch.ops import footprint
from traversability_estimation_tpu_torch.ops.filters import f32, rcp
from traversability_estimation_tpu_torch.ops.footprint import QueryState

# the kernel's tile, one cell per thread (csrc/circle_field.cu checks every
# launch plan against its own)
TILE_W, TILE_H = 32, 4
FIELD_MAX_OFFS = 4096
UNROLL = 8
STRIDES = (64, 128)  # window row strides the kernel is compiled for


@dataclasses.dataclass(frozen=True)
class FieldPlan:
    """One launch of kernel 2: the spiral reach R, the window row stride,
    the grid (x over columns, y over rows), the block and the dynamic shared
    memory (offset table + packed window)."""

    reach: int
    n_offsets: int
    stride: int
    grid: Tuple[int, int]
    block: Tuple[int, int]
    smem_bytes: int

    @property
    def warps(self) -> int:
        """Warps the launch starts, over all its blocks."""
        return self.grid[0] * self.grid[1] * -(-self.block[0] * self.block[1] // 32)


def launch_plan(H: int, W: int, reach: int, n_offsets: int) -> FieldPlan:
    """Kernel 2's launch for an (H, W) map and a spiral of `n_offsets`
    offsets reaching `reach` cells: the narrowest compiled stride that holds
    a window row (tile width + 2 reach)."""
    if not 1 <= n_offsets <= FIELD_MAX_OFFS:
        raise ValueError(
            f"dense_circle_field: {n_offsets} spiral offsets; the kernel takes 1 to "
            f"{FIELD_MAX_OFFS}"
        )
    fits = [s for s in STRIDES if TILE_W + 2 * reach <= s]
    if not fits:
        raise ValueError(f"dense_circle_field: spiral reach {reach} exceeds the kernel's window")
    stride = fits[0]
    n_pad = -(-n_offsets // UNROLL) * UNROLL
    return FieldPlan(
        reach=reach,
        n_offsets=n_offsets,
        stride=stride,
        grid=(-(-W // TILE_W), -(-H // TILE_H)),
        block=(TILE_W, TILE_H),
        smem_bytes=4 * (n_pad + (TILE_H + 2 * reach) * stride),
    )


def delta_table(offs: np.ndarray, reach: int, stride: int) -> np.ndarray:
    """Linear window deltas (K,) int32 of spiral offsets (K, 2): offset
    (oi, oj) of a cell at window position (li, lj) (tile coordinates) is the
    window word li * stride + lj + delta."""
    offs = np.asarray(offs, dtype=np.int64)
    return ((offs[:, 0] + reach) * stride + (offs[:, 1] + reach)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _host_tables(radius_max: float, resolution: float):
    offs, radii = footprint.field_tables(radius_max, resolution)
    reach = int(np.max(np.abs(offs))) if len(offs) else 0
    return offs, radii, reach


_device_tables: dict = {}


def device_tables(radius_max: float, resolution: float, H: int, W: int, device: torch.device):
    """(plan, deltas, radii) for a field of this radius on an (H, W) map:
    the tables built once per (radius, resolution, stride, device) and kept
    on the device."""
    offs, radii, reach = _host_tables(float(radius_max), float(resolution))
    plan = launch_plan(H, W, reach, len(offs))
    key = (float(radius_max), float(resolution), plan.stride, str(device))
    if key not in _device_tables:
        _device_tables[key] = (
            torch.as_tensor(delta_table(offs, reach, plan.stride), device=device),
            torch.tensor(radii, device=device),
        )
    return (plan, *_device_tables[key])


_lib = None


def library() -> ctypes.CDLL:
    """Kernel 2's library, built at first use, with its C interface."""
    global _lib
    if _lib is None:
        lib = build.load("circle_field")
        lib.te_circle_field.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            *([ctypes.c_int] * 5), ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.te_circle_field.restype = ctypes.c_int
        lib.te_circle_field_occupancy.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.te_circle_field_occupancy.restype = ctypes.c_int
        lib.te_circle_field_error_string.argtypes = [ctypes.c_int]
        lib.te_circle_field_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def dense_circle_field(
    state: QueryState,
    radius_max: float,
    radius_min: float,
    in_map: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cell circular footprint verdict (ok (H, W) bool, trav (H, W) f32).
    CPU map: the plain version. CUDA map: one launch of kernel 2."""
    dev = state.device
    if dev.type == "cpu":
        return footprint.dense_circle_field(state, radius_max, radius_min, in_map)
    if dev.type != "cuda":
        raise ValueError(f"dense_circle_field: unsupported device {dev}")
    H, W = state.shape
    plan, deltas, radii = device_tables(radius_max, state.resolution, H, W, dev)
    ok = torch.empty((H, W), dtype=torch.bool, device=dev)
    tv = torch.empty((H, W), dtype=torch.float32, device=dev)
    if H * W == 0:
        return ok, tv
    trav = state.traversability.to(torch.float32).contiguous()
    mask = state.traversable_mask.to(torch.bool).contiguous().view(torch.uint8)
    inm = None
    if in_map is not None:
        inm = in_map.to(device=dev, dtype=torch.bool).contiguous().view(torch.uint8)
    span_rcp = rcp(radius_max - radius_min) if radius_min != 0.0 else 0.0
    lib = library()
    with torch.cuda.device(dev):
        rc = lib.te_circle_field(
            trav.data_ptr(), mask.data_ptr(), None if inm is None else inm.data_ptr(),
            H, W, plan.reach, deltas.data_ptr(), radii.data_ptr(), plan.n_offsets,
            plan.stride, *plan.grid, *plan.block, plan.smem_bytes,
            f32(state.default_traversability), f32(radius_min), span_rcp,
            int(radius_min == 0.0), ok.data_ptr(), tv.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"dense_circle_field kernel: {lib.te_circle_field_error_string(rc).decode()}"
        )
    build.count_launch(dense_circle_field)
    return ok, tv


dense_circle_field.launches = 0


def occupancy(plan: FieldPlan) -> int:
    """Resident blocks per SM of kernel 2 for this plan."""
    return library().te_circle_field_occupancy(plan.stride, plan.smem_bytes)


def kernel_bytes(H: int, W: int) -> int:
    """Bytes kernel 2 must move: traversability (f32) and mask (u8) read
    once, ok (u8) and trav (f32) written once."""
    return H * W * (4 + 1 + 1 + 4)


def kernel_operations(n_offsets: int, H: int, W: int) -> int:
    """Float32 operations kernel 2 does: per cell and spiral offset two
    compares (fail, finite) and two adds (count, sum); ten for the epilogue.
    Selects and boolean logic are not counted."""
    return H * W * (4 * n_offsets + 10)
