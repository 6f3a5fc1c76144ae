"""The dense circle field and its CUDA kernel.

``dense_circle_field`` is the field every circular path batch reads: on a
CUDA map it launches kernel 2 (``csrc/circle_field.cu``, the port of the
TPU kernel ``ops/pallas_field.py::dense_circle_field_pallas``); on a CPU map
it runs the plain version, ``ops/footprint.py::dense_circle_field``, which
is also the kernel's referee on the card (bit-identical: the sums are
plain adds in one fixed spiral order).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from traversability_estimation_tpu_torch.kernels import build
from traversability_estimation_tpu_torch.ops import footprint
from traversability_estimation_tpu_torch.ops.filters import f32, rcp
from traversability_estimation_tpu_torch.ops.footprint import QueryState

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("circle_field")
        lib.te_circle_field.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.te_circle_field.restype = ctypes.c_int
        lib.te_circle_field_max_offsets.restype = ctypes.c_int
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
    offs, radii = footprint.field_tables(radius_max, state.resolution)
    H, W = state.shape
    trav = state.traversability.to(torch.float32).contiguous()
    mask = state.traversable_mask.to(torch.bool).contiguous().view(torch.uint8)
    inm = None
    if in_map is not None:
        inm = in_map.to(device=dev, dtype=torch.bool).contiguous().view(torch.uint8)
    ok = torch.empty((H, W), dtype=torch.bool, device=dev)
    tv = torch.empty((H, W), dtype=torch.float32, device=dev)
    if H * W == 0:
        return ok, tv
    lib = _library()
    if len(offs) > lib.te_circle_field_max_offsets():
        raise ValueError(
            f"dense_circle_field: {len(offs)} spiral offsets exceed the kernel's cap "
            f"of {lib.te_circle_field_max_offsets()}"
        )
    offs_c = np.ascontiguousarray(offs, dtype=np.int32)
    radii_c = np.ascontiguousarray(radii, dtype=np.float32)
    span_rcp = rcp(radius_max - radius_min) if radius_min != 0.0 else 0.0
    with torch.cuda.device(dev):
        rc = lib.te_circle_field(
            trav.data_ptr(), mask.data_ptr(), None if inm is None else inm.data_ptr(),
            H, W, offs_c.ctypes.data, radii_c.ctypes.data, len(offs_c),
            f32(state.default_traversability), f32(radius_min), span_rcp,
            int(radius_min == 0.0), ok.data_ptr(), tv.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"dense_circle_field kernel: {lib.te_circle_field_error_string(rc).decode()}"
        )
    dense_circle_field.launches += 1
    return ok, tv


dense_circle_field.launches = 0


def kernel_bytes(H: int, W: int) -> int:
    """Bytes kernel 2 must move: traversability (f32) and mask (u8) read
    once, ok (u8) and trav (f32) written once."""
    return H * W * (4 + 1 + 1 + 4)


def kernel_operations(n_offsets: int, H: int, W: int) -> int:
    """Float32 operations kernel 2 does: per cell and spiral offset two
    compares (fail, finite) and two adds (count, sum); ten for the epilogue.
    Selects and boolean logic are not counted."""
    return H * W * (4 * n_offsets + 10)
