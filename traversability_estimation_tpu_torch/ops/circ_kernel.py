"""The circular path batch and its CUDA kernel (kernel 4).

``ops/footprint.py::check_circular_paths`` is what every circular path batch
goes through (the online tick, the service's circular paths,
``check_circular_paths_batch``, the rollout and multi-host drivers): on a
CPU state it runs the plain version, ``check_circular_paths_plain``, which
is also the kernel's referee on the card; on a CUDA state it calls
``check_circular_paths`` here, one launch of kernel 4
(``csrc/circ_paths.cu``) per batch. The two agree exactly in verdicts;
traversability sums run in another order (float32 rounding).

Kernel 4 is not the port of a TPU kernel: the JAX package computes the
batch as XLA-fused ``jnp`` (``traversability_estimation_tpu/ops/
footprint.py:378``). What stays in torch around it: the pose upload and,
when the batch has single-pose paths, ``check_circles`` at their pose (the
kernel reads its verdicts); the circle field, when the caller gives none, is
kernel 2's. The launch geometry (``launch_plan``, a warp per path) and the
integer sample formula the kernel uses (``sample_cells``) are here, on the
host, so the CPU tests reach them.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from traversability_estimation_tpu_torch.kernels import build
from traversability_estimation_tpu_torch.ops import footprint
from traversability_estimation_tpu_torch.ops.filters import f32, rcp
from traversability_estimation_tpu_torch.ops.footprint import QueryState

WARPS = 4  # paths a block takes, a warp each (csrc/circ_paths.cu checks the plan)
THREADS = 32 * WARPS


@dataclasses.dataclass(frozen=True)
class CircPlan:
    """One launch of kernel 4: the grid (a warp per path) and the block."""

    grid: int
    block: int


def launch_plan(P: int) -> CircPlan:
    """Kernel 4's launch for a batch of `P` paths."""
    if P < 1:
        raise ValueError(f"check_circular_paths: {P} paths; the kernel takes at least 1")
    return CircPlan(grid=-(-P // WARPS), block=THREADS)


def samples_per_segment(max_segment_cells: int) -> int:
    """S: the stride-4 samples a segment takes at most (nSkip = 3 over
    `max_segment_cells` cells)."""
    return (int(max_segment_cells) + 3) // 4


def sample_cells(first: torch.Tensor, last: torch.Tensor,
                 max_segment_cells: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stride-4 samples of the Bresenham walk from cell `first` to cell
    `last` ((..., 2) int32), as kernel 4 computes them: sample s is cell k
    = 4 s of the walk, from the closed form ``over(k) = (denom // 2 + k *
    num_add) // max(denom, 1)`` (0 at k = 0), one sample at a time. Returns
    (cells (..., S, 2) int32, valid (..., S) bool): valid where k lies on
    the line's denom + 1 cells; S = ``samples_per_segment``."""
    first = first.to(torch.int32)
    last = last.to(torch.int32)
    d = (last - first).abs()
    sign = torch.where(last >= first, 1, -1).to(torch.int32)
    x_dom = (d[..., 0] >= d[..., 1])[..., None]
    denom = torch.where(x_dom, d[..., :1], d[..., 1:])
    num_add = torch.where(x_dom, d[..., 1:], d[..., :1])
    k = torch.arange(samples_per_segment(max_segment_cells), dtype=torch.int32,
                     device=first.device) * 4
    over = torch.where(k == 0, 0, (denom // 2 + k * num_add) // torch.clamp_min(denom, 1))
    ci = first[..., :1] + sign[..., :1] * torch.where(x_dom, k, over)
    cj = first[..., 1:] + sign[..., 1:] * torch.where(x_dom, over, k)
    return torch.stack([ci, cj], -1).to(torch.int32), k <= denom


_lib = None


def library() -> ctypes.CDLL:
    """Kernel 4's library, built at first use, with its C interface."""
    global _lib
    if _lib is None:
        lib = build.load("circ_paths")
        lib.te_circ_paths.argtypes = [
            *([ctypes.c_void_p] * 7), *([ctypes.c_int] * 5), *([ctypes.c_float] * 3),
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.te_circ_paths.restype = ctypes.c_int
        lib.te_circ_paths_occupancy.argtypes = []
        lib.te_circ_paths_occupancy.restype = ctypes.c_int
        lib.te_circ_paths_error_string.argtypes = [ctypes.c_int]
        lib.te_circ_paths_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_circular_paths(
    state: QueryState,
    poses,
    n_poses,
    radius: float,
    offset: float = 0.15,
    max_segment_cells: int = 64,
    field: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    has_single_pose: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``footprint.check_circular_paths`` on a CUDA state, with its
    arguments and results: one launch of kernel 4 (or an error: nothing
    falls back)."""
    dev = state.device
    if dev.type != "cuda":
        raise ValueError(f"check_circular_paths kernel: unsupported device {dev}")
    poses = torch.as_tensor(poses, dtype=torch.float32, device=dev).contiguous()
    if poses.dim() != 3 or poses.shape[1] < 1 or poses.shape[2] != 2:
        raise ValueError(f"check_circular_paths: poses {tuple(poses.shape)}, expected (P, N, 2)")
    P, N, _ = poses.shape
    n_poses = torch.as_tensor(n_poses, dtype=torch.int32, device=dev).contiguous()
    if tuple(n_poses.shape) != (P,):
        raise ValueError(f"check_circular_paths: n_poses {tuple(n_poses.shape)} for {P} paths")
    safe = torch.empty(P, dtype=torch.bool, device=dev)
    trav = torch.empty(P, dtype=torch.float32, device=dev)
    if P == 0:
        return safe, trav
    ok1 = trav1 = None
    if has_single_pose or N == 1:
        ok1, trav1 = (t.contiguous() for t in footprint.check_circles(
            state, poses[:, 0, :], radius + offset, radius))
    H, W = state.shape
    field_ok = field_trav = None
    if N > 1:
        if field is None:
            from traversability_estimation_tpu_torch.ops.field_kernel import dense_circle_field

            field = dense_circle_field(state, radius + offset, radius)
        field_ok, field_trav = field
        if tuple(field_ok.shape) != (H, W) or tuple(field_trav.shape) != (H, W) \
                or field_ok.device != dev or field_trav.device != dev:
            raise ValueError(
                f"check_circular_paths: field {tuple(field_ok.shape)} on {field_ok.device}, "
                f"the state {(H, W)} on {dev}")
        field_ok = field_ok.to(torch.bool).contiguous().view(torch.uint8)
        field_trav = field_trav.to(torch.float32).contiguous()
    position = torch.as_tensor(state.position, dtype=torch.float32, device=dev).contiguous()
    default = float(state.default_traversability)
    fill = default if default != 0.0 else -1.0 - default
    plan = launch_plan(P)
    lib = library()
    with torch.cuda.device(dev):
        rc = lib.te_circ_paths(
            poses.data_ptr(), n_poses.data_ptr(), position.data_ptr(),
            *(None if t is None else t.data_ptr() for t in (field_ok, field_trav)),
            None if ok1 is None else ok1.view(torch.uint8).data_ptr(),
            None if trav1 is None else trav1.data_ptr(),
            P, N, H, W, samples_per_segment(max_segment_cells), f32(state.resolution),
            rcp(state.resolution), f32(fill), plan.grid, plan.block,
            safe.view(torch.uint8).data_ptr(), trav.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"check_circular_paths kernel: {lib.te_circ_paths_error_string(rc).decode()}")
    build.count_launch(check_circular_paths)
    return safe, trav


check_circular_paths.launches = 0


def occupancy() -> int:
    """Resident blocks per SM of kernel 4."""
    return library().te_circ_paths_occupancy()


def work_counts(state: QueryState, poses, n_poses, max_segment_cells: int) -> Tuple[int, int]:
    """(valid segments, samples read) of a batch: what kernel 4 does on
    these inputs (a segment past its path's pose count takes no sample, a
    short one fewer than S). Counted with the plain version's cell indices
    and ``sample_cells``."""
    dev = state.device
    poses = torch.as_tensor(poses, dtype=torch.float32, device=dev)
    n_poses = torch.as_tensor(n_poses, dtype=torch.int32, device=dev)
    N = poses.shape[1]
    if N < 2:
        return 0, 0
    seg_valid = torch.arange(1, N, device=dev)[None, :] < n_poses[:, None]
    _, valid = sample_cells(footprint._index_of(state, poses[:, 1:]),
                            footprint._index_of(state, poses[:, :-1]), max_segment_cells)
    return int(seg_valid.sum()), int((valid & seg_valid[..., None]).sum())


def kernel_bytes(P: int, N: int, samples: int, single_pose: bool) -> int:
    """Bytes kernel 4 must move: the poses, pose counts and map centre read
    once, the field's ok byte and trav float once per sample read, the
    single-pose verdicts (bool, f32) when given, the verdicts (bool, f32)
    written once."""
    return P * N * 8 + P * 4 + 8 + samples * 5 + (P * 5 if single_pose else 0) + P * 5


def kernel_operations(P: int, segments: int, samples: int) -> int:
    """Float32 operations of kernel 4 on this batch: per valid segment the
    four cell indices (a subtract and a multiply each), its length (two
    subtracts, two multiplies, an add, a root), its mean (a divide) and the
    lane's four sums (with one multiply): 19; per sample read its compare,
    the packed round trip (two subtracts) and the add: 4; per path the warp
    tree's 4 x 5 adds and the final compare and divide: 22. Integer index
    arithmetic, selects and boolean logic are not counted."""
    return 19 * segments + 4 * samples + 22 * P
