"""The circular path batch and its CUDA kernel (kernel 4).

``ops/footprint.py::check_circular_paths`` is what every circular path batch
goes through (the online tick, the service's circular paths,
``check_circular_paths_batch``, the rollout and multi-host drivers): on a
CPU state it runs the plain version, ``check_circular_paths_plain``, which
is also the kernel's referee on the card; on a CUDA state it calls
``check_circular_paths`` here, one launch of kernel 4
(``csrc/circ_paths.cu``) per batch. The two agree exactly in verdicts and,
for a path of one pose, in traversability; a longer path's sums run in
another order (float32 rounding).

Kernel 4 is not the port of a TPU kernel: the JAX package computes the
batch as XLA-fused ``jnp`` (``traversability_estimation_tpu/ops/
footprint.py:378``). A call does no torch work but its inputs' uploads and
its outputs' allocation: the poses and pose counts the caller holds on the
host go up as they are (``device_inputs``); a segment takes its own
samples, so the caller needs no sample cap (``max_segment_cells=None``); a
path of one pose is ``check_circles``' spiral inside the kernel, from a
table cached on the device (``device_spiral_table``). The circle field,
when the caller gives none, is kernel 2's. The launch geometry
(``launch_plan``, a warp per path, a stage of a block's poses in shared
memory) and the integer sample formula the kernel uses (``sample_cells``)
are here, on the host, so the CPU tests reach them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from traversability_estimation_tpu_torch.grid.geometry import spiral_order
from traversability_estimation_tpu_torch.kernels import build
from traversability_estimation_tpu_torch.ops import footprint
from traversability_estimation_tpu_torch.ops.filters import f32, rcp
from traversability_estimation_tpu_torch.ops.footprint import QueryState

WARPS = 4  # paths a block takes, a warp each (csrc/circ_paths.cu checks the plan)
THREADS = 32 * WARPS
# segment starts a stage of a block's poses holds in shared memory (with the
# pose after the last and every pose's cell, 16 bytes a pose: 32 KB)
STAGE_POSES = WARPS * 512
UNCAPPED = 2**31 - 1  # the sample cap S that never binds


@dataclasses.dataclass(frozen=True)
class CircPlan:
    """One launch of kernel 4: the grid (a warp per path), the block and the
    dynamic shared memory (a stage of a block's poses and their cells)."""

    grid: int
    block: int
    smem: int


def launch_plan(P: int, N: int) -> CircPlan:
    """Kernel 4's launch for a batch of `P` paths of `N` poses."""
    if P < 1 or N < 1:
        raise ValueError(f"check_circular_paths: {P} paths of {N} poses; the kernel takes "
                         "at least 1 of each")
    return CircPlan(grid=-(-P // WARPS), block=THREADS,
                    smem=16 * min(WARPS * N, STAGE_POSES + 1))


def samples_per_segment(max_segment_cells: Optional[int]) -> int:
    """S: the stride-4 samples a segment takes at most (nSkip = 3 over
    `max_segment_cells` cells); ``UNCAPPED`` for None."""
    if max_segment_cells is None:
        return UNCAPPED
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


@functools.lru_cache(maxsize=None)
def spiral_table(radius_max: float, resolution: float) -> np.ndarray:
    """``check_circles``' spiral as kernel 4 reads it: (K, 2) int32 in
    grid_map's spiral order, column 0 the offset (di << 16 | dj & 0xffff),
    column 1 the bits of the offset's float32 radius (float64 norm times
    the resolution, rounded once, as ``check_circles`` rounds it), negative
    on the outer two rings (the Euclidean re-check). Cached, read-only."""
    offs, rings = spiral_order(radius_max, resolution)
    if len(offs) and int(np.abs(offs).max()) >= 2**15:
        raise ValueError(f"spiral of radius {radius_max} at {resolution}: offsets beyond int16")
    n_rings = int(math.ceil(radius_max / resolution - 1e-12))
    outer = rings >= max(n_rings - 1, 0)
    radii = (np.linalg.norm(offs.astype(np.float64), axis=1) * resolution).astype(np.float32)
    table = np.empty((len(offs), 2), np.int32)
    table[:, 0] = (offs[:, 0].astype(np.int32) << 16) | (offs[:, 1].astype(np.int32) & 0xFFFF)
    table[:, 1] = np.where(outer, -radii, radii).view(np.int32)
    table.flags.writeable = False
    return table


@functools.lru_cache(maxsize=None)
def device_spiral_table(radius_max: float, resolution: float,
                        device: torch.device) -> torch.Tensor:
    """``spiral_table`` on `device`, uploaded once per (radius, resolution,
    device)."""
    return torch.as_tensor(np.array(spiral_table(radius_max, resolution)), device=device)


def device_inputs(poses, n_poses, dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(poses (P, N, 2) float32, 16-byte aligned; n_poses (P,) int32) on
    `dev`, each by its own ``torch.as_tensor``: a tensor on the card is used
    as it is (copied only to align or convert), a host array goes up in a
    pageable copy, counted in ``device_inputs.copies`` for the poses. A
    pinned staging buffer taking both in one copy lost to these two copies
    on the card (``PERF.md``)."""
    host = not (isinstance(poses, torch.Tensor) and poses.is_cuda)
    p = torch.as_tensor(poses, dtype=torch.float32, device=dev).contiguous()
    n = torch.as_tensor(n_poses, dtype=torch.int32, device=dev).contiguous()
    if p.ndim != 3 or p.shape[1] < 1 or p.shape[2] != 2:
        raise ValueError(f"check_circular_paths: poses {tuple(p.shape)}, expected (P, N, 2)")
    if tuple(n.shape) != tuple(p.shape[:1]):
        raise ValueError(f"check_circular_paths: n_poses {tuple(n.shape)} for {p.shape[0]} paths")
    if host:
        with _copies_lock:
            device_inputs.copies += 1
    return (p.clone() if p.data_ptr() % 16 else p), n


_copies_lock = threading.Lock()
device_inputs.copies = 0


_lib = None


def library() -> ctypes.CDLL:
    """Kernel 4's library, built at first use, with its C interface."""
    global _lib
    if _lib is None:
        lib = build.load("circ_paths")
        lib.te_circ_paths.argtypes = [
            *([ctypes.c_void_p] * 8), *([ctypes.c_int] * 9), *([ctypes.c_float] * 7),
            *([ctypes.c_int] * 4), ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.te_circ_paths.restype = ctypes.c_int
        lib.te_circ_paths_occupancy.argtypes = [ctypes.c_int]
        lib.te_circ_paths_occupancy.restype = ctypes.c_int
        lib.te_circ_paths_empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.te_circ_paths_empty.restype = ctypes.c_int
        lib.te_circ_paths_error_string.argtypes = [ctypes.c_int]
        lib.te_circ_paths_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _row_major(plane: torch.Tensor) -> torch.Tensor:
    """`plane` if its rows are dense (a crop's view keeps its row stride),
    else a dense copy."""
    return plane if plane.stride(1) == 1 and plane.stride(0) >= plane.shape[1] \
        else plane.contiguous()


def check_circular_paths(
    state: QueryState,
    poses,
    n_poses,
    radius: float,
    offset: float = 0.15,
    max_segment_cells: Optional[int] = 64,
    field: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    has_single_pose: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``footprint.check_circular_paths`` on a CUDA state, with its
    arguments and results: one launch of kernel 4 (or an error: nothing
    falls back). `max_segment_cells` None: every segment walked whole."""
    dev = state.device
    if dev.type != "cuda":
        raise ValueError(f"check_circular_paths kernel: unsupported device {dev}")
    poses, n_poses = device_inputs(poses, n_poses, dev)
    P, N, _ = poses.shape
    safe = torch.empty(P, dtype=torch.bool, device=dev)
    trav = torch.empty(P, dtype=torch.float32, device=dev)
    if P == 0:
        return safe, trav
    H, W = state.shape
    rmax = radius + offset
    field_ok = field_trav = None
    if N > 1:
        if field is None:
            from traversability_estimation_tpu_torch.ops.field_kernel import dense_circle_field

            field = dense_circle_field(state, rmax, radius)
        field_ok, field_trav = field
        if tuple(field_ok.shape) != (H, W) or tuple(field_trav.shape) != (H, W) \
                or field_ok.device != dev or field_trav.device != dev:
            raise ValueError(
                f"check_circular_paths: field {tuple(field_ok.shape)} on {field_ok.device}, "
                f"the state {(H, W)} on {dev}")
        field_ok = field_ok.to(torch.bool).contiguous().view(torch.uint8)
        field_trav = field_trav.to(torch.float32).contiguous()
    tv_plane = _row_major(state.traversability.to(torch.float32))
    mask_plane = _row_major(state.traversable_mask.to(torch.bool)).view(torch.uint8)
    table = device_spiral_table(rmax, state.resolution, dev)
    position = torch.as_tensor(state.position, dtype=torch.float32, device=dev).contiguous()
    default = float(state.default_traversability)
    fill = default if default != 0.0 else -1.0 - default
    span_rcp = rcp(rmax - radius) if rmax != radius else math.inf  # float32 1 / 0
    plan = launch_plan(P, N)
    lib = library()
    with torch.cuda.device(dev):
        rc = lib.te_circ_paths(
            poses.data_ptr(), n_poses.data_ptr(), position.data_ptr(),
            *(None if t is None else t.data_ptr() for t in (field_ok, field_trav)),
            tv_plane.data_ptr(), mask_plane.data_ptr(), table.data_ptr(),
            P, N, H, W, samples_per_segment(max_segment_cells), table.shape[0],
            tv_plane.stride(0), mask_plane.stride(0), int(bool(has_single_pose)),
            f32(state.resolution), rcp(state.resolution), f32(fill), f32(default),
            f32(rmax * rmax), f32(radius), span_rcp, int(radius == 0.0),
            plan.grid, plan.block, plan.smem,
            safe.view(torch.uint8).data_ptr(), trav.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"check_circular_paths kernel: {lib.te_circ_paths_error_string(rc).decode()}")
    build.count_launch(check_circular_paths)
    return safe, trav


check_circular_paths.launches = 0


def occupancy(N: int = 50) -> int:
    """Resident blocks per SM of kernel 4 on paths of `N` poses."""
    return library().te_circ_paths_occupancy(launch_plan(1, N).smem)


def empty_launch(P: int, device: torch.device) -> None:
    """Launch an empty kernel at kernel 4's grid and block for `P` paths on
    `device`'s current stream: the floor of a launch of kernel 4, to time
    beside it. Not counted as a launch of kernel 4."""
    plan = launch_plan(P, 1)
    lib = library()
    with torch.cuda.device(device):
        rc = lib.te_circ_paths_empty(plan.grid, plan.block,
                                     torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty launch: {lib.te_circ_paths_error_string(rc).decode()}")


@dataclasses.dataclass(frozen=True)
class CircWork:
    """What kernel 4 does on a batch: valid segments and the samples they
    read; single-pose paths evaluated, the spiral positions they visit (to
    the first failure, or all), of which on the outer two rings and of which
    read (on the map, within the circle), and the table entries needed."""

    segments: int
    samples: int
    single_paths: int
    spiral_cells: int
    outer_cells: int
    spiral_reads: int
    table_entries: int


def work_counts(state: QueryState, poses, n_poses, radius: float, offset: float = 0.15,
                max_segment_cells: Optional[int] = None,
                has_single_pose: bool = True) -> CircWork:
    """``CircWork`` of a batch, counted with the plain version's cell
    indices and ``check_circles``' values."""
    dev = state.device
    poses = torch.as_tensor(poses, dtype=torch.float32, device=dev)
    n_poses = torch.as_tensor(n_poses, dtype=torch.int32, device=dev)
    P, N = poses.shape[:2]
    segments = samples = 0
    if N > 1:
        seg_valid = torch.arange(1, N, device=dev)[None, :] < n_poses[:, None]
        d = (footprint._index_of(state, poses[:, 1:])
             - footprint._index_of(state, poses[:, :-1])).abs().amax(-1)
        per = torch.clamp_max(d // 4 + 1, samples_per_segment(max_segment_cells))
        segments = int(seg_valid.sum())
        samples = int(torch.where(seg_valid, per, 0).sum())
    if N == 1:
        single = torch.ones_like(n_poses, dtype=torch.bool)
    else:
        single = (n_poses == 1) & bool(has_single_pose)
    centers = poses[:, 0][single]
    rmax = radius + offset
    cells = outer = reads = entries = 0
    if len(centers):
        active, ok, _, inside = footprint._spiral_values(state, centers, rmax)
        K = active.shape[1]
        fail = active & ~ok
        c = torch.where(fail.any(-1), fail.to(torch.uint8).argmax(-1) + 1, K)
        c = torch.where(inside, c, 0)
        upto = torch.arange(K, device=dev)[None, :] < c[:, None]
        is_outer = torch.as_tensor(spiral_table(rmax, state.resolution)[:, 1] < 0, device=dev)
        cells, entries = int(c.sum()), int(c.max())
        outer = int((upto & is_outer[None, :]).sum())
        reads = int((upto & active).sum())
    return CircWork(segments, samples, int(single.sum()), cells, outer, reads, entries)


def kernel_bytes(P: int, N: int, work: CircWork) -> int:
    """Bytes kernel 4 must move: the poses, pose counts and map centre read
    once, the field's ok byte and trav float once per sample read, a single
    pose's map cells (trav float, mask byte) once per spiral cell read and
    the spiral table's entries it needs (8 bytes each), the verdicts (bool,
    f32) written once."""
    return (P * N * 8 + P * 4 + 8 + work.samples * 5 + work.spiral_reads * 5
            + work.table_entries * 8 + P * 5)


def kernel_operations(P: int, work: CircWork) -> int:
    """Float32 operations of kernel 4 on this batch: per valid segment the
    four cell indices (a subtract and a multiply each), its length (two
    subtracts, two multiplies, an add, a root), its mean (a divide) and the
    lane's four sums (with one multiply): 19; per sample read its compare,
    the packed round trip (two subtracts) and the add: 4; per path the warp
    tree's 4 x 5 adds and the final compare and divide: 22. A single-pose
    path: per spiral position visited the packed value, its compare and its
    add: 3, and on the outer two rings the cell centre (two adds, two FMAs),
    the distance (two subtracts, a multiply, an FMA) and its compare: 9
    more; per path the inside test (two subtracts, four compares) and the
    verdict (a compare, a divide, the factor's subtract, FMA and two
    multiplies): 12. Integer index arithmetic, selects and boolean logic are
    not counted."""
    return (19 * work.segments + 4 * work.samples + 22 * P + 3 * work.spiral_cells
            + 9 * work.outer_cells + 12 * work.single_paths)
