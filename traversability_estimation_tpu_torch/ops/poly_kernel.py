"""The grouped polygonal path evaluator and its CUDA kernel (kernel 3).

``check_polygonal_paths_grouped`` is what every grouped polygonal batch
goes through (the estimator's dispatch, the fused online tick's polygonal
route, ``check_polygonal_paths_bucketed`` below): on a CUDA state it
launches kernel 3 (``csrc/poly_paths.cu``) once per batch; on a CPU state
it runs the plain version, ``ops/footprint.py::check_polygonal_paths_grouped``,
which is also the kernel's referee on the card. The two agree exactly in
verdicts and per-ring cell counts; traversability and area sums run in
another order (float32 rounding).

Kernel 3 is not the port of a TPU kernel: the JAX package's grouped
evaluator (``traversability_estimation_tpu/ops/footprint.py:1208``) is
XLA-fused code. The launch geometry (``launch_plan``) is computed here, on
the host, so the CPU tests reach it; the ``.cu`` checks it: a block of 8
warps per path, or, where the batch has too few paths to fill the card, a
cluster of up to 8 blocks per path, each taking every cluster-th ring block
(8 rings, a warp each). The kernel takes every footprint the plain version
takes: a warp's ring slot lies in shared memory, or, for a footprint too
large for it, in a global scratch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Tuple

import torch

from traversability_estimation_tpu_torch.kernels import build
from traversability_estimation_tpu_torch.ops import footprint
from traversability_estimation_tpu_torch.ops.filters import f32, rcp
from traversability_estimation_tpu_torch.ops.footprint import QueryState

# blocks of SEG_BLOCK warps (a ring block of 8 rings at a time), a cluster
# of at most CLUSTER blocks per path (csrc/poly_paths.cu checks the plan)
WARPS = footprint.SEG_BLOCK
THREADS = 32 * WARPS
CLUSTER = 8
BLOCKS_PER_SM = 4  # resident blocks an SM holds (__launch_bounds__(256, 4))
SM_COUNT = 132  # the H100 SXM's; kernel_inputs asks the device
SLOT_WORDS = 6  # 32-bit words a warp's slot keeps per ring point
FIXED_SMEM = 256  # shared memory every block takes: the warps' partial sums
SMEM_LIMIT = 232_448  # dynamic shared memory one block may use on the H100
# the stages whose warp cycles the stage-timing instantiation adds up
# (``stage_cycles``), in the order of ``Stage`` in csrc/poly_paths.cu
STAGES = ("transform", "hull tests", "hull walk", "ring area", "straddle tests", "searches",
          "cell sweep", "aggregation", "barrier waits", "other")


@dataclasses.dataclass(frozen=True)
class PolyPlan:
    """One launch of kernel 3: the ring capacity of a warp's slot (the
    hull's points, 2V or 4V), the binary search's rounds over the window's
    rows, the blocks of one path (a cluster of at most ``CLUSTER``, one per
    ring block of 8 rings at most), the grid (a cluster per path), the block,
    the dynamic shared memory (``FIXED_SMEM`` and one slot per warp) and,
    when the slots do not fit it, the 32-bit words of the global scratch
    that holds them instead (shared memory ``FIXED_SMEM``)."""

    ring: int
    n_bits: int
    cluster: int
    grid: Tuple[int, int]
    block: Tuple[int, int]
    smem_bytes: int
    scratch_words: int

    @property
    def warps(self) -> int:
        """Warps the launch starts, over all its blocks."""
        return self.grid[0] * self.grid[1] * self.block[0] // 32


def ring_points(n_vertices: int, conservative: bool) -> int:
    """Points of one segment's hull: two footprints, four when conservative."""
    return (4 if conservative else 2) * n_vertices


def launch_plan(P: int, N: int, n_vertices: int, wi: int, conservative: bool,
                smem_limit: int = SMEM_LIMIT, sm_count: int = SM_COUNT) -> PolyPlan:
    """Kernel 3's launch for `P` paths of `N` poses (N rings each: the
    pose-0 footprint and N - 1 segments) of a footprint of `n_vertices`
    vertices in windows of `wi` rows, on a card of `sm_count` SMs; its
    slots in shared memory when a block's whole take is at most `smem_limit`
    bytes, else in a global scratch (one block's slice per block).

    A path's rings are spread over as many blocks as it takes for the batch
    to fill the card's resident blocks, at most one per ring block and
    ``CLUSTER``: a block's warps wait at the end for the slowest of them, and
    a cluster's blocks for the slowest block, so a batch that fills the card
    with one block per path keeps it (each warp then takes several rings)."""
    ring = ring_points(n_vertices, conservative)
    cluster = max(1, min(-(-N // WARPS), CLUSTER, -(-sm_count * BLOCKS_PER_SM // max(P, 1))))
    block_words = WARPS * SLOT_WORDS * ring
    in_smem = FIXED_SMEM + block_words * 4 <= smem_limit
    return PolyPlan(
        ring=ring,
        # the plain version's rounds: ceil(log2(wi + 1)), at least 1
        n_bits=max(1, math.ceil(math.log2(wi + 1))),
        cluster=cluster,
        grid=(P * cluster, 1),
        block=(THREADS, 1),
        smem_bytes=FIXED_SMEM + (block_words * 4 if in_smem else 0),
        scratch_words=0 if in_smem else P * cluster * block_words,
    )


_lib = None


def library() -> ctypes.CDLL:
    """Kernel 3's library, built at first use, with its C interface."""
    global _lib
    if _lib is None:
        lib = build.load("poly_paths")
        lib.te_poly_paths.argtypes = [
            *([ctypes.c_void_p] * 6), *([ctypes.c_int] * 11),
            ctypes.c_float, ctypes.c_float, ctypes.c_float, *([ctypes.c_int] * 7),
            *([ctypes.c_void_p] * 11),
        ]
        lib.te_poly_paths.restype = ctypes.c_int
        lib.te_poly_paths_occupancy.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.te_poly_paths_occupancy.restype = ctypes.c_int
        lib.te_poly_paths_error_string.argtypes = [ctypes.c_int]
        lib.te_poly_paths_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


@dataclasses.dataclass(frozen=True)
class KernelInputs:
    """One batch as kernel 3 takes it: the batch's tensors on the card, the
    padded query plane and map origin, the launch plan and the global slots
    it asks for (None: shared memory)."""

    positions: torch.Tensor  # (P, N, D) f32
    quaternions: torch.Tensor  # (P, N, 4) f32
    n_poses: torch.Tensor  # (P,) i32
    footprint: torch.Tensor  # (V, 2) f32
    plane: torch.Tensor  # (H + 2 gpad, W + 2 gpad) f32, footprint._query_plane
    p0: torch.Tensor  # (2,) f32, footprint._origin_offset
    shape: Tuple[int, int]  # the map's (H, W)
    window: Tuple[int, int]  # (wi, wj): the block window in the block tier
    resolution: float
    default_traversability: float
    conservative: bool
    translate_only: bool
    use_blocks: bool
    plan: PolyPlan
    slots: Optional[torch.Tensor]  # (plan.scratch_words,) f32


def kernel_inputs(
    state: QueryState,
    positions,
    quaternions,
    n_poses,
    footprint_xy,
    window: Tuple[int, int],
    conservative: bool = False,
    translate_only: bool = False,
    block_window: Optional[Tuple[int, int]] = None,
    smem_limit: int = SMEM_LIMIT,
) -> KernelInputs:
    """The batch of ``check_polygonal_paths_grouped`` on a CUDA state,
    uploaded and checked, with the plane it is evaluated against
    (`smem_limit`: see ``launch_plan``)."""
    positions, quaternions, n_poses, fp = (t.contiguous() for t in footprint._path_inputs(
        state, positions, quaternions, n_poses, footprint_xy
    ))
    P, N, pos_d = positions.shape
    V = fp.shape[0]
    if N < 1 or pos_d < 2 or V < 1:
        raise ValueError(
            f"check_polygonal_paths_grouped: positions {tuple(positions.shape)}, footprint "
            f"{tuple(fp.shape)}")
    wi, wj = block_window if block_window is not None else window
    sm_count = (torch.cuda.get_device_properties(positions.device).multi_processor_count
                if positions.device.type == "cuda" else SM_COUNT)
    plan = launch_plan(P, N, V, wi, conservative, smem_limit, sm_count)
    slots = (torch.empty(plan.scratch_words, dtype=torch.float32, device=positions.device)
             if plan.scratch_words else None)
    # P0 as the plain version takes it, before the plane's queued work
    p0 = footprint._origin_offset(state).contiguous()
    plane = footprint._query_plane(state, max(wi, wj)).contiguous()
    return KernelInputs(
        positions, quaternions, n_poses, fp, plane, p0, state.shape, (wi, wj),
        state.resolution, state.default_traversability, bool(conservative),
        bool(translate_only and not conservative), block_window is not None, plan, slots,
    )


def launch(k: KernelInputs, return_segments: bool = False,
           work: Optional[torch.Tensor] = None,
           stage: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """One launch of kernel 3 on prepared inputs, on the current stream;
    returns what ``check_polygonal_paths_grouped`` returns. `work`, an int64
    (3,) tensor on the card, gets the launch's hull point tests, binary
    searches and straddle tests added to it; `stage`, an int64
    (len(STAGES),) tensor, each stage's warp cycles (the stage-timing
    instantiation; not with `work`)."""
    dev = k.positions.device
    P, N, pos_d = k.positions.shape
    outs = (
        torch.empty(P, dtype=torch.bool, device=dev),
        torch.empty(P, dtype=torch.float32, device=dev),
        torch.empty(P, dtype=torch.float32, device=dev),
    )
    rings = (
        torch.empty((P, N), dtype=torch.bool, device=dev),
        torch.empty((P, N), dtype=torch.int32, device=dev),
        torch.empty((P, N), dtype=torch.float32, device=dev),
        torch.empty((P, N), dtype=torch.float32, device=dev),
    )
    if P == 0:
        return outs + _per_ring(rings) if return_segments else outs
    (H, W), (wi, wj) = k.shape, k.window
    lib = library()
    with torch.cuda.device(dev):
        rc = lib.te_poly_paths(
            k.positions.data_ptr(), k.quaternions.data_ptr(), k.n_poses.data_ptr(),
            k.footprint.data_ptr(), k.plane.data_ptr(), k.p0.data_ptr(),
            P, N, pos_d, k.footprint.shape[0], H, W, max(wi, wj), wi, wj, k.plan.n_bits,
            k.plan.ring, f32(k.resolution), rcp(k.resolution), f32(k.default_traversability),
            int(k.conservative), int(k.translate_only), int(k.use_blocks),
            k.plan.grid[0], k.plan.cluster, k.plan.block[0], k.plan.smem_bytes,
            k.slots.data_ptr() if k.slots is not None else None,
            *(t.data_ptr() for t in outs), *(t.data_ptr() for t in rings),
            work.data_ptr() if work is not None else None,
            stage.data_ptr() if stage is not None else None,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"check_polygonal_paths_grouped kernel: {lib.te_poly_paths_error_string(rc).decode()}"
        )
    build.count_launch(check_polygonal_paths_grouped)
    return outs + _per_ring(rings) if return_segments else outs


def check_polygonal_paths_grouped(
    state: QueryState,
    positions,
    quaternions,
    n_poses,
    footprint_xy,
    window: Tuple[int, int],
    conservative: bool = False,
    translate_only: bool = False,
    block_window: Optional[Tuple[int, int]] = None,
    return_segments: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """``footprint.check_polygonal_paths_grouped``, with its arguments and
    results. CPU state: the plain version. CUDA state: one launch of
    kernel 3 (or an error: nothing falls back)."""
    dev = state.device
    args = (state, positions, quaternions, n_poses, footprint_xy, window, conservative,
            translate_only, block_window)
    if dev.type == "cpu":
        return footprint.check_polygonal_paths_grouped(*args, return_segments)
    if dev.type != "cuda":
        raise ValueError(f"check_polygonal_paths_grouped: unsupported device {dev}")
    return launch(kernel_inputs(*args), return_segments)


check_polygonal_paths_grouped.launches = 0


def check_polygonal_paths_bucketed(
    state: QueryState,
    positions,
    quaternions,
    n_poses,
    footprint_xy,
    plan,
    conservative: bool = False,
    translate_only: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The grouped evaluator under a ``footprint.plan_window_buckets`` plan:
    one ``check_polygonal_paths_grouped`` per bucket, with that bucket's
    window. Per-path results are independent of the batch, so verdicts and
    areas equal the single-window call's; traversability sums run over
    another window shape (within the last ulps). Same requirements as
    ``check_polygonal_paths_grouped``.
    """
    positions, quaternions, n_poses, fp = footprint._path_inputs(
        state, positions, quaternions, n_poses, footprint_xy
    )
    idx_groups, windows, inverse = plan
    outs = []
    for idx, window in zip(idx_groups, windows):
        ii = torch.as_tensor(idx, dtype=torch.int64, device=state.device)
        outs.append(check_polygonal_paths_grouped(
            state, positions[ii], quaternions[ii], n_poses[ii], fp, window,
            conservative, translate_only,
        ))
    inv = torch.as_tensor(inverse, dtype=torch.int64, device=state.device)
    return tuple(torch.cat([o[k] for o in outs])[inv] for k in range(3))


def _per_ring(rings):
    """(fail, cells, sum, area weight) per ring in the plain version's
    dtypes."""
    return rings[0], rings[1].to(torch.int64), rings[2], rings[3]


def occupancy(plan: PolyPlan) -> int:
    """Resident blocks per SM of kernel 3 for this plan."""
    return library().te_poly_paths_occupancy(plan.smem_bytes, int(plan.scratch_words > 0))


def kernel_bytes(P: int, N: int, V: int, plane_cells: int, pos_d: int = 3) -> int:
    """Bytes kernel 3 must move: poses, quaternions, pose counts, the
    footprint and the padded plane read once; the verdicts (bool, f32, f32)
    and the per-ring reductions (bool, int32, f32, f32) written once."""
    return P * N * 4 * (pos_d + 4) + P * 4 + V * 8 + plane_cells * 4 + P * 9 + P * N * 13


def work_counts(k: KernelInputs) -> Tuple[int, int, int]:
    """(hull point tests, binary searches, straddle tests) the function
    needs on these inputs, as kernel 3 counts them: the hull's test loop
    stops at the first point outside an edge, only the edges straddling a
    column's centre line are searched, and a ring's edges are tested only
    on the columns of its own span (those whose centre line lies within its
    points' y range: no edge straddles another column's), so all three
    depend on the data. One launch with the counters on."""
    work = torch.zeros(3, dtype=torch.int64, device=k.positions.device)
    launch(k, work=work)
    tests, searches, straddles = work.tolist()
    return tests, searches, straddles


def stage_cycles(k: KernelInputs) -> Tuple[int, ...]:
    """Warp cycles of each of ``STAGES`` in one launch of the stage-timing
    instantiation on these inputs (``clock64`` laps of each warp's lane 0,
    summed over warps): where the kernel's time goes, as shares."""
    stage = torch.zeros(len(STAGES), dtype=torch.int64, device=k.positions.device)
    launch(k, stage=stage)
    return tuple(stage.tolist())


def kernel_operations(P: int, N: int, V: int, wi: int, conservative: bool,
                      translate_only: bool, cells: int, hull_tests: int, searches: int,
                      straddle_tests: int) -> int:
    """Float32 operations of kernel 3 on this batch, an FMA counting two:
    per pose the rotation (22) and per vertex its transform (6); per segment
    the swept hull's 6 per vertex, or 14 per point test of the edge-matrix
    hull (`hull_tests`, the tests this batch needs: ``work_counts``); per
    edge and column of its ring's span a straddle test (2; `straddle_tests`,
    ``work_counts``); per binary search (`searches`, one per straddling
    edge and column) its set-up (6) and rounds (5 each); per cell inside a
    ring its three reductions (`cells`, the inside cells this batch's rings
    cover); per ring the shoelace area and the verdict (4 per point, 4)."""
    n_bits = max(1, math.ceil(math.log2(wi + 1)))
    S = max(N - 1, 0)
    M = ring_points(V, conservative)
    transform = P * N * (22 + 6 * V)
    hull = P * S * 6 * V if translate_only and not conservative else 14 * hull_tests
    edges = 2 * straddle_tests
    search = searches * (6 + 5 * n_bits)
    tail = P * (V + S * 2 * M) * 4 + P * N * 4
    return transform + hull + edges + search + 3 * cells + tail
