"""The map tiled over processes: halo-exchanged update, tiled circle field,
tiled path queries and the sharded online tick, over ``torch.distributed``.

The JAX package tiles the map over a 2-D device mesh inside one program
(``shard_map``). Here each process owns one tile of a gx x gy process grid
(``Grid``): one process per GPU over ``nccl``, or per CPU process over
``gloo`` when the caller asks for the CPU. Every entry point takes the
rank's own tile and the replicated inputs, and returns the rank's tile or a
result replicated on every rank.

- ``halo_pad``: rows from the neighbours along x, then columns, with the new
  rows, from the neighbours along y, so that the corners arrive in the
  second phase (``batch_isend_irecv`` in each grid column, then each row);
  the global edges take `fill`.
- ``sharded_update``: halo exchange, then kernel 1 on the padded tile with
  the tile's global origin (cells beyond the global map, halo or the padding
  that makes the map divide the grid, are out of map), then the crop.
- ``sharded_circle_field``: kernel 2 on the padded tile with an in-map plane
  from the tile's global origin.
- ``check_circular_paths_tiled`` / ``check_polygonal_paths_tiled``: every rank
  evaluates all paths against its own tile and ``all_reduce`` sums the
  ranks' parts; each in-map cell has one owner, so a per-sample sum is exact.
- ``sharded_online_tick``: merge, tiled re-filter, tiled field, tiled paths.

On a CUDA tile the tile bodies launch kernels 1 and 2; on a CPU tile they run
the plain versions. ``scatter_tiles`` / ``gather_tiles`` move whole planes
for callers that hold them on one rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from traversability_estimation_tpu_torch.device import DeviceLike, resolve_device
from traversability_estimation_tpu_torch.grid.geometry import global_in_map, line_cells_batch
from traversability_estimation_tpu_torch.ops import field_kernel, update_kernel
from traversability_estimation_tpu_torch.ops.filters import ChainConfig, f32, mul_rcp, sqrt_f32
from traversability_estimation_tpu_torch.ops.footprint import (
    QueryState,
    _aggregate_polygonal_path,
    _cell_coord,
    _crossing_count,
    _segment_rings,
    aggregate_sampled_segments,
    index_from_origin,
    map_origin,
    polygon_area,
    polygon_prefix_planes,
    transform_footprint,
)
from traversability_estimation_tpu_torch.ops.veto import VetoConfig, required_halo

# check_circular_paths_tiled sums per-PATH partials (O(paths) bytes on the
# wire, float sums reordered) instead of per-SAMPLE planes (exact) from this
# many samples on; check_polygonal_paths_tiled sums per-polygon partials
# instead of per-row ones from this many polygon rows on
_PATH_REDUCE_SAMPLES = 1 << 17
# the raster of a circular batch is split over the ranks from this much work on
_SHARD_RASTER_WORK = 1 << 18
# elements of one (B, wi, wj) window temporary per chunk of polygons
_WINDOW_CHUNK_ELEMS = 1 << 24


def backend_for(device: torch.device) -> str:
    """The process-group backend for tensors on `device`."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def grid_shape(n: int) -> Tuple[int, int]:
    """(gx, gy) for n processes, as square as possible (the halo volume
    grows with a tile's perimeter), gx <= gy."""
    gx = math.isqrt(n)
    while n % gx:
        gx -= 1
    return gx, n // gx


@dataclasses.dataclass(frozen=True)
class Grid:
    """A gx x gy grid of processes, one map tile each; rank r owns tile
    (r // gy, r % gy). `col_group` holds the ranks of this rank's grid
    column (its neighbours along x), `row_group` those of its grid row (its
    neighbours along y)."""

    gx: int
    gy: int
    rank: int
    device: torch.device
    row_group: Any = None
    col_group: Any = None

    @property
    def size(self) -> int:
        return self.gx * self.gy

    @property
    def ix(self) -> int:
        return self.rank // self.gy

    @property
    def iy(self) -> int:
        return self.rank % self.gy

    def rank_of(self, ix: int, iy: int) -> int:
        return ix * self.gy + iy


def make_grid(device: DeviceLike = None) -> Grid:
    """The grid over the initialised process group (``initialize_multihost``
    starts it). Every rank must call it: it creates the row and column
    subgroups. `device`: cuda (this process's current device) unless the
    caller asks for the CPU; it must match the group's backend."""
    if not dist.is_initialized():
        raise RuntimeError("make_grid: torch.distributed is not initialised (initialize_multihost)")
    dev = resolve_device(device)
    if dist.get_backend() != backend_for(dev):
        raise ValueError(
            f"make_grid: a {dev.type} grid needs the {backend_for(dev)} backend, "
            f"the process group runs {dist.get_backend()}"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    n, rank = dist.get_world_size(), dist.get_rank()
    gx, gy = grid_shape(n)
    rows = [dist.new_group([ix * gy + j for j in range(gy)]) for ix in range(gx)]
    cols = [dist.new_group([i * gy + iy for i in range(gx)]) for iy in range(gy)]
    return Grid(gx, gy, rank, dev, rows[rank // gy], cols[rank % gy])


def pad_to_mesh(elevation: np.ndarray, grid: Grid) -> Tuple[np.ndarray, Tuple[int, int]]:
    """NaN-pad (H, W) so that both sides divide the grid; returns (padded,
    original shape). Pass the original shape on as `orig_shape`: the padding
    is out of map."""
    H, W = elevation.shape
    Hp = -(-H // grid.gx) * grid.gx
    Wp = -(-W // grid.gy) * grid.gy
    if (Hp, Wp) == (H, W):
        return elevation, (H, W)
    out = np.full((Hp, Wp), np.nan, dtype=np.float32)
    out[:H, :W] = elevation
    return out, (H, W)


def tile_of(plane, grid: Grid, rank: Optional[int] = None):
    """Rank `rank`'s (default: this rank's) tile of a whole plane whose
    last two sides divide the grid."""
    rank = grid.rank if rank is None else rank
    H, W = plane.shape[-2:]
    if H % grid.gx or W % grid.gy:
        raise ValueError(f"a {H}x{W} plane does not divide the {grid.gx}x{grid.gy} grid (pad_to_mesh)")
    th, tw = H // grid.gx, W // grid.gy
    ix, iy = divmod(rank, grid.gy)
    return plane[..., ix * th : (ix + 1) * th, iy * tw : (iy + 1) * tw]


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A tensor the backends carry: bool as uint8."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def scatter_tiles(plane, grid: Grid, src: int = 0) -> torch.Tensor:
    """Each rank's tile of a float32 or bool (H, W) plane held by rank
    `src` (the other ranks pass None)."""
    dev = grid.device
    meta = torch.zeros(3, dtype=torch.int64, device=dev)
    tiles = None
    if grid.rank == src:
        plane = torch.as_tensor(plane, device=dev)
        if plane.dtype not in (torch.float32, torch.bool):
            raise ValueError(f"scatter_tiles: float32 or bool planes, not {plane.dtype}")
        tiles = [_wire(tile_of(plane, grid, r)) for r in range(grid.size)]
        meta = torch.tensor([*tiles[0].shape, int(plane.dtype == torch.bool)], device=dev)
    dist.broadcast(meta, src)
    th, tw, is_bool = meta.tolist()
    out = torch.empty((th, tw), dtype=torch.uint8 if is_bool else torch.float32, device=dev)
    dist.scatter(out, tiles, src)
    return out.view(torch.bool) if is_bool else out


def gather_tiles(tile: torch.Tensor, grid: Grid) -> torch.Tensor:
    """The whole plane, on every rank, from each rank's (..., th, tw) tile."""
    t = _wire(torch.as_tensor(tile, device=grid.device))
    parts = [torch.empty_like(t) for _ in range(grid.size)]
    dist.all_gather(parts, t)
    rows = [torch.cat(parts[ix * grid.gy : (ix + 1) * grid.gy], dim=-1) for ix in range(grid.gx)]
    out = torch.cat(rows, dim=-2)
    return out.view(torch.bool) if tile.dtype == torch.bool else out


def _filled(like: torch.Tensor, fill) -> torch.Tensor:
    """A tensor shaped as `like` holding `fill`: one value, or one per
    leading channel."""
    if isinstance(fill, (tuple, list)):
        vals = torch.tensor(fill, dtype=like.dtype, device=like.device)
        return vals.view(-1, *([1] * (like.dim() - 1))).expand(like.shape).clone()
    return torch.full_like(like, fill)


def _exchange_axis(t: torch.Tensor, halo: int, dim: int, n: int, idx: int, peer, group, fill):
    """`halo` rows (dim -2) or columns (dim -1) from the neighbours idx - 1
    and idx + 1 of n along one grid axis (global ranks `peer(i)`), `fill`
    at the grid's edges. Every rank of the axis posts its sends and receives
    in one batch."""
    if halo > t.shape[dim] and n > 1:
        raise ValueError(f"halo {halo} exceeds the tile's {t.shape[dim]} cells")
    send_fwd = t.narrow(dim, t.shape[dim] - halo, halo).contiguous()
    send_bwd = t.narrow(dim, 0, halo).contiguous()
    from_prev = _filled(send_fwd, fill)
    from_next = _filled(send_bwd, fill)
    ops = []
    if idx + 1 < n:
        ops += [dist.P2POp(dist.isend, send_fwd, peer(idx + 1), group, tag=0),
                dist.P2POp(dist.irecv, from_next, peer(idx + 1), group, tag=1)]
    if idx > 0:
        ops += [dist.P2POp(dist.isend, send_bwd, peer(idx - 1), group, tag=1),
                dist.P2POp(dist.irecv, from_prev, peer(idx - 1), group, tag=0)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([from_prev, t, from_next], dim=dim)


def halo_pad(tile: torch.Tensor, halo: int, fill: Union[float, Sequence[float]], grid: Grid):
    """The (..., th, tw) tile with `halo` cells of its neighbours' tiles on
    every side: rows along x first, then columns with the new rows along y,
    so that the corners arrive in the second phase. `fill` (one value, or
    one per leading channel) beyond the grid's edges."""
    tile = torch.as_tensor(tile, device=grid.device)
    if halo == 0:
        return tile
    padded = _exchange_axis(
        tile, halo, -2, grid.gx, grid.ix, lambda i: grid.rank_of(i, grid.iy), grid.col_group, fill)
    return _exchange_axis(
        padded, halo, -1, grid.gy, grid.iy, lambda j: grid.rank_of(grid.ix, j), grid.row_group, fill)


def _crop(t: torch.Tensor, halo: int) -> torch.Tensor:
    return t[..., halo : t.shape[-2] - halo, halo : t.shape[-1] - halo].contiguous()


def _frame(grid: Grid, tile_shape, halo: int, orig_shape):
    """(origin of the padded tile, global shape of the map)."""
    th, tw = tile_shape
    gshape = (grid.gx * th, grid.gy * tw) if orig_shape is None else tuple(orig_shape)
    return (grid.ix * th - halo, grid.iy * tw - halo), gshape


def tile_update(
    padded: torch.Tensor,
    chain_cfg: ChainConfig,
    veto_cfg: VetoConfig,
    halo: int,
    origin: Tuple[int, int],
    global_shape: Tuple[int, int],
) -> Dict[str, torch.Tensor]:
    """The tile body of the update: kernel 1 (the plain version on a CPU
    tile) on the padded tile, whose cell (0, 0) is global cell `origin` of
    the `global_shape` map, then the crop to the owned cells."""
    layers = update_kernel.fused_update(padded, chain_cfg, veto_cfg, origin, global_shape)
    return {k: _crop(v, halo) for k, v in layers.items()}


def sharded_update(
    elevation: torch.Tensor,
    chain_cfg: ChainConfig,
    veto_cfg: VetoConfig,
    grid: Grid,
    orig_shape: Optional[Tuple[int, int]] = None,
) -> Dict[str, torch.Tensor]:
    """The map update of this rank's (th, tw) elevation tile: every layer
    of ``fused_update`` on the whole map, cut to the tile. The halo is the
    chain's full reach, ``required_halo``. `orig_shape`: the map before
    ``pad_to_mesh`` (default: the grid of tiles)."""
    elev = torch.as_tensor(elevation, dtype=torch.float32, device=grid.device)
    halo = required_halo(chain_cfg, veto_cfg)
    origin, gshape = _frame(grid, elev.shape, halo, orig_shape)
    padded = halo_pad(elev, halo, math.nan, grid)
    return tile_update(padded, chain_cfg, veto_cfg, halo, origin, gshape)


def replicate_query_state(
    layers: Dict[str, torch.Tensor],
    grid: Grid,
    position,
    resolution: float,
    default_traversability: float = 0.5,
    orig_shape: Optional[Tuple[int, int]] = None,
) -> QueryState:
    """The whole query state on every rank (an all-gather of the two query
    planes, cut to `orig_shape`): pose batches are then answered by the
    local evaluators, split over the ranks with ``shard_pose_batch``."""
    trav = gather_tiles(layers["traversability"], grid)
    mask = gather_tiles(layers["traversable_mask"], grid)
    if orig_shape is not None:
        trav, mask = trav[: orig_shape[0], : orig_shape[1]], mask[: orig_shape[0], : orig_shape[1]]
    return QueryState(
        traversability=trav.contiguous(),
        traversable_mask=mask.contiguous(),
        position=torch.as_tensor(position, dtype=torch.float32, device=grid.device),
        resolution=resolution,
        default_traversability=default_traversability,
    )


def shard_pose_batch(poses, grid: Grid) -> torch.Tensor:
    """This rank's share of a (P, ...) pose or path batch (P must divide
    the number of ranks)."""
    poses = torch.as_tensor(poses, device=grid.device)
    P = poses.shape[0]
    if P % grid.size:
        raise ValueError(f"shard_pose_batch: {P} paths do not divide {grid.size} ranks")
    k = P // grid.size
    return poses[grid.rank * k : (grid.rank + 1) * k]


def tile_circle_field(
    trav: torch.Tensor,
    mask: torch.Tensor,
    halo: int,
    origin: Tuple[int, int],
    global_shape: Tuple[int, int],
    radius_max: float,
    radius_min: float,
    resolution: float,
    default_traversability: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tile body of the circle field: kernel 2 (the plain version on a
    CPU tile) on the padded tile with the in-map plane of its global origin,
    then the crop. The spiral is a stencil of reach ceil(radius_max / res),
    so the field is the whole map's."""
    in_map = global_in_map(trav.shape, origin, global_shape, trav.device)
    state = QueryState(
        traversability=trav,
        traversable_mask=mask,
        position=torch.zeros(2, dtype=torch.float32, device=trav.device),  # index space only
        resolution=resolution,
        default_traversability=default_traversability,
    )
    ok, tv = field_kernel.dense_circle_field(state, radius_max, radius_min, in_map)
    return _crop(ok, halo), _crop(tv, halo)


def field_halo(radius_max: float, resolution: float) -> int:
    return int(math.ceil(radius_max / resolution - 1e-12)) + 1


def sharded_circle_field(
    layers: Dict[str, torch.Tensor],
    grid: Grid,
    radius_max: float,
    radius_min: float,
    resolution: float,
    default_traversability: float = 0.5,
    orig_shape: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dense_circle_field`` of this rank's tile of the map, from the
    rank's tiles of the two query planes: (ok, trav) tiles, the whole map's
    field cut to the tile."""
    trav = torch.as_tensor(layers["traversability"], dtype=torch.float32, device=grid.device)
    mask = torch.as_tensor(layers["traversable_mask"], device=grid.device)
    halo = field_halo(radius_max, resolution)
    origin, gshape = _frame(grid, trav.shape, halo, orig_shape)
    padded = halo_pad(torch.stack([trav, mask.to(torch.float32)]), halo, (math.nan, 0.0), grid)
    return tile_circle_field(
        padded[0], padded[1] > 0.5, halo, origin, gshape, radius_max, radius_min, resolution,
        default_traversability,
    )


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    dist.all_reduce(t)
    return t


def check_circular_paths_tiled(
    field_ok: torch.Tensor,
    field_trav: torch.Tensor,
    poses,
    n_poses,
    grid: Grid,
    position: Tuple[float, float],
    resolution: float,
    max_segment_cells: int,
    default_traversability: float = 0.5,
    orig_shape: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Circular path checks against the TILED dense circle field (this
    rank's (ok, trav) tiles): no plane is replicated. Every rank samples all
    paths; each in-map sample has one owner, whose value one all_reduce
    brings to every rank. Returns (is_safe (P,), trav (P,)) on every rank.

    Below ``_PATH_REDUCE_SAMPLES`` samples the sums are per sample (each has
    one non-zero term, so the result is ``check_circular_paths``' bit for
    bit); from there on per path (the verdict stays exact, the mean sums in
    another order). Off-map samples take the default verdict, counted once
    (by rank 0) in the per-path sums. Single-pose paths are scored at the
    pose's CELL CENTRE (the local evaluator runs the sub-cell spiral there).
    """
    dev = grid.device
    ok_tile = torch.as_tensor(field_ok, device=dev)
    tv_tile = torch.as_tensor(field_trav, dtype=torch.float32, device=dev)
    th, tw = ok_tile.shape
    H, W = _frame(grid, (th, tw), 0, orig_shape)[1]
    poses = torch.as_tensor(poses, dtype=torch.float32, device=dev)
    n_poses = torch.as_tensor(n_poses, device=dev).to(torch.int32)
    Pn, N, _ = poses.shape
    default = f32(default_traversability)
    p0 = map_origin((H, W), torch.as_tensor(position, dtype=torch.float32, device=dev), resolution)
    S = (max_segment_cells + 3) // 4
    arange_s = torch.arange(S, device=dev)

    starts = poses[:, : max(N - 1, 1), :]
    ends = poses[:, 1:, :] if N > 1 else poses[:, :1, :]
    first = torch.arange(starts.shape[1], device=dev)[None, :] == 0
    seg_valid = torch.arange(1, max(N, 2), device=dev)[None, :] < n_poses[:, None]
    seg_valid = seg_valid | ((n_poses == 1)[:, None] & first)

    def raster(poses_s, n_poses_s):
        """Subsampled segment cells (p, N-1, S, 2) and their mask; a
        single-pose path is one sample at its pose's cell."""
        st = poses_s[:, : max(N - 1, 1), :]
        en = poses_s[:, 1:, :] if N > 1 else poses_s[:, :1, :]
        cells, cell_valid, _ = line_cells_batch(
            index_from_origin(p0, en, resolution), index_from_origin(p0, st, resolution),
            max_segment_cells)
        s_cells = cells[..., arange_s * 4, :]
        s_valid = cell_valid[..., arange_s * 4]
        single = (n_poses_s == 1)[:, None, None]
        pose0 = index_from_origin(p0, poses_s[:, 0, :], resolution)[:, None, None, :]
        s_cells = torch.where(single[..., None], pose0, s_cells)
        s_valid = torch.where(single, (arange_s == 0)[None, None, :], s_valid)
        return s_cells, s_valid

    n = grid.size
    if Pn % n == 0 and n > 1 and Pn * max(N - 1, 1) * max_segment_cells >= _SHARD_RASTER_WORK:
        # the Bresenham expansion is the arithmetic of this query: split it
        # over the ranks and gather only the subsampled cells
        k = Pn // n
        sl = slice(grid.rank * k, (grid.rank + 1) * k)
        c, v = raster(poses[sl], n_poses[sl])
        cs = [torch.empty_like(c) for _ in range(n)]
        vs = [torch.empty_like(_wire(v)) for _ in range(n)]
        dist.all_gather(cs, c)
        dist.all_gather(vs, _wire(v))
        s_cells, s_valid = torch.cat(cs), torch.cat(vs).view(torch.bool)
    else:
        s_cells, s_valid = raster(poses, n_poses)

    # this rank's tile at every sample
    gi, gj = s_cells[..., 0], s_cells[..., 1]
    li, lj = gi - grid.ix * th, gj - grid.iy * tw
    in_global = (gi >= 0) & (gi < H) & (gj >= 0) & (gj < W)
    owned = (li >= 0) & (li < th) & (lj >= 0) & (lj < tw) & in_global
    lin = li.clamp(0, th - 1).to(torch.int64) * tw + lj.clamp(0, tw - 1)
    ok_o = ok_tile.reshape(-1).to(torch.float32)[lin]
    tv_o = tv_tile.reshape(-1)[lin]

    samples = Pn * max(N - 1, 1) * S
    if samples < _PATH_REDUCE_SAMPLES:
        sums = _all_reduce(torch.stack([torch.where(owned, ok_o, 0.0), torch.where(owned, tv_o, 0.0)]))
        ok_s = torch.where(in_global, sums[0] > 0.5, default != 0.0)
        trav_s = torch.where(in_global, sums[1], default)
        ok1 = torch.where(s_valid[:, 0], ok_s[:, 0], True).all(dim=-1)
        trav1 = torch.where(ok1, trav_s[:, 0, 0], 0.0)
        return aggregate_sampled_segments(
            ok_s, trav_s, s_valid, seg_valid, starts, ends, n_poses, ok1, trav1)

    # per-path partial sums: each rank's part over the samples it owns, the
    # off-map samples' default once (rank 0)
    take_default = ~in_global & (grid.rank == 0)
    ok_samp = torch.where(owned, ok_o > 0.5, True)
    if default == 0.0:
        ok_samp = ok_samp & ~take_default
    tv_samp = torch.where(owned, tv_o, 0.0) + torch.where(take_default, default, 0.0)
    s_active = s_valid & seg_valid[..., None]
    not_ok_part = (s_active & ~ok_samp).to(torch.float32).sum(dim=(-2, -1))
    n_s = s_active.sum(dim=-1).clamp_min(1)
    seg_num_part = torch.where(s_active, tv_samp, 0.0).sum(dim=-1)
    d = ends - starts
    seg_len = sqrt_f32(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    w = torch.where(seg_valid, seg_len, 0.0)
    w = torch.where(w.sum(dim=-1, keepdim=True) > 0.0, w, seg_valid.to(torch.float32))
    path_num_part = ((w / n_s) * seg_num_part).sum(dim=-1)
    ok1_fail_part = (s_valid[:, 0] & ~ok_samp[:, 0]).to(torch.float32).sum(dim=-1)
    parts = _all_reduce(torch.stack(
        [not_ok_part, path_num_part, ok1_fail_part, tv_samp[:, 0, 0]], dim=-1))
    not_ok, path_num, ok1_fail, trav1 = parts.unbind(-1)
    ok1 = ok1_fail == 0.0
    is_single = n_poses == 1
    safe = torch.where(is_single, ok1, not_ok == 0.0) & (n_poses >= 1)
    path_trav = path_num / torch.clamp_min(w.sum(dim=-1), 1e-30)
    trav = torch.where(is_single, torch.where(ok1, trav1, 0.0), path_trav)
    return safe, torch.where(safe, trav, 0.0)


def check_polygonal_paths_tiled(
    layers: Dict[str, torch.Tensor],
    positions,
    quaternions,
    n_poses,
    footprint,
    grid: Grid,
    window,
    position: Tuple[float, float],
    resolution: float,
    conservative: bool = False,
    default_traversability: float = 0.5,
    orig_shape: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Polygonal footprint paths against the TILED map (this rank's tiles of
    the two query planes): no plane is replicated. Every rank computes the
    same row spans of every convex polygon (hull of consecutive footprints),
    cuts each span to its tile, reads its tile's ``polygon_prefix_planes``,
    and all_reduce sums the ranks' parts. The footprint must be CONVEX
    (the single-pose polygon is scored by its spans too). `window` as in
    ``polygon_window_cells``. Returns (is_safe, traversability, area) (P,)
    on every rank.

    Below ``_PATH_REDUCE_SAMPLES`` polygon rows (and for windows under
    32768 cells, where a polygon's packed count fits int32) the sums are per
    row, else per polygon: the counts are exact either way, the float score
    sums reorder.
    """
    dev = grid.device
    trav_tile = torch.as_tensor(layers["traversability"], dtype=torch.float32, device=dev)
    mask_tile = torch.as_tensor(layers["traversable_mask"], device=dev)
    th, tw = trav_tile.shape
    H, W = _frame(grid, (th, tw), 0, orig_shape)[1]
    positions = torch.as_tensor(positions, dtype=torch.float32, device=dev)
    quaternions = torch.as_tensor(quaternions, dtype=torch.float32, device=dev)
    n_poses = torch.as_tensor(n_poses, device=dev).to(torch.int32)
    fp = torch.as_tensor(np.asarray(footprint, np.float32), device=dev)
    Pn, N, _ = positions.shape
    V = fp.shape[0]
    default = f32(default_traversability)
    wi, wj = (window, window) if isinstance(window, int) else window
    # the map's origin as the JAX tiled evaluator takes it: computed in float64
    # on the host, then rounded once
    p0x = torch.tensor(f32(position[0] + H * resolution * 0.5), device=dev)
    p0y = torch.tensor(f32(position[1] + W * resolution * 0.5), device=dev)
    gi0, gj0 = grid.ix * th, grid.iy * tw

    in_map = global_in_map((th, tw), (gi0, gj0), (H, W), dev)
    counts_p, tv_p = polygon_prefix_planes(
        QueryState(trav_tile, mask_tile, torch.zeros(2, device=dev), resolution,
                   default_traversability),
        in_map,
    )
    counts_flat, tv_flat = counts_p.reshape(-1), tv_p.reshape(-1)
    offs_i = torch.arange(wi, dtype=torch.int32, device=dev) - wi // 2
    offs_j = torch.arange(wj, dtype=torch.int32, device=dev) - wj // 2
    reduce_polygons = wi * wj < 32768

    def spans(vertices, nv, anchors):
        """This rank's part of each polygon's rows: (count delta (B, wi)
        int32, score delta (B, wi) f32)."""
        ai = torch.floor(mul_rcp(p0x - anchors[:, 0], resolution)).to(torch.int32)
        aj = torch.floor(mul_rcp(p0y - anchors[:, 1], resolution)).to(torch.int32)
        gi = ai[:, None] + offs_i
        gj = aj[:, None] + offs_j
        px = _cell_coord(p0x, gi.to(torch.float32), resolution)
        py = _cell_coord(p0y, gj.to(torch.float32), resolution)
        inside = _crossing_count(vertices, nv, px, py)  # (B, wi, wj)
        any_row = inside.any(dim=-1)
        j_first = inside.to(torch.uint8).argmax(dim=-1).to(torch.int32)
        j_last = wj - 1 - inside.flip(-1).to(torch.uint8).argmax(dim=-1).to(torch.int32)
        g0 = (gj[:, :1] + j_first).clamp(0, W)
        g1 = (gj[:, :1] + j_last + 1).clamp(0, W)
        row_ok = any_row & (gi >= 0) & (gi < H) & (g1 > g0)
        l0 = (g0 - gj0).clamp(0, tw)
        l1 = (g1 - gj0).clamp(0, tw)
        li = gi - gi0
        mine = row_ok & (li >= 0) & (li < th) & (l1 > l0)
        base = li.clamp(0, th - 1).to(torch.int64) * (tw + 1)
        lin0 = base + torch.where(mine, l0, 0)
        lin1 = base + torch.where(mine, l1, 0)
        dc = torch.where(mine, counts_flat[lin1] - counts_flat[lin0], 0)
        dtv = torch.where(mine, tv_flat[lin1] - tv_flat[lin0], 0.0)
        return dc, dtv

    def scorer(vertices, nv, anchors):
        """(ok, trav, n_cells) of convex polygons over the whole map."""
        B = vertices.shape[0]
        nv = torch.as_tensor(nv, device=dev).to(torch.int32).expand(B)
        chunk = max(1, _WINDOW_CHUNK_ELEMS // (wi * wj))
        parts = [spans(vertices[b : b + chunk], nv[b : b + chunk], anchors[b : b + chunk])
                 for b in range(0, B, chunk)]
        dc, dtv = torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
        if B * wi >= _PATH_REDUCE_SAMPLES and reduce_polygons:
            # polygons before the sum: (B,) buffers on the wire instead of (B, wi)
            dc = _all_reduce(dc.sum(dim=-1, dtype=torch.int32))
            dtv = _all_reduce(dtv.sum(dim=-1))
            fail_cnt = dc // 65536
            fail = fail_cnt > 0
            n_cells = dc - fail_cnt * 65536
            mean = dtv / n_cells.clamp_min(1)
        else:
            dc = _all_reduce(dc.contiguous())
            dtv = _all_reduce(dtv.contiguous())
            fail_cnt = dc // 65536
            fail = fail_cnt.sum(dim=-1) > 0
            n_cells = (dc - fail_cnt * 65536).sum(dim=-1)
            mean = dtv.sum(dim=-1) / n_cells.clamp_min(1)
        empty = (n_cells == 0) & ~fail
        ok = ~fail & (~empty | (default != 0.0))
        trav = torch.where(fail, 0.0, torch.where(empty, default, mean))
        return ok, trav, n_cells

    polys = transform_footprint(fp, positions, quaternions)  # (P, N, V, 2)
    ok1, trav1, _ = scorer(polys[:, 0], V, positions[:, 0, :2])
    area1 = polygon_area(polys[:, 0], V)
    if N == 1:
        safe = ok1 & (n_poses >= 1)
        return safe, torch.where(ok1, trav1, 0.0), torch.where(ok1, area1, 0.0)

    rings, n_ring, poly1 = _segment_rings(polys, positions, fp, conservative, False)
    Mh = rings.shape[2]
    mids = (0.5 * (positions[:, 1:, :2] + positions[:, :-1, :2])).reshape(Pn * (N - 1), 2)
    seg_ok, seg_trav, _ = scorer(
        rings.reshape(Pn * (N - 1), Mh, 2), n_ring.reshape(Pn * (N - 1)), mids)
    return _aggregate_polygonal_path(
        seg_ok.reshape(Pn, N - 1),
        seg_trav.reshape(Pn, N - 1),
        polygon_area(rings, n_ring),
        polygon_area(poly1, poly1.shape[2]),
        n_poses, ok1, trav1, area1,
    )


def sharded_online_tick(
    elevation: torch.Tensor,
    patch,
    merge_start: Tuple[int, int],
    poses,
    n_poses,
    *,
    grid: Grid,
    chain_cfg: ChainConfig,
    veto_cfg: VetoConfig,
    radius: float,
    offset: float,
    resolution: float,
    max_segment_cells: int,
    default_traversability: float = 0.5,
    orig_shape: Optional[Tuple[int, int]] = None,
    position: Tuple[float, float] = (0.0, 0.0),
):
    """One online tick on the tiled map: merge the (replicated) submap
    `patch` at global cell `merge_start` into this rank's elevation tile,
    re-filter every tile (``sharded_update``), build the tiled circle field
    and answer the tick's circular paths against it. Returns (elevation
    tile, layer tiles, is_safe (P,), trav (P,)).

    A patch that leaves the map raises ValueError (the JAX tick's dynamic
    slice clamps its start and writes elsewhere).
    """
    elev = torch.as_tensor(elevation, dtype=torch.float32, device=grid.device)
    patch = torch.as_tensor(patch, dtype=torch.float32, device=grid.device)
    th, tw = elev.shape
    H, W = _frame(grid, (th, tw), 0, orig_shape)[1]
    mi, mj = (int(v) for v in merge_start)
    ph, pw = patch.shape
    if not (0 <= mi and mi + ph <= H and 0 <= mj and mj + pw <= W):
        raise ValueError(
            f"sharded_online_tick: merge region ({mi}, {mj})+({ph}, {pw}) leaves the {H}x{W} map")
    # the part of the patch that lands in this tile
    ti0, tj0 = grid.ix * th, grid.iy * tw
    i0, i1 = max(mi, ti0), min(mi + ph, ti0 + th)
    j0, j1 = max(mj, tj0), min(mj + pw, tj0 + tw)
    if i0 < i1 and j0 < j1:
        elev = elev.clone()
        elev[i0 - ti0 : i1 - ti0, j0 - tj0 : j1 - tj0] = patch[i0 - mi : i1 - mi, j0 - mj : j1 - mj]
    layers = sharded_update(elev, chain_cfg, veto_cfg, grid, orig_shape=orig_shape)
    ok_f, tv_f = sharded_circle_field(
        layers, grid, radius + offset, radius, resolution, default_traversability, orig_shape)
    safe, trav = check_circular_paths_tiled(
        ok_f, tv_f, poses, n_poses, grid, position, resolution, max_segment_cells,
        default_traversability, orig_shape)
    return elev, layers, safe, trav
