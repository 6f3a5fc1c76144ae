"""Multi-process tiled update and pose-batch query (config 5's scaffolding).

Run one process per GPU (``nccl``), or per CPU process with ``--device cpu``
(``gloo``). Each process joins the group through
``parallel/multihost.initialize_multihost``, owns one tile of a
``--map-cells`` square map, runs the halo-exchanged ``sharded_update``,
all-gathers the query planes (``replicate_query_state``) and answers its
share of a batch of 64 circular paths per process (``shard_pose_batch``);
the verdicts are gathered on every process. Two CPU processes on one host:

  python -m traversability_estimation_tpu_torch.scripts.multihost_demo \\
      --num-processes 2 --process-id 0 --device cpu &
  python -m traversability_estimation_tpu_torch.scripts.multihost_demo \\
      --num-processes 2 --process-id 1 --device cpu

Under ``torchrun`` the three group arguments may be omitted (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (default localhost:12321, or torchrun's)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--map-cells", type=int, default=512)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: one GPU per process over nccl (default); cpu: gloo")
    return ap


def main(argv=None):
    """Run the demo; returns (is_safe, traversability) of every path as
    numpy arrays, the same on every process."""
    args = parser().parse_args(argv)

    import torch
    import torch.distributed as dist

    from traversability_estimation_tpu_torch.ops import footprint as fp_ops
    from traversability_estimation_tpu_torch.ops.filters import ChainConfig
    from traversability_estimation_tpu_torch.ops.veto import VetoConfig
    from traversability_estimation_tpu_torch.parallel import sharding as sh
    from traversability_estimation_tpu_torch.parallel.multihost import initialize_multihost

    coordinator = args.coordinator
    if coordinator is None and "MASTER_ADDR" not in os.environ:
        coordinator = "localhost:12321"
    grid = initialize_multihost(coordinator, args.num_processes, args.process_id,
                                device=args.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    print(f"process {rank}/{world}: grid {grid.gx}x{grid.gy} over {dist.get_backend()}")

    res = 0.03
    ccfg = ChainConfig(resolution=res)
    vcfg = VetoConfig(resolution=res, check_roughness=True)
    rng = np.random.default_rng(0)  # the same seed on every process: one map
    n = args.map_cells
    elev = (0.05 * rng.standard_normal((n, n))).astype(np.float32)
    padded, orig = sh.pad_to_mesh(elev, grid)
    tile = torch.as_tensor(np.ascontiguousarray(sh.tile_of(padded, grid)), device=grid.device)

    layers = sh.sharded_update(tile, ccfg, vcfg, grid, orig)
    state = sh.replicate_query_state(layers, grid, (0.0, 0.0), res, orig_shape=orig)

    P, N = 64 * world, 8
    starts = rng.uniform(-2, 2, (P, 2))
    steps = rng.uniform(-0.1, 0.1, (P, N - 1, 2))
    poses = np.concatenate([starts[:, None], starts[:, None] + np.cumsum(steps, 1)], 1).astype(
        np.float32)
    mine = sh.shard_pose_batch(poses, grid)
    n_mine = torch.full((mine.shape[0],), N, dtype=torch.int32, device=grid.device)
    safe, trav = fp_ops.check_circular_paths(state, mine, n_mine, 0.3, 0.15, 16)
    # the verdicts span the processes: gather before looking at them
    safe_parts = [torch.empty_like(safe, dtype=torch.uint8) for _ in range(world)]
    trav_parts = [torch.empty_like(trav) for _ in range(world)]
    dist.all_gather(safe_parts, safe.to(torch.uint8))
    dist.all_gather(trav_parts, trav)
    safe_g = torch.cat(safe_parts).bool().cpu().numpy()
    trav_g = torch.cat(trav_parts).cpu().numpy()
    mean = float(trav_g[safe_g].mean()) if safe_g.any() else float("nan")
    print(f"process {rank}: {P} paths checked, safe={int(safe_g.sum())}, mean trav={mean:.3f}")
    dist.destroy_process_group()
    return safe_g, trav_g


if __name__ == "__main__":
    main()
