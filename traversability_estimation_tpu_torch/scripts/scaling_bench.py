"""Scaling of the tiled path: per-process throughput at world sizes 1, 2, 4, 8.

For each world size n of ``--sizes`` the script starts n processes of
itself (one per GPU over ``nccl``; with ``--device cpu``, CPU processes over
``gloo``), which join one process group through
``parallel/multihost.initialize_multihost`` and measure:

1. ``sharded_update``: the filter chain and veto fields with the halo
   exchange, a fixed tile of ``--tile`` x ``--tile`` cells per process (weak
   scaling: the map grows with n). efficiency(n) = cells/s/process(n) /
   cells/s/process(1).
2. ``check_circular_paths_tiled``: a fixed batch of ``--paths`` x
   ``--poses`` circular paths against the tiled circle field (the map is
   never replicated), the verdicts summed over the ranks.

Each time is the two-point slope over two loop lengths of data-chained calls
(``utils/profiling.adaptive_slope_stats``: CUDA events on the card, the host
clock on the CPU), so launch and start-up costs cancel. Rank 0 prints one JSON
line per world size and workload and a summary line. A world needs n cards
over ``nccl``; sizes beyond the cards present are dropped. On the CPU the
processes share one host's cores, so the report marks the backend and its
efficiencies say nothing of NVLink.

Usage: python -m traversability_estimation_tpu_torch.scripts.scaling_bench
       [--sizes 1 2 4 8] [--tile 256] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _spread_fields(stats) -> dict:
    return {
        "med_ms": round(stats["median_s"] * 1e3, 4),
        "lo_ms": round(stats["lo_s"] * 1e3, 4),
        "hi_ms": round(stats["hi_s"] * 1e3, 4),
        "n": stats["n"],
    }


def _timed_slope(make_loop, arg, k1: int, k2: int, grid, min_diff_s: float = 12e-3,
                 max_escalations: int = 6):
    """(seconds per iteration, stats): the two-point slope of
    ``adaptive_slope_stats`` at loop lengths that every rank agrees on. The
    ranks' loops meet in collectives, so one rank may not lengthen its loops
    alone: after each measurement the smallest difference over the ranks
    decides, and below `min_diff_s` every rank quadruples both lengths."""
    import torch
    import torch.distributed as dist

    from traversability_estimation_tpu_torch.utils.profiling import adaptive_slope_stats

    for attempt in range(max_escalations + 1):
        s = adaptive_slope_stats(make_loop, arg, k1, k2, 0.0, reps=5, max_escalations=0)
        diff = torch.tensor([s["slope_s"] * s["k_gap"]], dtype=torch.float64, device=grid.device)
        dist.all_reduce(diff, op=dist.ReduceOp.MIN)
        if float(diff) >= min_diff_s or attempt == max_escalations:
            return s["slope_s"], s
        k1, k2 = 4 * k1, 4 * k2
        if grid.rank == 0:
            log(f"slope below timing resolution ({float(diff) * 1e3:.2f} ms); "
                f"retrying with K={k1}/{k2}")


def run_worker(args):
    """One process of a world: join it, measure, print rows from rank 0."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from traversability_estimation_tpu_torch.ops.filters import ChainConfig
    from traversability_estimation_tpu_torch.ops.veto import VetoConfig
    from traversability_estimation_tpu_torch.parallel import multihost
    from traversability_estimation_tpu_torch.parallel import sharding as sh

    grid = multihost.initialize_multihost(args.coordinator, args.world, args.rank,
                                          device=args.device)
    dev = grid.device
    backend = dist.get_backend()
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    res = 0.03
    ccfg = ChainConfig(resolution=res)
    vcfg = VetoConfig(resolution=res)
    n = grid.size
    H, W = args.tile * grid.gx, args.tile * grid.gy
    rng = np.random.default_rng(0)  # the same seed on every rank: one map
    elev = (0.05 * rng.standard_normal((H, W))).astype(np.float32)
    elev[rng.random((H, W)) < 0.02] = np.nan
    tile = torch.as_tensor(np.ascontiguousarray(sh.tile_of(elev, grid)), device=dev)

    def make_update_loop(k):
        def loop(e):
            for _ in range(k):
                layers = sh.sharded_update(e, ccfg, vcfg, grid)
                e = e + 1e-12 * torch.nan_to_num(layers["traversability"])
            return e
        return loop

    t_upd, upd_stats = _timed_slope(make_update_loop, tile, args.k1, args.k2, grid)
    cells_s = H * W / t_upd
    rows = [{
        "kind": "scaling_update",
        "backend": backend,
        "device": name,
        "mesh": n,
        "grid": [grid.gx, grid.gy],
        "map": [H, W],
        "t_iter_ms": round(t_upd * 1e3, 4),
        "cells_per_s": round(cells_s, 1),
        "cells_per_s_per_device": round(cells_s / n, 1),
        **_spread_fields(upd_stats),
    }]

    # tiled circular path queries (a fixed batch)
    layers = sh.sharded_update(tile, ccfg, vcfg, grid)
    field = sh.sharded_circle_field(layers, grid, 0.45, 0.3, res)
    P, N = args.paths, args.poses
    extent = H * res / 2 * 0.7
    starts = np.stack([rng.uniform(-extent, extent, P), rng.uniform(-extent, extent, P)], -1)
    steps = rng.uniform(-0.06, 0.06, (P, N - 1, 2))
    poses = np.concatenate([starts[:, None], starts[:, None] + np.cumsum(steps, 1)], 1).astype(
        np.float32)
    poses_d = torch.as_tensor(poses, device=dev)
    n_poses = torch.full((P,), N, dtype=torch.int32, device=dev)

    def make_query_loop(k):
        def loop(p):
            for _ in range(k):
                _, trav = sh.check_circular_paths_tiled(
                    field[0], field[1], p, n_poses, grid, (0.0, 0.0), res, 16)
                p = p + 1e-9 * trav[:, None, None]
            return p
        return loop

    t_qry, qry_stats = _timed_slope(make_query_loop, poses_d, args.k1, args.k2, grid)
    rows.append({
        "kind": "scaling_tiled_query",
        "backend": backend,
        "device": name,
        "mesh": n,
        "t_iter_ms": round(t_qry * 1e3, 4),
        "checks_per_s": round(P * N / t_qry, 1),
        **_spread_fields(qry_stats),
    })
    if grid.rank == 0:
        for r in rows:
            print(json.dumps(r), flush=True)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(args, n: int, timeout: float = 900.0):
    """Start a world of n processes of this script and return rank 0's rows."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH", "")) if p)
    if args.device == "cpu":
        # the world's processes share the host's cores
        env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // n)))
    cmd = [sys.executable, "-m", "traversability_estimation_tpu_torch.scripts.scaling_bench",
           "--worker", "--world", str(n), "--coordinator", f"localhost:{_free_port()}",
           "--device", args.device, "--tile", str(args.tile), "--paths", str(args.paths),
           "--poses", str(args.poses), "--k1", str(args.k1), "--k2", str(args.k2)]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=str(REPO), env=env,
                              stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL)
             for r in range(n)]
    try:
        out, _ = procs[0].communicate(timeout=timeout)
        for p in procs[1:]:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"a world of {n} failed: exit codes {[p.returncode for p in procs]}")
    return [json.loads(line) for line in out.decode().splitlines() if line.startswith("{")]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--tile", type=int, default=256, help="per-process tile edge")
    ap.add_argument("--paths", type=int, default=256)
    ap.add_argument("--poses", type=int, default=8)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: one process per GPU over nccl (default); cpu: gloo")
    ap.add_argument("--k1", type=int, default=4)
    ap.add_argument("--k2", type=int, default=12)
    ap.add_argument("--worker", action="store_true", help="(internal) one process of a world")
    ap.add_argument("--world", type=int, default=1, help="(internal)")
    ap.add_argument("--rank", type=int, default=0, help="(internal)")
    ap.add_argument("--coordinator", default=None, help="(internal)")
    return ap


def main(argv=None):
    """Run every world size; prints and returns the rows and the summary."""
    args = parser().parse_args(argv)
    if args.worker:
        run_worker(args)
        return None

    import torch

    from traversability_estimation_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    sizes = list(args.sizes)
    if dev.type == "cuda":
        sizes = [n for n in sizes if n <= torch.cuda.device_count()]
        if sizes != args.sizes:
            log(f"trimmed world sizes to the {torch.cuda.device_count()} card(s): {sizes}")
    results = []
    for n in sizes:
        log(f"world of {n} process(es), {args.device}")
        results.extend(run_world(args, n))
    base = next(r for r in results if r["kind"] == "scaling_update")["cells_per_s_per_device"]
    for r in results:
        if r["kind"] == "scaling_update":
            r["efficiency"] = round(r["cells_per_s_per_device"] / base, 3)
        print(json.dumps(r), flush=True)
    eff2 = next((r["efficiency"] for r in results
                 if r.get("mesh") == 2 and "efficiency" in r), None)
    backend = results[0]["backend"]
    summary = {
        "kind": "scaling_summary",
        "backend": backend,
        "device": results[0]["device"],
        "meshes": sizes,
        "efficiency_at_2": eff2,
        "note": (
            "gloo CPU processes on one host: validates the tiled plumbing and the report "
            "format; the processes share the host's cores, so efficiencies say nothing of "
            "NVLink" if backend == "gloo" else "one process per card over nccl"
        ),
    }
    print(json.dumps(summary), flush=True)
    return results + [summary]


if __name__ == "__main__":
    main()
