"""Host profile of the polygonal cell's path batch: which host functions the
time of ``check_polygonal_paths_batch`` goes to.

Per epoch of the benchmark's cell ``poly_paths_336`` (its map and traffic
from ``BENCHMARK.json``, its inputs from ``bench_torch.inputs.epoch_inputs``
of the seed): one ``update()``, which synchronises, then the path batch with
its verdicts fetched, as the cell's ``poly_batch`` span times it. The batch
runs once per epoch without a profiler and once under ``cProfile``. Prints
the batch's median wall both ways, then per function of the port, and per
builtin (torch and NumPy calls, ``.cpu()``), its cumulative and own ms per
epoch. cProfile slows Python code more than the native calls under it: it
says where the host time goes, the benchmark says how much there is.

Usage, from the repository root:
    python -m traversability_estimation_tpu_torch.scripts.host_profile
        [--epochs 20] [--warmup 3] [--seed 0] [--top 25] [--json F]
        [--device cuda|cpu] [--map-cells C --paths P --poses N]
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

CELL = "poly_paths_336"
PACKAGE = "traversability_estimation_tpu_torch"
ROOT = Path(__file__).resolve().parents[2]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=25, help="functions printed")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--map-cells", type=int, help="a smaller map (the cell's by default)")
    ap.add_argument("--paths", type=int)
    ap.add_argument("--poses", type=int)
    ap.add_argument("--json", help="also write the result to this file")
    return ap


def _cell(args):
    """(traffic with the run's paths and poses, map side in cells,
    resolution) of the cell in ``BENCHMARK.json``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = next(w for w in bench["workloads"] if w["name"] == CELL)
    conf = bench["configurations"][spec["configuration"]]
    traffic = dict(spec["traffic"])
    traffic["paths"] = args.paths or traffic["paths"]
    traffic["poses"] = args.poses or traffic["poses"]
    return traffic, args.map_cells or conf["map"]["cells"][0], conf["map"]["resolution_m"]


def _rows(stats: pstats.Stats, epochs: int, top: int):
    """The port's functions and the builtins, by cumulative time."""
    rows = []
    for (file, line, func), (_, calls, own, cum, _) in stats.stats.items():
        if file == "~":
            name = func
        elif PACKAGE in file:
            name = f"{file[file.rindex(PACKAGE):]}:{line}({func})"
        else:
            continue
        rows.append({"function": name, "cum_ms": 1e3 * cum / epochs,
                     "own_ms": 1e3 * own / epochs, "calls": calls / epochs})
    rows.sort(key=lambda r: -r["cum_ms"])
    return rows[:top]


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    from bench_torch.inputs import epoch_inputs
    from traversability_estimation_tpu_torch import (
        TraversabilityEstimator,
        config_from_documents,
        reference_documents,
    )
    from traversability_estimation_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    traffic, cells, res = _cell(args)
    epochs = epoch_inputs(traffic, cells, res, args.seed, range(args.warmup + args.epochs))
    est = TraversabilityEstimator(config_from_documents(**reference_documents()), device=dev)
    rect = np.asarray(est.config.footprint.footprint_polygon, np.float32)

    def batch(ep):
        out = est.check_polygonal_paths_batch(ep.positions, ep.quaternions, ep.n_poses, rect,
                                              traffic["conservative"])
        return [o.cpu() for o in out]

    prof = cProfile.Profile()
    plain, profiled = [], []
    for i, ep in enumerate(epochs):
        est.update(ep.elevation)
        for walls, on in ((plain, False), (profiled, True)):
            t0 = time.perf_counter()
            if on:
                prof.enable()
            batch(ep)
            if on:
                prof.disable()
            if i >= args.warmup:
                walls.append(1e3 * (time.perf_counter() - t0))
        if i + 1 == args.warmup:
            prof = cProfile.Profile()  # the warm-up's calls are not profiled
    if dev.type == "cuda":
        card = torch.cuda.get_device_name(0)
    else:
        card = "cpu, not a device measurement"
    out = {
        "cell": CELL, "device": card, "epochs": args.epochs,
        "paths": traffic["paths"], "poses": traffic["poses"], "map_cells": cells,
        "poly_batch_ms_p50": statistics.median(plain),
        "poly_batch_ms_p50_profiled": statistics.median(profiled),
        "dispatch": est.last_polygonal_dispatch,
        "functions": _rows(pstats.Stats(prof), args.epochs, args.top),
    }
    print(f"host profile of {CELL}'s path batch ({traffic['paths']} x {traffic['poses']}, "
          f"{cells}^2), {args.epochs} epochs on {card}: wall p50 "
          f"{out['poly_batch_ms_p50']:.3f} ms, {out['poly_batch_ms_p50_profiled']:.3f} ms "
          f"profiled; {out['dispatch']}")
    print(f"{'cum ms':>9} {'own ms':>9} {'calls':>7}  function (per epoch)")
    for r in out["functions"]:
        print(f"{r['cum_ms']:9.3f} {r['own_ms']:9.3f} {r['calls']:7.1f}  {r['function']}")
    if args.json:
        Path(args.json).write_text(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
