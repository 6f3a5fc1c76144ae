"""Host profile of a unit of the benchmark: which host functions the time
of ``check_polygonal_paths_batch`` (cell ``poly_paths_336``), of
``check_circular_paths_batch`` (cell ``circ_paths_336``) or of a fused
``online_tick`` (cell ``online_tick_1667``) goes to.

Per epoch of an epoch cell (its map and traffic from ``BENCHMARK.json``, its
inputs from ``bench_torch.inputs.epoch_inputs`` / ``circ_epoch_inputs`` of
the seed): one ``update()``, which synchronises, then the path batch with
its verdicts fetched, as the cell's ``poly_batch`` / ``circ_batch`` span
times it. The batch runs once per epoch without a profiler and once under
``cProfile``; in the circular cell each of the two follows its own
``update()`` of the epoch's plane, so both build the epoch's circle field as
the cell's batch does. The tick cell (``bench_torch.inputs.tick_inputs``)
runs each tick's inputs twice, once each way, its verdicts fetched, as the
cell's ``tick`` span times it, after a first tick and the warm-up. Prints
the unit's median wall both ways, then per function of the port, and per
builtin (torch and NumPy calls, ``.cpu()``), its cumulative and own ms per
unit. cProfile slows Python code more than the native calls under it: it
says where the host time goes, the benchmark says how much there is.

Usage, from the repository root:
    python -m traversability_estimation_tpu_torch.scripts.host_profile
        [--cell poly_paths_336|circ_paths_336|online_tick_1667] [--epochs 20]
        [--warmup 3] [--seed 0] [--top 25] [--json F] [--device cuda|cpu]
        [--map-cells C --paths P --poses N] [--root DIR]
``--root``: the tree whose package is profiled (another checkout, say the
parent's), this one by default.
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

CELLS = {"poly_paths_336": "poly_batch", "circ_paths_336": "circ_batch",
         "online_tick_1667": "tick"}
PACKAGE = "traversability_estimation_tpu_torch"
ROOT = Path(__file__).resolve().parents[2]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default="poly_paths_336", choices=sorted(CELLS))
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=25, help="functions printed")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--map-cells", type=int, help="a smaller map (the cell's by default)")
    ap.add_argument("--paths", type=int)
    ap.add_argument("--poses", type=int)
    ap.add_argument("--json", help="also write the result to this file")
    ap.add_argument("--root", type=Path, default=ROOT, help="the tree to import the port from")
    return ap


def _cell(args):
    """(traffic with the run's paths and poses, map side in cells,
    resolution) of the cell in ``BENCHMARK.json``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = next(w for w in bench["workloads"] if w["name"] == args.cell)
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
    root = args.root.resolve()
    if root != ROOT:
        sys.path.insert(0, str(root))
        for name in [m for m in sys.modules if m == PACKAGE or m.startswith(PACKAGE + ".")]:
            del sys.modules[name]
    from bench_torch.inputs import circ_epoch_inputs, epoch_inputs, tick_inputs
    import traversability_estimation_tpu_torch as port
    from traversability_estimation_tpu_torch import (
        TraversabilityEstimator,
        config_from_documents,
        reference_documents,
    )
    from traversability_estimation_tpu_torch.device import resolve_device

    if Path(port.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {port.__file__}, not the tree at {root}")
    dev = resolve_device(args.device)
    traffic, cells, res = _cell(args)
    circular = args.cell == "circ_paths_336"
    ticking = args.cell == "online_tick_1667"
    est = TraversabilityEstimator(config_from_documents(**reference_documents()), device=dev)
    rect = np.asarray(est.config.footprint.footprint_polygon, np.float32)
    if ticking:
        epochs = tick_inputs(traffic, cells * res, res, args.seed, 1 + args.warmup + args.epochs)
        est.set_elevation_map(np.full((cells, cells), np.nan, np.float32))
        tk = epochs.pop(0)  # the first tick: the map's first update
        est.online_tick(tk.patch, tk.center, tk.poses, tk.n_poses, radius=traffic["radius_m"])
    else:
        make = circ_epoch_inputs if circular else epoch_inputs
        epochs = make(traffic, cells, res, args.seed, range(args.warmup + args.epochs))

    def batch(ep):
        if ticking:
            out = est.online_tick(ep.patch, ep.center, ep.poses, ep.n_poses,
                                  radius=traffic["radius_m"])
        elif circular:
            out = est.check_circular_paths_batch(ep.poses, ep.n_poses, traffic["radius_m"])
        else:
            out = est.check_polygonal_paths_batch(ep.positions, ep.quaternions, ep.n_poses,
                                                  rect, traffic["conservative"])
        return [o.cpu() for o in out]

    prof = cProfile.Profile()
    plain, profiled = [], []
    for i, ep in enumerate(epochs):
        if not ticking:
            est.update(ep.elevation)
        for walls, on in ((plain, False), (profiled, True)):
            if circular and on:
                est.update(ep.elevation)  # a new map epoch: the field is built again
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
    span = CELLS[args.cell]
    out = {
        "cell": args.cell, "device": card, "epochs": args.epochs,
        "paths": traffic["paths"], "poses": traffic["poses"], "map_cells": cells,
        f"{span}_ms_p50": statistics.median(plain),
        f"{span}_ms_p50_profiled": statistics.median(profiled),
        "dispatch": est.last_polygonal_dispatch if args.cell == "poly_paths_336" else None,
        "functions": _rows(pstats.Stats(prof), args.epochs, args.top),
    }
    print(f"host profile of {args.cell}'s {span} ({traffic['paths']} x "
          f"{traffic['poses']}, {cells}^2), {args.epochs} epochs on {card}: wall p50 "
          f"{out[f'{span}_ms_p50']:.3f} ms, {out[f'{span}_ms_p50_profiled']:.3f} ms "
          f"profiled" + (f"; {out['dispatch']}" if out["dispatch"] else ""))
    print(f"{'cum ms':>9} {'own ms':>9} {'calls':>7}  function (per epoch)")
    for r in out["functions"]:
        print(f"{r['cum_ms']:9.3f} {r['own_ms']:9.3f} {r['calls']:7.1f}  {r['function']}")
    if args.json:
        Path(args.json).write_text(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
