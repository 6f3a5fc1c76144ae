"""Parent against change on one card: the benchmark's cells run in pairs,
alternating which side goes first, each run its own process.

For every pair and cell, ``python3 -m bench_torch --cell C --seed S --json F``
runs once in the parent's tree and once in the change's, the parent first in
even pairs and second in odd ones; the seeds take turns over the pairs.
Then, per metric of ``BENCHMARK.json`` and per per-layer number, each side's
median and quartiles over its runs, and the pairs the change won (by the
metric's ``better``; ties count for neither). A gain is claimable when the
change won at least nine tenths of the pairs and the medians differ by more
than the parent's own spread between its quartiles.

Usage, from the change's repository root:
    python -m traversability_estimation_tpu_torch.scripts.ab_pairs --parent DIR
        --out-dir D [--pairs 10] [--cell NAME ...] [--seeds 0 1] [--json F]
``--read`` (no ``--parent``) runs nothing and summarises the whole pairs
already in ``--out-dir``, such as those of a call cut by its time limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the parent's tree (a git archive)")
    ap.add_argument("--read", action="store_true",
                    help="summarise the whole pairs already in --out-dir; run nothing")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--cell", action="append", help="a cell (repeatable); all by default")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--out-dir", required=True, help="each run's JSON line and output")
    ap.add_argument("--json", help="also write the summary to this file")
    return ap


def quartiles(xs: List[float]):
    """(first quartile, median, third quartile), linear between samples."""
    if len(xs) == 1:
        return xs[0], xs[0], xs[0]
    q1, q2, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return q1, q2, q3


def compare(parent: List[float], change: List[float], better: str) -> dict:
    """One number's pairs: each side's quartiles, the change's wins and the
    claim rule."""
    sign = 1.0 if better == "higher" else -1.0
    wins = sum(sign * (c - p) > 0 for p, c in zip(parent, change))
    losses = sum(sign * (c - p) < 0 for p, c in zip(parent, change))
    pq, cq = quartiles(parent), quartiles(change)
    return {
        "parent": parent, "change": change, "better": better,
        "parent_quartiles": pq, "change_quartiles": cq,
        "change_over_parent": cq[1] / pq[1] if pq[1] else None,
        "wins": wins, "losses": losses, "pairs": len(parent),
        "claimable": wins >= 0.9 * len(parent) and abs(cq[1] - pq[1]) > pq[2] - pq[0],
    }


def run(tree: Path, cell: str, seed: int, out: Path) -> dict:
    """One benchmark run of `cell` in `tree`; its last line's workload entry."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "bench_torch", "--cell", cell, "--seed", str(seed),
         "--json", str(out.with_suffix(".json").resolve())],
        cwd=tree, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise SystemExit(f"{tree}: bench_torch --cell {cell} --seed {seed} exited "
                         f"{proc.returncode}; see {out.with_suffix('.log')}")
    entry = load(cell, out)
    entry["process_s"] = time.perf_counter() - t0
    return entry


def load(cell: str, out: Path) -> dict:
    """The workload entry of `cell` in a run's JSON line, with its card."""
    line = json.loads(out.with_suffix(".json").read_text())
    entry = line["workloads"][cell]
    entry["card"] = line["card"]
    return entry


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if not (args.read or args.parent):
        raise SystemExit("ab_pairs: --parent DIR, or --read")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    specs = {w["name"]: w for w in bench["workloads"]}
    trees = {"parent": Path(args.parent or ".").resolve(), "change": ROOT}
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    runs: Dict[str, Dict[str, list]] = {}
    for cell in args.cell or list(specs):
        runs[cell] = {"parent": [], "change": []}
        for i in range(args.pairs):
            seed = args.seeds[i % len(args.seeds)]
            order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
            outs = {side: out_dir / f"{cell}_{i:02d}_{side}" for side in order}
            if args.read and not all(o.with_suffix(".json").exists() for o in outs.values()):
                break
            for side in order:
                entry = load(cell, outs[side]) if args.read else run(
                    trees[side], cell, seed, outs[side])
                runs[cell][side].append(entry)
                print(f"pair {i} seed {seed} {cell} {side}: "
                      f"{json.dumps(entry['metrics'])} [{entry['card']}]", flush=True)

    summary = {"pairs": args.pairs, "seeds": args.seeds, "cells": {}}
    for cell, sides in runs.items():
        if not sides["parent"]:
            continue
        metrics = specs[cell]["metrics"]
        cards = sorted({e["card"] for e in sides["parent"] + sides["change"]})
        rows = {}
        for kind in ("metrics", "per_layer"):
            for name, value in sides["parent"][0][kind].items():
                if not isinstance(value, (int, float)):
                    continue
                # per-layer numbers: times, shares and counts are better
                # lower, a share of the bound higher
                better = metrics[name]["better"] if name in metrics else (
                    "higher" if name.endswith("pct_sol") else "lower")
                rows[name] = compare([e[kind][name] for e in sides["parent"]],
                                     [e[kind][name] for e in sides["change"]], better)
        correct = all(e["correct"] for e in sides["parent"] + sides["change"])
        summary["cells"][cell] = {"cards": cards, "correct": correct, "numbers": rows}
        for name, r in rows.items():
            pq, cq = r["parent_quartiles"], r["change_quartiles"]
            print(f"{cell} {name}: parent {pq[1]!r} ({pq[0]!r} to {pq[2]!r}), change {cq[1]!r} "
                  f"({cq[0]!r} to {cq[2]!r}); change won {r['wins']} of {r['pairs']} pairs, "
                  f"lost {r['losses']}; claimable {r['claimable']} [{', '.join(cards)}]")
        print(f"{cell}: every referee passed: {correct}")
    if args.json:
        Path(args.json).write_text(json.dumps(summary) + "\n")
    print(json.dumps({"cells": {c: {n: {k: r[k] for k in ("wins", "pairs", "claimable")}
                                    for n, r in s["numbers"].items()}
                                for c, s in summary["cells"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
