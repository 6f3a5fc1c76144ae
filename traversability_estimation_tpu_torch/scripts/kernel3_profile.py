"""Kernel 3 (``csrc/poly_paths.cu``, the grouped polygonal evaluator) alone
on the card: its device time, launch geometry, ptxas report, work counts and,
where the tree has the stage-timing instantiation, the share of each stage,
at ``chip_smoke.py``'s batches: phase 5's 1024 x 50 paths on the 336^2 map
(identity, random yaw, conservative random yaw) and phase 6's served-size 8
x 10 paths across the 2048^2 map. Each batch is first held to the plain
version on the card (is_safe, each ring's fail and cell count exact).

One tree, one process (``--root``: the tree whose package is imported, by
default the one holding this file):

    python traversability_estimation_tpu_torch/scripts/kernel3_profile.py [--root DIR] [--json F]

Parent against change on one card, each run its own process, in the order
parent, change, change, parent per round:

    python traversability_estimation_tpu_torch/scripts/kernel3_profile.py --parent DIR
        --out-dir D [--rounds 2]

Needs a CUDA device (exits 1 without one).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve()
ROOT = HERE.parents[2]
RES = 0.03
P, N = 1024, 50  # chip_smoke.py phase 5
SERVED_P, SERVED_N = 8, 10  # chip_smoke.py phase 6
BATCHES = ("identity 1024x50", "random yaw 1024x50", "conservative random yaw 1024x50",
           "served 8x10 on 2048^2")


def synthetic_terrain(rows, cols, seed):
    """chip_smoke.py's terrain (bench.py's): slopes, a step edge, noise, holes."""
    rng = np.random.default_rng(seed)
    x = np.arange(rows)[:, None] * RES
    y = np.arange(cols)[None, :] * RES
    z = (0.15 * np.sin(2.0 * x) * np.cos(1.5 * y) + 0.012 * rng.standard_normal((rows, cols))
         + 0.3 * ((x > x.mean()) & (y > y.mean())) + 0.05 * x)
    z[rng.random((rows, cols)) < 0.01] = np.nan
    return z.astype(np.float32)


def quats_of(yaw):
    q = np.zeros(yaw.shape + (4,), np.float32)
    q[..., 2] = np.sin(yaw / 2)
    q[..., 3] = np.cos(yaw / 2)
    return q


def phase5_paths():
    """chip_smoke.py's 1024 x 50 random walks and per-pose yaws (rng 3)."""
    rng = np.random.default_rng(3)
    extent = 336 * RES / 2 * 0.8
    starts = np.stack([rng.uniform(-extent, extent, P), rng.uniform(-extent, extent, P)], -1)
    steps = rng.uniform(-0.06, 0.06, size=(P, N - 1, 2))
    xy = np.concatenate([starts[:, None], starts[:, None] + np.cumsum(steps, 1)], 1)
    pos3 = np.concatenate([xy.astype(np.float32), np.zeros((P, N, 1), np.float32)], -1)
    yaw = rng.uniform(0, 2 * np.pi, (P, N)).astype(np.float32)
    return pos3, quats_of(yaw)


def served_paths():
    """chip_smoke.py phase 6's 8 paths x 10 poses from corner to corner (rng 21)."""
    rng = np.random.default_rng(21)
    ends = (rng.uniform(-24.0, -20.0, (SERVED_P, 2)), rng.uniform(20.0, 24.0, (SERVED_P, 2)))
    t = np.linspace(0.0, 1.0, SERVED_N)[None, :, None]
    xy = ends[0][:, None] + t * (ends[1] - ends[0])[:, None]
    pos3 = np.concatenate([xy, np.zeros((SERVED_P, SERVED_N, 1))], -1).astype(np.float32)
    return pos3, quats_of(rng.uniform(0, 2 * np.pi, (SERVED_P, SERVED_N)))


def span_boundary_batch(P: int = 16, N: int = 12):
    """Identity-yaw paths of a rectangle whose vertices lie exactly on cell
    centres and cell borders, so that the first and last columns (and rows)
    of each ring's span are decided by ties: a 160 x 144 map at 1/32 m
    centred on the origin (cell centres p0 - (g + 1/2) / 32, every
    coordinate exact in float32), a footprint of 20 x 15 cells, poses on
    cell centres (even paths) or cell corners (odd paths), moving by whole
    and half cells along an axis. Returns (resolution, map shape, map
    position, positions (P, N, 3), quaternions (P, N, 4), n_poses (P,),
    footprint (4, 2))."""
    res = 1.0 / 32.0
    shape, position = (160, 144), (0.0, 0.0)
    p0 = np.array([shape[0] * res / 2, shape[1] * res / 2])
    rng = np.random.default_rng(17)
    g = rng.integers(30, 110, (P, 2)).astype(np.float64)
    starts = p0 - (g + np.where(np.arange(P) % 2 == 0, 0.5, 0.0)[:, None]) * res
    axis = rng.integers(0, 2, P)
    steps = rng.choice([-1.0, -0.5, 0.0, 0.5, 1.0], (P, N - 1)) * res
    d = np.zeros((P, N - 1, 2))
    d[np.arange(P), :, axis] = steps
    xy = starts[:, None] + np.concatenate([np.zeros((P, 1, 2)), np.cumsum(d, 1)], 1)
    pos3 = np.concatenate([xy, np.zeros((P, N, 1))], -1).astype(np.float32)
    quats = np.zeros((P, N, 4), np.float32)
    quats[..., 3] = 1.0
    fp = (np.float32([[10.0, 7.5], [10.0, -7.5], [-10.0, -7.5], [-10.0, 7.5]]) * res).astype(
        np.float32)
    return res, shape, position, pos3, quats, np.full((P,), N, np.int32), fp


def run_one(root: Path) -> dict:
    """Every batch on the tree at `root`: one JSON-able dict."""
    sys.path.insert(0, str(root))
    import torch

    import traversability_estimation_tpu_torch as port
    from traversability_estimation_tpu_torch import EstimatorConfig, TraversabilityEstimator
    from traversability_estimation_tpu_torch.kernels import build
    from traversability_estimation_tpu_torch.ops import footprint, poly_kernel
    from traversability_estimation_tpu_torch.utils import roofline

    if not torch.cuda.is_available():
        print("kernel3_profile: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    if Path(port.__file__).resolve().parents[1] != root.resolve():
        raise RuntimeError(f"imported {port.__file__}, not the tree at {root}")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    build.build(["fused_update", "poly_paths"])
    ptxas = [line.strip() for line in build.build_log("poly_paths").splitlines()
             if any(w in line for w in ("entry function", "registers", "spill"))]

    def device_ms(fn, reps):
        """chip_smoke.py's device time per call: the calls queued behind a
        device sleep longer than their issue, timed by CUDA events."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        issue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(4 * issue_s * roofline.SM_CLOCK_MAX_HZ))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    est = TraversabilityEstimator(EstimatorConfig(resolution=RES), device=dev)
    est.update(synthetic_terrain(336, 336, seed=1))
    rect = np.asarray(est.config.footprint.footprint_polygon, np.float32)
    pos3, quats_rot = phase5_paths()
    quats_id = np.zeros_like(quats_rot)
    quats_id[..., 3] = 1.0
    full = np.full((P,), N, np.int32)
    ext = pos3[..., :2].max(axis=1) - pos3[..., :2].min(axis=1)
    gw_id = footprint.path_group_window(rect, ext, RES, True)
    gw_rot = footprint.path_group_window_exact(rect, pos3, quats_rot, RES)
    args = {
        BATCHES[0]: (est.query_state, pos3, quats_id, full, rect, gw_id, False, True),
        BATCHES[1]: (est.query_state, pos3, quats_rot, full, rect, gw_rot, False, False),
        BATCHES[2]: (est.query_state, pos3, quats_rot, full, rect, gw_rot, True, False),
    }
    big = TraversabilityEstimator(EstimatorConfig(resolution=RES), device=dev)
    big.update(synthetic_terrain(2048, 2048, seed=1))
    s_pos, s_quats = served_paths()
    s_n = np.full((SERVED_P,), SERVED_N, np.int32)
    big.check_polygonal_paths_batch(s_pos, s_quats, s_n, rect)
    args[BATCHES[3]] = (big.query_state, s_pos, s_quats, s_n, rect,
                        big.last_polygonal_dispatch["group_window"], False, False)

    out = {"root": str(root), "card": card, "ptxas": ptxas, "batches": {}}
    for name, a in args.items():
        a = (a[0], torch.as_tensor(a[1], device=dev), torch.as_tensor(a[2], device=dev), *a[3:])
        inputs = poly_kernel.kernel_inputs(*a)
        got = poly_kernel.launch(inputs, return_segments=True)
        want = footprint.check_polygonal_paths_grouped(*a, return_segments=True)
        exact = {k: int((got[i] != want[i]).sum()) for k, i in (("safe", 0), ("ring fail", 3),
                                                                 ("ring cells", 4))}
        again = poly_kernel.launch(inputs, return_segments=True)
        identical = all(torch.equal(x, y) for x, y in zip(got, again))
        ms = [device_ms(lambda: poly_kernel.launch(inputs), 50) for _ in range(3)]
        plan = inputs.plan
        row = {
            "window": list(inputs.window), "ms": ms, "ms_median": statistics.median(ms),
            "mismatches": exact, "repeat_bit_identical": identical,
            "cells": int(got[4].sum()), "work": list(poly_kernel.work_counts(inputs)),
            "grid": list(plan.grid), "block": list(plan.block), "smem_bytes": plan.smem_bytes,
            "resident_blocks_per_sm": poly_kernel.occupancy(plan),
        }
        if hasattr(poly_kernel, "stage_cycles"):
            cyc = poly_kernel.stage_cycles(inputs)
            total = sum(cyc) or 1
            row["stage_cycles"] = dict(zip(poly_kernel.STAGES, cyc))
            row["stage_shares"] = {k: c / total for k, c in zip(poly_kernel.STAGES, cyc)}
        out["batches"][name] = row
        runs = ", ".join(f"{m:.4f}" for m in ms)
        print(f"{name} ({card}): {row['ms_median']:.4f} ms (runs {runs}), "
              f"window {row['window']}, grid {row['grid']} x block {row['block']}, smem "
              f"{row['smem_bytes']} B, {row['resident_blocks_per_sm']} blocks/SM; work "
              f"{row['work']}, {row['cells']} cells; mismatches {exact}, two launches "
              f"bit-identical {identical}", flush=True)
        if "stage_shares" in row:
            print("  stages: " + ", ".join(f"{k} {v:.3f}" for k, v in row["stage_shares"].items()),
                  flush=True)
    for line in ptxas:
        print(f"ptxas poly_paths: {line}", flush=True)
    return out


def run_pairs(parent: Path, out_dir: Path, rounds: int) -> dict:
    """Parent and change in turns, each run its own process; per batch the
    device ms of each side's runs."""
    out_dir.mkdir(parents=True, exist_ok=True)
    runs = {"parent": [], "change": []}
    for r in range(rounds):
        for k, (side, root) in enumerate((("parent", parent), ("change", ROOT),
                                          ("change", ROOT), ("parent", parent))):
            path = out_dir / f"round{r}_{k}_{side}.json"
            log = out_dir / f"round{r}_{k}_{side}.log"
            with open(log, "w") as f:
                rc = subprocess.run([sys.executable, str(HERE), "--root", str(root), "--json",
                                     str(path)], stdout=f, stderr=subprocess.STDOUT).returncode
            if rc != 0:
                raise RuntimeError(f"{side} run {r}.{k} exited {rc}: see {log}")
            runs[side].append(json.loads(path.read_text()))
    summary = {"card": runs["change"][0]["card"], "batches": {}}
    for name in BATCHES:
        sides = {s: [m for run in runs[s] for m in run["batches"][name]["ms"]] for s in runs}
        summary["batches"][name] = {s: {"median": statistics.median(v), "min": min(v),
                                        "max": max(v)} for s, v in sides.items()}
        med = {s: summary["batches"][name][s]["median"] for s in runs}
        print(f"{name} ({summary['card']}): parent median {med['parent']:.4f} ms, change "
              f"{med['change']:.4f} ms", flush=True)
    return summary


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT, help="the tree to import the port from")
    ap.add_argument("--parent", type=Path, help="run parent against change (a git archive)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out-dir", type=Path, help="with --parent: each run's JSON and log")
    ap.add_argument("--json", type=Path, help="write the result here")
    a = ap.parse_args(argv)
    if a.parent is not None:
        if a.out_dir is None:
            ap.error("--parent needs --out-dir")
        result = run_pairs(a.parent.resolve(), a.out_dir, a.rounds)
    else:
        result = run_one(a.root.resolve())
    if a.json:
        a.json.write_text(json.dumps(result))


if __name__ == "__main__":
    main()
