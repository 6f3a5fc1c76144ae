"""Online update loop, config 4: a persistent map refreshed from submaps
while a planner asks for path batches.

A persistent large map (default 50 m x 50 m at 0.03 m = 1667^2 cells)
receives robot-centric 4 m elevation submaps at a target rate while a planner
issues a batch of footprint paths around the robot every tick. Prints
per-tick latency percentiles and the achieved rate, and writes one JSON row
with ``--json``.

Each tick is one ``TraversabilityEstimator.online_tick`` (recenter + submap
merge + incremental refresh through kernel 1 + the path batch over a field
of kernel 2), queued without a synchronise. The verdicts are fetched in a
pipeline of depth D (``--fetch-depth``): each tick's ``safe`` plane goes by a
``non_blocking`` device-to-host copy into a pinned buffer of a ring of D, an
event is recorded after the copy, and the tick D ticks later waits on that
event and reads the buffer, which it then reuses. Map state is replaced,
never written in place, so a pending verdict tensor stays valid; a buffer is
reused only after its event has completed. ``--dispatch-only`` collects
nothing inside the measured window and drains once at the end.

Usage: python -m traversability_estimation_tpu_torch.scripts.online_loop
       [--map-m 50] [--seconds 10] [--rate 10] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from collections import deque

import numpy as np
import torch


def tick_inputs(tick_no: int, rng: np.random.Generator, src, map_m: float, paths: int):
    """One tick's inputs: the robot on a circle of radius map_m / 4
    (``theta = 0.15 * tick_no``), the 4 m submap the source serves around
    it, and `paths` random 10-pose paths around it drawn from `rng`.
    Returns (patch, (cx, cy), poses (P, 10, 2) f32, n_poses (P,) i32)."""
    theta = 0.15 * tick_no
    cx = map_m / 4 * np.cos(theta)
    cy = map_m / 4 * np.sin(theta)
    patch, _ = src.sample((cx, cy), (4.0, 4.0))
    P, N = paths, 10
    starts = np.stack([cx + rng.uniform(-1.5, 1.5, P), cy + rng.uniform(-1.5, 1.5, P)], -1)
    steps = rng.uniform(-0.1, 0.1, (P, N - 1, 2))
    poses = np.concatenate([starts[:, None], starts[:, None] + np.cumsum(steps, 1)], 1).astype(
        np.float32)
    return patch, (cx, cy), poses, np.full((P,), N, np.int32)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--map-m", type=float, default=50.0)
    ap.add_argument("--res", type=float, default=0.03)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rate", type=float, default=10.0, help="target Hz; 0 = free-run")
    ap.add_argument("--paths", type=int, default=256)
    ap.add_argument(
        "--warmup-ticks", type=int, default=2,
        help="full loop-body ticks run before the measured window (kernel builds and "
        "first-use costs land here, not in the latency percentiles)")
    ap.add_argument(
        "--window-m", type=float, default=0.0,
        help="bounded-memory roaming: keep only a window-m wide map recentred on the robot "
        "each tick (GridMap.recenter); 0 = persistent world map")
    ap.add_argument("--json", default="", help="write a result JSON line here")
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="cuda (default; fails without a card) or cpu (the plain PyTorch versions; "
        "plumbing only, its times are the CPU's)")
    ap.add_argument(
        "--no-pipeline", action="store_true",
        help="fetch each tick's verdicts in the tick (a blocking copy) instead of through "
        "the pinned ring")
    ap.add_argument(
        "--fetch-depth", type=int, default=0,
        help="pipelined-fetch depth D: tick N collects tick N-D's verdicts. 0 = auto (1 "
        "when rate-limited, 3 in free-run)")
    ap.add_argument(
        "--dispatch-only", action="store_true",
        help="never collect verdicts inside the measured window (one drain at the end "
        "keeps the work real): the queueing ceiling of the loop")
    ap.add_argument(
        "--footprint", action="store_true",
        help="polygonal variant: the tick's path batch sweeps the reference footprint "
        "rectangle (grouped hull evaluator) instead of circles")
    ap.add_argument(
        "--no-fused", action="store_true",
        help="run the unfused sequence (recenter, update_with_submap, then the path batch, "
        "each synchronised) instead of online_tick")
    return ap


def main(argv=None, record=None) -> dict:
    """Run the loop; returns the JSON row (also written with ``--json``).
    `record`, when a list, receives (tick number, is_safe as numpy) for every
    tick whose verdicts the loop collected, warm-up ticks included."""
    args = parser().parse_args(argv)

    from traversability_estimation_tpu_torch.device import resolve_device
    from traversability_estimation_tpu_torch.models.estimator import TraversabilityEstimator
    from traversability_estimation_tpu_torch.utils.config import EstimatorConfig
    from traversability_estimation_tpu_torch.utils.profiling import LatencyTracker
    from traversability_estimation_tpu_torch.utils.sources import SyntheticTerrainSource

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    device_name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    res = args.res
    roaming = args.window_m > 0.0
    n = int(round((args.window_m if roaming else args.map_m) / res))
    print(
        f"map {n}x{n} cells ({'bounded window ' + str(args.window_m) if roaming else args.map_m}"
        f" m @ {res} m), device={device_name}",
        file=sys.stderr,
    )

    est = TraversabilityEstimator(EstimatorConfig(resolution=res), device=dev)
    est.set_elevation_map(np.full((n, n), np.nan, np.float32))
    src = SyntheticTerrainSource(resolution=res)

    rng = np.random.default_rng(0)
    update_lat = LatencyTracker()
    query_lat = LatencyTracker()
    free_run = args.rate <= 0.0
    period = 0.0 if free_run else 1.0 / args.rate
    null = contextlib.nullcontext

    fused = not args.no_fused
    if args.footprint and not fused:
        raise SystemExit("--footprint requires the fused tick (drop --no-fused)")
    pipeline = fused and not args.no_pipeline
    if args.dispatch_only and not pipeline:
        raise SystemExit("--dispatch-only requires the pipelined fused tick")
    footprint_poly = (
        np.asarray(est.config.footprint.footprint_polygon, np.float32) if args.footprint else None
    )
    fetch_depth = args.fetch_depth or (3 if free_run else 1)
    # the pinned ring: slot s holds a tick's verdicts from its copy until the
    # tick D later has waited on the copy's event and read them
    ring = [torch.empty((args.paths,), dtype=torch.bool, pin_memory=cuda)
            for _ in range(fetch_depth)]
    free_slots = deque(range(fetch_depth))
    pending = deque()  # (tick, slot, event) or, dispatch-only, (tick, device tensor)
    fetch_bytes = [0]

    def collect(entry):
        if args.dispatch_only:
            tick_no, safe_dev = entry
            safe = safe_dev.cpu().numpy()
        else:
            tick_no, slot, event = entry
            if event is not None:
                event.synchronize()
            safe = ring[slot].numpy().copy()
            free_slots.append(slot)
        if record is not None:
            record.append((tick_no, safe))

    def run_tick(tick_no, measure):
        patch, center, poses, n_poses = tick_inputs(tick_no, rng, src, args.map_m, args.paths)
        if fused:
            kw = {"footprint": footprint_poly} if footprint_poly is not None else {"radius": 0.3}
            with update_lat.timed() if measure else null():
                out = est.online_tick(patch, center, poses, n_poses,
                                      recenter_to=center if roaming else None, **kw)
            if out is None:
                print(f"tick {tick_no}: update failed (patch off-map)", file=sys.stderr)
                return
            safe_dev = out[0]
            fetch_bytes[0] = safe_dev.numel() * safe_dev.element_size()
            if not pipeline:
                with query_lat.timed() if measure else null():
                    safe = safe_dev.cpu().numpy()
                if record is not None:
                    record.append((tick_no, safe))
                return
            if args.dispatch_only:
                pending.append((tick_no, safe_dev))
                return
            with query_lat.timed() if measure else null():
                if len(pending) >= fetch_depth:
                    collect(pending.popleft())
            slot = free_slots.popleft()
            ring[slot].copy_(safe_dev, non_blocking=cuda)
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record()
            pending.append((tick_no, slot, event))
            return
        with update_lat.timed() if measure else null():
            if roaming:
                est.recenter(center)
            est.update_with_submap(patch, center)  # synchronises at its end
        with query_lat.timed() if measure else null():
            safe, _ = est.check_circular_paths_batch(poses, n_poses, 0.3)
            safe = safe.cpu().numpy()
        if record is not None:
            record.append((tick_no, safe))

    # warm-up: the full loop body, unmeasured, until the estimator's
    # high-water marks (the polygonal window, the circular sample count) stop
    # moving, so the measured ticks repeat their shapes
    t0 = time.perf_counter()
    warm = max(args.warmup_ticks, 1)
    for w in range(warm):
        run_tick(w, measure=False)
    prev_marks, stable = None, 0
    for w in range(warm, warm + 12):
        marks = (dict(est._pwindow_hwm), est._max_cells_hwm)
        stable = stable + 1 if marks == prev_marks else 0
        if stable >= 2:
            break
        prev_marks = marks
        run_tick(w, measure=False)
        warm = w + 1
    warmup_s = time.perf_counter() - t0
    print(f"warmup: {warm} ticks, {warmup_s:.1f}s (first uses excluded from the measured "
          "window)", file=sys.stderr)

    # the host-to-device copy of one tick's arguments (patch + poses),
    # blocking, median of 7
    probe_patch, _ = src.sample((0.0, 0.0), (4.0, 4.0))
    probe_poses = np.zeros((args.paths, 10, 2), np.float32)
    upload_bytes = probe_patch.nbytes + probe_poses.nbytes
    ups = []
    for _ in range(7):
        t0u = time.perf_counter()
        torch.as_tensor(probe_patch, device=dev)
        torch.as_tensor(probe_poses, device=dev)
        if cuda:
            torch.cuda.synchronize(dev)
        ups.append(time.perf_counter() - t0u)
    upload_probe_ms = sorted(ups)[len(ups) // 2] * 1e3

    tick = 0
    t_start = time.perf_counter()
    t_end = t_start + args.seconds
    while time.perf_counter() < t_end:
        t_tick = time.perf_counter()
        run_tick(warm + tick, measure=True)
        tick += 1
        sleep = period - (time.perf_counter() - t_tick)
        if sleep > 0:
            time.sleep(sleep)
    # drain the pipelined tail so every queued tick's verdicts are real
    drain_t0 = time.perf_counter()
    while pending:
        collect(pending.popleft())
    drain_s = time.perf_counter() - drain_t0
    measured_s = time.perf_counter() - t_start

    target_str = "free-run (max Hz)" if free_run else f"target {args.rate} Hz"
    print(f"ticks: {tick} over {measured_s:.1f}s ({target_str}) on {device_name}")
    print("update latency:", update_lat.summary())
    print("query latency: ", query_lat.summary())
    achieved = tick / measured_s
    if free_run:
        print(f"max sustainable rate: {achieved:.1f} Hz")
    else:
        print(f"achieved rate: {achieved:.1f} Hz "
              f"({'OK' if achieved >= 0.95 * args.rate else 'UNDER TARGET'})")
    blob = {
        "kind": "online_loop",
        "device": device_name,
        # fused: update_ms = queueing the tick, query_ms = collecting
        # verdicts; unfused: each section to its synchronise
        "fused": fused,
        "pipelined_fetch": pipeline,
        "fetch_depth": fetch_depth if pipeline else 0,
        "fetch_bytes": fetch_bytes[0],  # the safe plane per tick
        "dispatch_only": bool(args.dispatch_only),
        "drain_s": round(drain_s, 3),  # inside measured_s
        "upload_bytes_per_tick": int(upload_bytes),
        "upload_probe_ms": round(upload_probe_ms, 4),
        "query": "polygonal" if footprint_poly is not None else "circular",
        "mode": "roaming_window" if roaming else "persistent_map",
        "map_cells": [n, n],
        "target_hz": args.rate if not free_run else 0.0,
        "free_run": free_run,
        "achieved_hz": round(achieved, 2),
        "warmup_ticks": warm,
        "warmup_s": round(warmup_s, 1),
        "measured_s": round(measured_s, 1),
        "ticks": tick,
        "update_ms": update_lat.summary(),
        "query_ms": query_lat.summary(),
        "paths_per_tick": args.paths,
    }
    if args.json:
        with open(args.json, "w") as f:
            f.write(json.dumps(blob) + "\n")
    return blob


if __name__ == "__main__":
    main()
