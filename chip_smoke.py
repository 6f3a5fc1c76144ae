#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

Run from the root of the repository: ``python3 chip_smoke.py``. It needs one
CUDA device and the CUDA toolkit (``nvcc``); without a device it exits 1
before printing any result.

Phases (any failure exits non-zero):
1. the card's name and power limit; build both kernels from ``csrc/``;
   each kernel's ptxas report, launch geometry, and resident blocks and
   warps per SM;
2. kernel 1 (fused map update) against its plain torch version on the card:
   the 336^2 terrain and the edge shapes 1x1, 5x400, 337x335 and 100x133
   with 4% NaN holes, with the roughness veto off and on. Bar: every layer
   bit-identical (NaN equal to NaN);
3. kernel 2 (dense circle field) against its plain version on the card:
   radius pairs (0.45, 0.3) and (0.45, 0.0), with and without an in-map
   plane, on the 336^2 map and the edge shapes. Bar: ok and trav
   bit-identical;
4. the main path (config 3): estimator on cuda, update of the 336^2 map at
   0.03 m, 1024 circular paths x 50 poses at radius 0.3, and a few
   FootprintPaths; both kernels must have launched; path verdicts equal to
   the same run on the CPU, traversability within 1e-6 of it. CUDA-event
   times of each stage and of each plain version;
5. a 2048^2 map (> 4M cells: the query-crop path) with one path batch;
   both kernels bit-identical to their plain versions there, and timed;
6. a ``kernels`` JSON line, the card line, and the contract line
   ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

PEAK_F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SM_CLOCK_MAX_HZ = 1.98e9  # H100 SXM boost clock: a sleep of N cycles lasts >= N / this


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def synthetic_terrain(rows, cols, resolution, seed=0, nan_frac=0.01):
    """bench.py's terrain: rolling slopes, a hard step edge, noise, holes."""
    rng = np.random.default_rng(seed)
    x = np.arange(rows)[:, None] * resolution
    y = np.arange(cols)[None, :] * resolution
    z = (
        0.15 * np.sin(2.0 * x) * np.cos(1.5 * y)
        + 0.012 * rng.standard_normal((rows, cols))
        + 0.3 * ((x > x.mean()) & (y > y.mean()))
        + 0.05 * x
    )
    z[rng.random((rows, cols)) < nan_frac] = np.nan
    return z.astype(np.float32)


def make_paths(rng, P, N, extent, step=0.06):
    """bench.py's random-walk paths."""
    starts = np.stack(
        [rng.uniform(-extent, extent, P), rng.uniform(-extent, extent, P)], axis=-1
    )
    steps = rng.uniform(-step, step, size=(P, N - 1, 2))
    poses = np.concatenate(
        [starts[:, None, :], starts[:, None, :] + np.cumsum(steps, axis=1)], axis=1
    ).astype(np.float32)
    return poses


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import traversability_estimation_tpu_torch as port
        from traversability_estimation_tpu_torch import (
            EstimatorConfig,
            FootprintConfig,
            FootprintPath,
            TraversabilityEstimator,
        )
        from traversability_estimation_tpu_torch.kernels import build
        from traversability_estimation_tpu_torch.ops import field_kernel, footprint, update_kernel
    except ImportError as e:
        fail(f"the port is not importable here: {e}")
    # the port under test is the one beside this script, never an installed copy
    if not Path(port.__file__).resolve().is_relative_to(Path(root).resolve()):
        fail(f"the port was imported from {port.__file__}, not from {root}")
    if any(m == "jax" or m.startswith(("jax.", "traversability_estimation_tpu."))
           or m == "traversability_estimation_tpu" for m in sys.modules):
        fail("the port imported jax or the JAX package")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. card, build --------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card_line = card[0] if card else "unknown"
    log(f"card: {card_line}")
    t0 = time.perf_counter()
    seconds = build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s wall "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in seconds.items()) or 'cached'})")
    res = 0.03
    H = W = 336
    cfg = EstimatorConfig(resolution=res)
    k1_plan = update_kernel.launch_plan(update_kernel.kernel_params(cfg.chain, cfg.veto), H, W)
    k1_occ = update_kernel.occupancy(k1_plan)
    k2_plan = field_kernel.device_tables(0.3 + cfg.footprint.circular_footprint_offset, res, H, W,
                                         dev)[0]
    k2_occ = field_kernel.occupancy(k2_plan)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def launch_line(grid, block, smem, occ, warps):
        """A launch's geometry and what one SM holds of it: resident blocks
        (the occupancy query) and resident warps (those blocks' warps, or
        the launch's warps spread over the SMs where it has fewer)."""
        per_block = -(-block[0] * block[1] // 32)
        resident = min(occ * per_block, warps / n_sms)
        return (f"grid {grid} x block {block}, smem {smem} B dynamic, {occ} resident blocks/SM, "
                f"{resident:.1f} resident warps/SM")

    geometry = {
        "fused_update": "layers kernel " + launch_line(
            k1_plan.grid_layers, k1_plan.block_layers, k1_plan.smem_layers, k1_occ[0],
            k1_plan.warps[0]) + "; veto kernel " + launch_line(
            k1_plan.grid_veto, k1_plan.block_veto, k1_plan.smem_veto, k1_occ[1],
            k1_plan.warps[1]),
        "circle_field": launch_line(k2_plan.grid, k2_plan.block, k2_plan.smem_bytes, k2_occ,
                                    k2_plan.warps),
    }
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
        log(f"launch {name} at {H}x{W}: {geometry[name]}")
    if min(*k1_occ, k2_occ) < 1:
        fail(f"a kernel cannot be resident on an SM: {k1_occ}, {k2_occ}")

    def cuda_ms(fn, reps, warmup=2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def device_ms(fn, reps):
        """Device time per call of a kernel wrapper: the calls are queued
        behind a device sleep four times longer than the host takes to issue
        them, so the events time the kernels alone, not the wrapper's host
        cost (which exceeds kernel 2's own time)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        issue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(4 * issue_s * SM_CLOCK_MAX_HZ))
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        issued_s = time.perf_counter() - t0
        end.synchronize()
        if issued_s > 4 * issue_s:
            log(f"note: issuing took {issued_s * 1e3:.2f} ms, longer than the device sleep; "
                "this time includes host gaps")
        return start.elapsed_time(end) / reps

    def same(a, b):
        """Equal, NaN equal to NaN."""
        if a.is_floating_point():
            return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
        return bool(torch.equal(a, b))

    def check_update(got, ref, label):
        """Kernel 1's layers against the plain version's: every layer
        bit-identical. Returns the largest float difference (0)."""
        torch.cuda.synchronize()
        if set(got) != set(ref):
            fail(f"kernel 1 layer set {sorted(got)} != plain {sorted(ref)}")
        err = 0.0
        for k in ref:
            if got[k].dtype != ref[k].dtype or not same(got[k], ref[k]):
                fail(f"kernel 1 {label}: {k} differs from the plain version")
            if ref[k].is_floating_point() and ref[k].numel():
                fin = torch.isfinite(ref[k])
                if bool(fin.any()):
                    err = max(err, float((got[k][fin] - ref[k][fin]).abs().max()))
        return err

    def query_state(elev_np):
        layers = update_kernel.fused_update_plain(
            torch.as_tensor(elev_np, device=dev), cfg.chain, cfg.veto)
        return footprint.QueryState(
            traversability=layers["traversability"],
            traversable_mask=layers["traversable_mask"],
            position=torch.zeros(2, dtype=torch.float32, device=dev), resolution=res,
            default_traversability=0.5,
        )

    def check_field(state, rmax, rmin, im, label):
        """Kernel 2 against the plain field: ok and trav bit-identical.
        Returns the largest trav difference (0)."""
        ok_k, tv_k = field_kernel.dense_circle_field(state, rmax, rmin, im)
        ok_p, tv_p = footprint.dense_circle_field(state, rmax, rmin, im)
        torch.cuda.synchronize()
        if not (torch.equal(ok_k, ok_p) and same(tv_k, tv_p)):
            diff = (tv_k - tv_p).abs().max().item() if tv_p.numel() else 0.0
            fail(f"kernel 2 {label} ({rmax}, {rmin}, in_map={im is not None}) differs "
                 f"(ok equal {torch.equal(ok_k, ok_p)}, trav max diff {diff:g})")
        return float((tv_k - tv_p).abs().max()) if tv_p.numel() else 0.0

    terrain = synthetic_terrain(H, W, res, seed=1)
    shapes = {
        "336x336": terrain,
        "1x1": synthetic_terrain(1, 1, res, seed=6),
        "5x400": synthetic_terrain(5, 400, res, seed=7, nan_frac=0.02),
        "337x335": synthetic_terrain(337, 335, res, seed=8),
        "100x133 4% NaN": synthetic_terrain(100, 133, res, seed=5, nan_frac=0.04),
    }

    # ---- 2. kernel 1 vs plain --------------------------------------------
    k1_err = 0.0
    for label, elev_np in shapes.items():
        elev = torch.as_tensor(elev_np, device=dev)
        for check_roughness in (False, True):
            rcfg = EstimatorConfig(
                resolution=res,
                footprint=FootprintConfig(verify_roughness_footprint=check_roughness),
            )
            got = update_kernel.fused_update(elev, rcfg.chain, rcfg.veto)
            ref = update_kernel.fused_update_plain(elev, rcfg.chain, rcfg.veto)
            k1_err = max(k1_err, check_update(got, ref, f"{label} roughness={check_roughness}"))
        log(f"kernel 1 parity {label}, roughness veto off and on: bit-identical")

    # ---- 3. kernel 2 vs plain --------------------------------------------
    k2_err = 0.0
    for label, elev_np in shapes.items():
        state = query_state(elev_np)
        h, w = state.shape
        in_map = torch.as_tensor(np.random.default_rng(2).random((h, w)) > 0.05, device=dev)
        for rmax, rmin in ((0.45, 0.3), (0.45, 0.0)):
            for im in (None, in_map):
                k2_err = max(k2_err, check_field(state, rmax, rmin, im, label))
        log(f"kernel 2 parity {label}, radii (0.45, 0.3) and (0.45, 0.0), in_map absent and "
            "present: bit-identical")

    # ---- 4. main path, config 3 ------------------------------------------
    P, N, radius = 1024, 50, 0.3
    poses = make_paths(np.random.default_rng(3), P, N, H * res / 2 * 0.8)
    n_poses = np.full((P,), N, np.int32)
    few = [
        FootprintPath(poses=poses[0, :1], radius=radius),
        FootprintPath(poses=poses[1], radius=radius),
        FootprintPath(poses=poses[2, :7], radius=0.2),
        FootprintPath(poses=np.zeros((0, 2), np.float32), radius=radius),
    ]
    est = TraversabilityEstimator(EstimatorConfig(resolution=res))
    update_kernel.fused_update.launches = 0
    field_kernel.dense_circle_field.launches = 0
    est.update(terrain)
    safe, trav = est.check_circular_paths_batch(poses, n_poses, radius)
    few_res = est.check_footprint_path(few)
    torch.cuda.synchronize()
    launches = {
        "fused_update": update_kernel.fused_update.launches,
        "circle_field": field_kernel.dense_circle_field.launches,
    }
    log(f"main path launches: {launches}")
    if min(launches.values()) < 1:
        fail(f"a kernel of the main path did not launch: {launches}")

    cpu = TraversabilityEstimator(EstimatorConfig(resolution=res), device="cpu")
    cpu.update(terrain)
    safe_c, trav_c = cpu.check_circular_paths_batch(poses, n_poses, radius)
    few_c = cpu.check_footprint_path(few)
    if safe.shape != (P,) or trav.shape != (P,) or not bool(torch.isfinite(trav).all()):
        fail("path batch output has the wrong shape or non-finite values")
    if not torch.equal(safe.cpu(), safe_c):
        fail(f"is_safe differs from the CPU run on {(safe.cpu() != safe_c).sum().item()} paths")
    path_err = float((trav.cpu() - trav_c).abs().max())
    tmap = est.traversability_map["traversability"].cpu()
    tmap_c = cpu.traversability_map["traversability"]
    if not torch.equal(torch.isfinite(tmap), torch.isfinite(tmap_c)):
        fail("traversability finite pattern differs from the CPU run")
    fin = torch.isfinite(tmap_c)
    map_err = float((tmap[fin] - tmap_c[fin]).abs().max())
    if map_err > 1e-6:
        fail(f"traversability differs from the CPU run by {map_err:g}")
    for a, b in zip(few_res, few_c):
        if a.is_safe != b.is_safe or abs(a.traversability - b.traversability) > 1e-6:
            fail(f"check_footprint_path differs from the CPU run: {a} vs {b}")
    log(f"main path vs CPU run: is_safe equal on {P} paths ({int(safe.sum())} safe), "
        f"path trav max diff {path_err:g}, map traversability max diff {map_err:g}, "
        f"check_footprint_path {[(r.is_safe, round(r.traversability, 4)) for r in few_res]}")

    elev_dev = torch.as_tensor(terrain, device=dev)
    offset = est.config.footprint.circular_footprint_offset
    qs = est.query_state
    k1_ms = device_ms(lambda: update_kernel.fused_update(elev_dev, cfg.chain, cfg.veto), 100)
    update_ms = cuda_ms(lambda: est.update(), 50)
    k1_plain_ms = cuda_ms(
        lambda: update_kernel.fused_update_plain(elev_dev, cfg.chain, cfg.veto), 5)
    def field_call():
        return field_kernel.dense_circle_field(qs, radius + offset, radius)

    k2_ms = device_ms(field_call, 100)
    k2_call_ms = cuda_ms(field_call, 100)
    k2_plain_ms = cuda_ms(lambda: footprint.dense_circle_field(qs, radius + offset, radius), 3, 1)
    est.check_circular_paths_batch(poses, n_poses, radius)  # field cached for the epoch
    batch_ms = cuda_ms(lambda: est.check_circular_paths_batch(poses, n_poses, radius), 50)
    n_off = len(footprint.field_tables(radius + offset, res)[0])
    log(f"config 3 times ({card_line}): update {update_ms:.4f} ms (kernel {k1_ms:.4f} ms, "
        f"plain {k1_plain_ms:.3f} ms); circle field kernel {k2_ms:.4f} ms, wrapper call "
        f"{k2_call_ms:.4f} ms (plain {k2_plain_ms:.3f} ms, {n_off} offsets); path batch "
        f"{batch_ms:.4f} ms -> {P * N / (batch_ms / 1e3):.4g} pose-checks/s")

    # where one map epoch's time goes: update -> field -> path batch, traced
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def epoch():
        est.update(terrain)
        est.check_circular_paths_batch(poses, n_poses, radius)

    epoch()
    torch.cuda.synchronize()
    n_epochs = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_epochs):
            epoch()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_epochs
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    if by_name:
        busy_ms = sum(us for _, us in by_name.values()) / 1e3 / n_epochs
        launches_per_epoch = sum(n for n, _ in by_name.values()) / n_epochs
        log(f"epoch trace ({card_line}): wall {wall_ms:.4f} ms, device busy {busy_ms:.4f} ms, "
            f"idle share {1 - busy_ms / wall_ms:.4f}, {launches_per_epoch:.0f} kernels per epoch")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
        for name, (n, us) in top:
            log(f"  {us / 1e3 / n_epochs:.4f} ms/epoch  x{n // n_epochs:<4d} {name[:90]}")
    else:
        log(f"epoch trace: wall {wall_ms:.4f} ms; device time not measured "
            "(no CUDA events traced)")

    # ---- 5. large map: the query-crop path --------------------------------
    HL = 2048
    big = synthetic_terrain(HL, HL, res, seed=1)
    big_poses = make_paths(np.random.default_rng(4), P, N, HL * res / 2 * 0.8)
    est_big = TraversabilityEstimator(EstimatorConfig(resolution=res))
    update_kernel.fused_update.launches = 0
    field_kernel.dense_circle_field.launches = 0
    t0 = time.perf_counter()
    est_big.update(big)
    safe_b, trav_b = est_big.check_circular_paths_batch(big_poses, n_poses, radius)
    torch.cuda.synchronize()
    big_wall = (time.perf_counter() - t0) * 1e3
    big_launches = {
        "fused_update": update_kernel.fused_update.launches,
        "circle_field": field_kernel.dense_circle_field.launches,
    }
    if min(big_launches.values()) < 1:
        fail(f"a kernel of the large-map path did not launch: {big_launches}")
    if not bool(torch.isfinite(trav_b).all()):
        fail("large-map path batch gave non-finite values")
    big_elev = torch.as_tensor(big, device=dev)
    ref_big = update_kernel.fused_update_plain(big_elev, cfg.chain, cfg.veto)
    if not torch.equal(ref_big["traversable_mask"], est_big.query_state.traversable_mask):
        fail("large-map traversable_mask differs from the plain version")
    check_update(update_kernel.fused_update(big_elev, cfg.chain, cfg.veto), ref_big, "2048x2048")
    del ref_big
    big_qs = est_big.query_state
    check_field(big_qs, radius + offset, radius, None, "2048x2048")
    big_k1_ms = device_ms(lambda: update_kernel.fused_update(big_elev, cfg.chain, cfg.veto), 20)
    big_k2_ms = device_ms(
        lambda: field_kernel.dense_circle_field(big_qs, radius + offset, radius), 20)
    big_batch_ms = cuda_ms(
        lambda: est_big.check_circular_paths_batch(big_poses, n_poses, radius), 20)
    log(f"large map {HL}x{HL} ({card_line}): launches {big_launches}, both kernels "
        f"bit-identical to their plain versions; first update + batch {big_wall:.1f} ms wall, "
        f"kernel 1 {big_k1_ms:.4f} ms, kernel 2 (whole map) {big_k2_ms:.4f} ms, path batch "
        f"(crop, field cached) {big_batch_ms:.4f} ms, {int(safe_b.sum())} of {P} safe")

    # ---- 6. report --------------------------------------------------------
    def bound(nbytes, ops):
        t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32_FLOPS
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")

    b1, by1 = bound(update_kernel.kernel_bytes(cfg.chain, cfg.veto, H, W),
                    update_kernel.kernel_operations(cfg.chain, cfg.veto, H, W))
    b2, by2 = bound(field_kernel.kernel_bytes(H, W), field_kernel.kernel_operations(n_off, H, W))
    kernels = [
        {"name": "fused_update", "route": "cuda",
         "source": "traversability_estimation_tpu_torch/csrc/fused_update.cu",
         "replaces": "traversability_estimation_tpu/ops/pallas_chain.py:117",
         "launches": launches["fused_update"], "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain_ms, "bound_ms": b1, "bound_by": by1, "library_ms": None},
        {"name": "dense_circle_field", "route": "cuda",
         "source": "traversability_estimation_tpu_torch/csrc/circle_field.cu",
         "replaces": "traversability_estimation_tpu/ops/pallas_field.py:125",
         "launches": launches["circle_field"], "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": b2, "bound_by": by2, "library_ms": None},
    ]
    log(json.dumps({"kernels": kernels}))
    log(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
