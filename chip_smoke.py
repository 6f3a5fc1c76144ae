#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

Run from the root of the repository: ``python3 chip_smoke.py``. It needs one
CUDA device and the CUDA toolkit (``nvcc``); without a device it exits 1
before printing any result.

Phases (any failure exits non-zero):
1. the card's name and power limit; build the four kernels from ``csrc/``;
   each kernel's ptxas report, launch geometry, and resident blocks and
   warps per SM;
2. kernel 1 (fused map update) against its plain torch version on the card:
   the 336^2 terrain and the edge shapes 1x1, 5x400, 337x335 and 100x133
   with 4% NaN holes, with the roughness veto off and on. Bar: every layer
   bit-identical (NaN equal to NaN). Then the same shapes under four fusion
   expressions, which kernel 1 interprets per cell: the reference's
   ``(1.0 / 3.0) * (slope + step + roughness)``, a two-layer mean with
   roughness off, one of min, max, sqrt, ``^ 2`` and unary minus (bar:
   every layer bit-identical), and one of exp, sin and a general power (bar:
   the fused layer within 2 float32 steps, every other layer bit-identical);
3. kernel 2 (dense circle field) against its plain version on the card:
   radius pairs (0.45, 0.3) and (0.45, 0.0), with and without an in-map
   plane, on the 336^2 map and the edge shapes. Bar: ok and trav
   bit-identical;
4. the main path (config 3): estimator on cuda, update of the 336^2 map at
   0.03 m, 1024 circular paths x 50 poses at radius 0.3, and a few
   FootprintPaths; kernels 1, 2 and 4 must have launched; path verdicts equal to
   the same run on the CPU, traversability within 1e-6 of it. CUDA-event
   times of each stage and of each plain version;
5. the polygonal path (config 3 again): update, then the 1024 x 50 paths
   swept by the 0.9 x 0.6 m footprint polygon through
   ``check_polygonal_paths_batch`` with identity quaternions, the same with
   the conservative sweep, and with a random yaw per pose; a non-convex L
   footprint on 128 of the paths (the per-segment evaluator); a few
   polygonal FootprintPaths; both dense footprint services. The three
   kernels must have launched (kernel 2 through
   ``traversability_footprint_circle``, kernel 3 for the grouped batches).
   Bars against the same run on the CPU: is_safe and the dispatch statistics
   equal, area within rtol 1e-5, traversability within 2e-5, dense layers'
   ok equal and scores within 1e-5; the dispatch's window plan
   (``path_window_plan``) on the card equal to the NumPy planners' integers
   for the identity and the random-yaw batch. CUDA-event times of each batch.
   5b. kernel 3 (the grouped polygonal evaluator, ``csrc/poly_paths.cu``)
   against its plain version on the card: the 1024 x 50 batches with
   identity quaternions, a random yaw, and conservative with a random yaw;
   1024 straight 6.4 m paths whose per-path window exceeds the grouped cap
   (the block tier); ragged pose counts, 16 of them 1; paths wholly and
   partly off the map; a map of only unknown cells; a convex octagon,
   conservative (32 hull points), with its slots in shared memory and,
   forced, in the global scratch (so too the block tier); a convex 700-gon
   (1,400 ring points, past the shared memory: global slots by itself); the
   span-boundary batch (a rectangle's vertices exactly on cell centres and
   borders of a 1/32 m map: ties decide each ring's first and last
   columns); 8 of the random-yaw paths (too few to fill the card: each path
   a cluster of blocks). Bars: one launch per batch; a second launch gives
   the same bits; is_safe, each ring's fail and cell count equal; each
   ring's cell sum within rtol 1e-5 (plus 1e-7 a cell) and its
   area weight within 1e-5 of the larger of the weight and the footprint's
   area; traversability within 2e-5 and area within rtol 1e-5, each scaled
   by the path's sum|w| / |sum w| over its segments' area weights w (1
   where no weight is negative; the conservative sweep's are of mixed sign,
   and so is the weight of a hull that the collinearity band collapses, as
   on a path heading along a footprint edge). CUDA-event times of kernel 3,
   of its wrapper call and of the plain version at 1024 x 50, with the
   bound from the work the kernel counts (hull point tests, searches,
   straddle tests over each ring's own columns); the share of each stage
   (the stage-timing instantiation), registers and resident blocks beside
   the first design's, recorded in PERF.md;
6. a 2048^2 map (> 4M cells: the query-crop path) with one path batch;
   both kernels bit-identical to their plain versions there, and timed; a
   served-size polygonal batch there (8 paths x 10 poses across the map, a
   window of millions of cells): kernel 3 against its plain version, and
   the times of the kernel, the batch and the plain version, the stage
   shares beside the first design's;
7. the online loop (config 4): a 50 m x 50 m map at 0.03 m (1667 x 1667
   cells, all unknown at first), the robot on a circle of radius 12.5 m, a
   4 m x 4 m submap (133 x 133 cells) and 256 paths x 10 poses per tick
   through ``online_tick``. 60 circular ticks (radius 0.3): tick 0 is the
   unfused first update of the whole map, every later tick must launch
   kernel 1 (on the 189 x 189 crop) and kernel 2 (on the query crop) once.
   Bars: the first 6 ticks equal to the same ticks on the CPU (is_safe equal,
   traversability within 1e-6, elevation and every veto plane exact); the
   incrementally kept map after tick 59 bit-identical, in every layer, to one
   full update of the merged elevation on the card; the map state
   bit-identical to the unfused sequence (update_with_submap + path batch)
   on a second estimator, whose verdicts agree on at least 98% of a tick's
   paths, every other path having a pose within 1e-3 cell of a cell border
   (the query crop's float32 origin may round such a pose into the other
   cell than the map's own origin does). Then 10 polygonal ticks
   (the 0.9 x 0.6 m footprint) and 10 roaming ticks (a 20 m window = 667 x
   667 cells recentred on the robot), on a circle of 5 m that crosses a
   plateau edge of the terrain (verdicts of both kinds), each held the same
   way to the unfused sequence and, for 3 ticks, to the CPU. Kernel 4 launches
   once per circular or roaming tick. Times per tick, of both kernels at
   the tick's shapes, and of the tick's copies.
   7g. kernel 4 (the circular path batch, ``csrc/circ_paths.cu``) against
   its plain version (``check_circular_paths_plain``) on the same CUDA
   tensors: phase 4's 1024 x 50 batch on config 3's map and the last
   tick's 256 x 10 on the query crop it answered on, each with every
   segment walked whole (as the estimator runs them on the card) and at
   the estimator's cap; the 1024 x 50 batch with a quarter of its paths of
   one pose (kernel 4's spiral walk); three edge batches on config 3's map
   (pose counts 0, 1, 2, N and N + 1, paths off the map and on both
   borders, ~1 m segments cut at 8 cells, zero-length paths and segments;
   a default traversability of 0.5 and of 0; a batch of single poses);
   and 64 paths of 800 poses, whose block's poses take two stages of
   shared memory. Bars: one launch a call and no ``check_circles`` on the card,
   is_safe equal, traversability within 1e-6 (a single-pose path's bit for
   bit), a second launch bit-identical, verdicts of both kinds over the
   batches (the tick's are all safe: config 4's circle meets no plateau).
   CUDA-event times of kernel 4 and of the plain version on each batch;
   at the whole 1024 x 50 batch the wrapper call's (device tensors, and
   host arrays through their uploads), an empty kernel's at kernel 4's
   geometry (the launch floor) and the bound from the work this batch
   needs (``circ_kernel.work_counts``). Over the whole run
   ``check_circles`` must not have run on the card outside the referees;
8. the serving path, as a user starts it: a ``TraversabilityNode`` on the
   card under the reference-format configuration (its fusion expression runs
   inside kernel 1) behind a ``TraversabilityServer`` on 127.0.0.1, driven by
   a ``TraversabilityClient`` over the socket. Node A keeps config 4's
   persistent 1667 x 1667 map with the timer off: 20 x
   (``update_traversability``, then ``check_footprint_path`` with 64 circular
   paths x 10 poses and 8 polygonal ones, all asking for their untraversable
   polygon), the first 10 on a 5 m circle that crosses a plateau edge
   (verdicts of both kinds), the last 10 on config 4's 12.5 m circle, with
   ``get_traversability`` of a 4 m submap with two layers after the sixth.
   Node B holds config 3's 336 x 336 map: ``set_elevation_map``,
   ``traversability_footprint``, ``save_traversability_map_to_bag``,
   ``load_elevation_map`` of that bag, ``update_parameters`` (documents that
   change the fusion expression), ``update_traversability``,
   ``check_footprint_path``, ``get_traversability``. Bars: every response
   ok; kernel 1 launched once per update request, kernel 2 once per map
   epoch with circular paths, kernels 3 and 4 once per request's polygonal
   and circular batch; against the same requests to nodes on the CPU
   (node A's first 6 ticks and its submap, every request of node B) is_safe
   and polygons equal, traversability within 1e-6, area within rtol 1e-5,
   step layers and masks exact, float layers within 1e-6; the saved bag
   loads back bit-identical in every float layer. Then node A's timer runs
   at 50 Hz for 2 s while four client threads query it: every response ok,
   no failed tick. Wall times per request kind from the client's side (the
   first polygonal request's among them: the node builds kernel 3 when it
   starts, with kernels 1 and 2);
9. the tiled multi-process path (``parallel/``), on the one card:
   (a) the tile bodies on 2 x 2 and 2 x 4 grids of the 336^2 map and of a
   337 x 335 map with 4% NaN holes, each tile's halo cut from the NaN-padded
   whole map on the host: kernel 1 and kernel 2 launch once per tile, and the
   stitched crops are bit-identical in every layer to one whole-map
   ``fused_update`` and ``dense_circle_field``; kernel 1 with a non-default
   map origin bit-identical to its plain version with the same frame.
   (b) world size 1 over ``nccl`` (``initialize_multihost``), config 4:
   ``sharded_online_tick`` on a 1667 x 1667 map, 133 x 133 submaps, 256
   paths x 10 poses, 10 ticks on the 5 m circle; after each tick the map
   state bit-identical to ``update()`` of the merged elevation and the
   verdicts equal to ``check_circular_paths_plain`` on the same field (the
   per-sample mode is exact: it is the plain version's arithmetic, which
   kernel 4's sums do not repeat bit for bit); a merge start off the map raises. (c) config
   5's tile, a 60 m map at 0.03 m (2000 x 2000): ``scripts/rollouts.py``'s
   100,000 rollouts x 12 poses, ``max_segment_cells`` 16, through
   ``check_circular_paths_tiled`` (the per-path mode), and 4,096 of them
   with its 0.5 x 0.3 m footprint at a random yaw per pose through
   ``check_polygonal_paths_tiled`` in both modes (per polygon, per row);
   verdicts equal to the local evaluators on the same planes, traversability
   within 1e-5, areas within rtol 1e-5. CUDA-event times of every stage and
   of one whole-map update at each size;
10. the roofline and the drivers a user runs: (a) the card's peaks
   (``utils/roofline.measure_peaks``: an FMA chain, a 3-input logic chain
   and a 512 MB copy from ``csrc/peaks.cu``) beside the spec sheet (bar: none
   over 105% of it, which would be a broken measurement), and kernels 1 and
   2 at 336^2, the online crops and 1667^2 against the JAX package's work
   counts priced at them (pct_sol); (b) ``scripts/online_loop.main`` at
   config 4: 3 s free-run circular, 2 s at 10 Hz, 2 s polygonal, 2 s roaming
   in a 20 m window. Bars: each JSON row has the JAX row's keys, kernel 1
   launches once per tick and kernel 2 once per circular tick, every tick's
   verdicts are collected, and the first 3 ticks' verdicts equal
   ``online_tick`` on the same inputs; (c) ``scripts/rollouts.main`` at config
   5's defaults (6667^2, 100,000 x 12) for 3 steps with ``--stages``. Bars:
   kernel 1 and kernel 2 each launch once for the map's first update and
   the start check, then once a step; on step 0's query window the map's
   layers (the 6667^2 first update and step 0's refresh) are bit-identical
   to the plain update on the card inside the window's halo, and the start
   check's whole-map circle field to the plain field inside the circle's
   reach; the start check's 256 verdicts equal ``check_circles`` on the CPU
   over its planes; 1,024 rollouts of step 0 and 1,024 started beside the
   start field's untraversable cell nearest the robot (answered by the
   estimator on the final map), each held to the CPU on the query window it
   was answered on (is_safe equal, traversability within 1e-6), the sample
   holding both verdicts. The native C++ baseline's rate on step 0's sample
   is printed beside (not a bar); (d)
   ``scripts/scaling_bench --sizes 1`` over ``nccl``;
11. a ``kernels`` JSON line (launches summed over phases 4, 5, 7, 8, 9 and
   10; kernel 3 over phases 5, 7, 8, 9 and 10), the card line, and the
   contract line ``{"ok": true, "device": {...}}`` last.

Kernel 4's launches are tallied exactly in every phase that counts
launches: once per ``check_circular_paths`` call on the card (a circular
batch, a tick, a request's circular paths, the rollout script's start
check and steps), never on the tiled path.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

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


# name -> (fusion expression, compute_roughness, float32 steps allowed in the
# fused layer against the plain version)
EXPRESSIONS = {
    "reference": ("(1.0 / 3.0) * (traversability_slope + traversability_step + "
                  "traversability_roughness)", True, 0),
    "two layers": ("0.5*(traversability_slope + traversability_step)", False, 0),
    "min max sqrt ^2 neg": ("max(min(traversability_slope, traversability_step), "
                            "-sqrt(traversability_roughness) + traversability_step ^ 2)", True, 0),
    "exp sin pow": ("exp(-traversability_roughness) * sin(traversability_slope) + "
                    "traversability_step ^ 1.5", True, 2),
}


def online_ticks(source, n_ticks, map_m=50.0, submap_m=4.0, paths=256, n_poses=10, seed=0):
    """The online loop's inputs, tick by tick: the robot drives a circle of
    radius map_m / 4 (``theta = 0.15 * tick``), the source serves a submap
    centred on it, and the planner asks for `paths` random paths around it.
    Returns [(patch, centre, poses (P, N, 2), n_poses (P,)), ...]."""
    rng = np.random.default_rng(seed)
    out = []
    for tick in range(n_ticks):
        theta = 0.15 * tick
        cx, cy = map_m / 4 * np.cos(theta), map_m / 4 * np.sin(theta)
        patch, _ = source.sample((cx, cy), (submap_m, submap_m))
        starts = np.stack(
            [cx + rng.uniform(-1.5, 1.5, paths), cy + rng.uniform(-1.5, 1.5, paths)], -1)
        steps = rng.uniform(-0.1, 0.1, (paths, n_poses - 1, 2))
        poses = np.concatenate(
            [starts[:, None], starts[:, None] + np.cumsum(steps, 1)], 1).astype(np.float32)
        out.append((patch, (cx, cy), poses, np.full((paths,), n_poses, np.int32)))
    return out


def drive_online(est, ticks, kind, fused=True, footprint=None, keep_maps=(), clock=None):
    """Run `ticks` through an estimator: `kind` is "circular" (radius 0.3),
    "polygonal" (`footprint`, identity orientation) or "roaming" (circular,
    the window recentred on the robot each tick); `fused` takes
    ``online_tick``, else the sequence it stands for (recenter +
    update_with_submap + the path batch). Every tick's verdicts are fetched,
    as a planner would. Returns ([(safe, trav) on the host per tick], {tick:
    the traversability map after it, for ticks in `keep_maps`}); `clock`,
    when given, is called as clock(tick, "start" | "queued" | "fetched")."""
    outs, maps = [], {}
    for k, (patch, center, poses, n_poses) in enumerate(ticks):
        kw = {"footprint": footprint} if kind == "polygonal" else {"radius": 0.3}
        recenter_to = center if kind == "roaming" else None
        if clock:
            clock(k, "start")
        if fused:
            out = est.online_tick(patch, center, poses, n_poses, recenter_to=recenter_to, **kw)
        else:
            ok = est.recenter(recenter_to) if recenter_to is not None else True
            ok = est.update_with_submap(patch, center, sync=False) and ok
            if not ok:
                out = None
            elif kind == "polygonal":
                pos3 = np.concatenate([poses, np.zeros(poses.shape[:2] + (1,), np.float32)], -1)
                quats = np.zeros(poses.shape[:2] + (4,), np.float32)
                quats[..., 3] = 1.0
                out = est.check_polygonal_paths_batch(pos3, quats, n_poses, footprint)[:2]
            else:
                out = est.check_circular_paths_batch(poses, n_poses, 0.3)
        if out is None:
            raise RuntimeError(f"online tick {k}: the submap did not land on the map")
        if clock:
            clock(k, "queued")
        safe = out[0].cpu()
        if clock:
            clock(k, "fetched")
        outs.append((safe, out[1].cpu()))
        if k in keep_maps:
            maps[k] = est.traversability_map
    return outs, maps


def serving_phase(card_line, res, terrain, rect, source, zero_counts, counts):
    """Phase 8: the serving path over a real socket, on the card, held to the
    same requests against nodes on the CPU (see the module docstring).
    `zero_counts` / `counts`: the kernels' launch counters. Returns the
    launches of the three kernels over the phase."""
    import torch

    import traversability_estimation_tpu_torch as port
    from traversability_estimation_tpu_torch.utils.rosbag import load_grid_map_bag

    MAP_M, N_UPDATES, N_CIRCULAR, N_POLYGONAL = 50.0, 20, 64, 8
    N_REFEREED = 6  # node A's ticks the CPU nodes answer too
    cfg = dataclasses.replace(
        port.config_from_documents(**port.reference_documents(), resolution=res),
        min_update_rate=0.0)
    if not cfg.chain.fusion_expression or cfg.use_generic_chain:
        fail("the reference documents must configure the canonical chain with its expression")
    # the planner's requests: 10 ticks on a 5 m circle (it crosses a plateau
    # edge of the source), then 10 on config 4's 12.5 m circle
    ticks = (online_ticks(source, N_UPDATES // 2, 20.0, 4.0, N_CIRCULAR + N_POLYGONAL)
             + online_ticks(source, N_UPDATES // 2, MAP_M, 4.0, N_CIRCULAR + N_POLYGONAL, seed=1))
    requests = []
    for _, center, poses, _ in ticks:
        paths = [{"poses": p.tolist(), "radius": 0.3, "compute_untraversable_polygon": True}
                 for p in poses[:N_CIRCULAR]]
        paths += [{"poses": p.tolist(), "footprint": rect.tolist(),
                   "compute_untraversable_polygon": True} for p in poses[N_CIRCULAR:]]
        requests.append((center, paths))
    two_layers = EXPRESSIONS["two layers"][0]
    filters = [dict(f) for f in port.reference_documents()["filters"]]
    filters[4] = {**filters[4], "params": {**filters[4]["params"], "expression": two_layers}}
    b_paths = [{"poses": p.tolist(), "radius": 0.3, "compute_untraversable_polygon": True}
               for p in make_paths(np.random.default_rng(8), 32, 10, 336 * res / 2 * 0.8)]
    walls = {}

    def timed(kind, call, *args, **kw):
        t0 = time.perf_counter()
        resp = call(*args, **kw)
        walls.setdefault(kind, []).append((time.perf_counter() - t0) * 1e3)
        if not resp.get("ok"):
            fail(f"serving path: {kind} answered {resp}")
        return resp

    def drive(device, tmp, n_updates):
        """Nodes A and B on `device` behind their servers, every request over
        the socket, node A's first `n_updates` update and path requests.
        Returns the answers and, per stage, the kernels' launches."""
        pose = {"xy": (0.0, 0.0)}
        node_a = port.TraversabilityNode(
            cfg, source=source, robot_pose=lambda: pose["xy"],
            persistent_map_length=(MAP_M, MAP_M), device=device)
        node_b = port.TraversabilityNode(cfg, device=device)
        out, stages = {"paths": []}, {}
        record = device != "cpu"
        with port.TraversabilityServer(node_a) as srv_a, port.TraversabilityServer(node_b) as srv_b, \
                port.TraversabilityClient(*srv_a.address, timeout=300.0) as cli_a, \
                port.TraversabilityClient(*srv_b.address, timeout=300.0) as cli_b:
            call = timed if record else (lambda kind, fn, *a, **kw: fn(*a, **kw))
            zero_counts()
            for k, (center, paths) in enumerate(requests[:n_updates]):
                pose["xy"] = center
                info = call("update_traversability", cli_a.update_traversability)
                if not info.get("ok") or info["map_info"]["size"] != [1667, 1667]:
                    fail(f"serving path ({device}): update {k} answered {info}")
                out["paths"].append(call(
                    "check_footprint_path (64 circular + 8 polygonal paths x 10 poses)",
                    cli_a.check_footprint_path, paths))
                if k == N_REFEREED - 1:
                    out["submap"] = call(
                        "get_traversability (4 m submap, 2 layers)", cli_a.get_traversability,
                        layers=["traversability", "traversability_step"], position=center,
                        length=(4.0, 4.0))
            stages["node A, updates and paths"] = counts()

            zero_counts()
            out["push"] = call("set_elevation_map (336 x 336)", cli_b.set_elevation_map, terrain)
            out["footprint"] = call("traversability_footprint", cli_b.traversability_footprint)
            bag = os.path.join(tmp, f"{device}.bag")
            call("save_traversability_map_to_bag", cli_b.save_traversability_map_to_bag, bag)
            held = node_b.get_traversability_map()
            saved = load_grid_map_bag(bag).data
            floats = {k for k, v in held.layers.items() if v.dtype != torch.bool}
            if set(saved) != floats:
                fail(f"serving path ({device}): the bag holds {sorted(saved)}, the map's float "
                     f"layers are {sorted(floats)}")
            for k, v in saved.items():
                if not np.array_equal(v, held[k].cpu().numpy(), equal_nan=True):
                    fail(f"serving path ({device}): layer {k} of the saved bag differs")
            out["load"] = call("load_elevation_map (the saved bag)", cli_b.load_elevation_map, bag)
            reloaded = node_b.get_traversability_map()
            for k in ("elevation", "traversability", "traversable_mask", "step_footprint"):
                if not np.array_equal(reloaded[k].cpu().numpy(), held[k].cpu().numpy(),
                                      equal_nan=True):
                    fail(f"serving path ({device}): layer {k} changed across save and load")
            call("update_parameters (documents)", cli_b.update_parameters,
                 documents={"filters": filters})
            if node_b.config.chain.fusion_expression != two_layers:
                fail("serving path: update_parameters did not change the fusion expression")
            call("update_traversability (336 x 336)", cli_b.update_traversability)
            out["b_paths"] = call("check_footprint_path (32 circular paths, 336 x 336)",
                                  cli_b.check_footprint_path, b_paths)
            out["b_map"] = call(
                "get_traversability (336 x 336, 4 layers)", cli_b.get_traversability,
                layers=["traversability", "traversability_step", "traversability_slope",
                        "traversable_mask"])
            stages["node B"] = counts()
            lay = out["b_map"]["data"]
            want = np.float32(0.5) * (lay["traversability_slope"] + lay["traversability_step"])
            if not np.array_equal(lay["traversability"], want, equal_nan=True):
                fail(f"serving path ({device}): the map does not follow the new expression")

            if record:
                # the timer at 50 Hz for 2 s under four querying clients
                zero_counts()
                state = {"tick": 0}

                def roaming_pose():
                    state["tick"] += 1
                    theta = 0.15 * (N_UPDATES // 2 + state["tick"])
                    return MAP_M / 4 * np.cos(theta), MAP_M / 4 * np.sin(theta)

                node_a.robot_pose = roaming_pose
                errors, served = [], []

                def client():
                    try:
                        with port.TraversabilityClient(*srv_a.address, timeout=60.0) as cli:
                            n = 0
                            while time.perf_counter() < t_end:
                                resp = cli.check_footprint_path(requests[-1][1])
                                if not resp.get("ok") or len(resp["results"]) != len(requests[-1][1]):
                                    errors.append(str(resp)[:200])
                                n += 1
                            served.append(n)
                    except Exception as e:  # noqa: BLE001 - reported by the main thread
                        errors.append(repr(e))

                node_a.start()
                base = node_a.update_count
                call("update_parameters (documents)", cli_a.update_parameters,
                     documents={"robot": {"min_update_rate": 50.0}})
                t_start = time.perf_counter()
                t_end = t_start + 2.0
                threads = [threading.Thread(target=client, daemon=True) for _ in range(4)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=120.0)
                elapsed = time.perf_counter() - t_start
                n_ticks = node_a.update_count - base
                call("update_parameters (documents)", cli_a.update_parameters,
                     documents={"robot": {"min_update_rate": 0.0}})
                node_a.stop()
                n_all = node_a.update_count - base  # with the ticks that ran while stopping
                torch.cuda.synchronize()
                stages["node A, timer on"] = counts()
                if any(t.is_alive() for t in threads) or node_a._timer is not None:
                    fail("serving path: a client thread or the timer did not stop")
                if errors or len(served) != 4 or node_a.total_failures:
                    fail(f"serving path under load: errors {errors[:2]}, served {served}, "
                         f"{node_a.total_failures} failed ticks")
                if stages["node A, timer on"]["fused_update"] != n_all or n_ticks < 10:
                    fail(f"serving path under load: {n_ticks} ticks, launches "
                         f"{stages['node A, timer on']}")
                log(f"serving path under load ({card_line}): timer at 50 Hz for {elapsed:.2f} s "
                    f"with 4 client threads: {n_ticks} ticks = {n_ticks / elapsed:.1f} Hz, "
                    f"{sum(served)} check_footprint_path requests of 72 paths answered "
                    f"({sum(served) / elapsed:.1f} /s), launches {stages['node A, timer on']}")
        return out, stages

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        got, stages = drive("cuda", tmp, N_UPDATES)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want, _ = drive("cpu", tmp, N_REFEREED)
        cpu_s = time.perf_counter() - t0

    a_counts = stages["node A, updates and paths"]
    if a_counts != {"fused_update": N_UPDATES, "circle_field": N_UPDATES,
                    "poly_paths": N_UPDATES, "circ_paths": N_UPDATES}:
        fail(f"serving path: kernel 1 must launch once per update request, kernel 2 once "
             f"per map epoch and kernels 3 and 4 once per request's polygonal and circular "
             f"batch: {a_counts} over {N_UPDATES} updates")
    # node B: the pushed map, the loaded bag and the update after the reload;
    # one circle field for the path request
    if stages["node B"] != {"fused_update": 3, "circle_field": 1, "poly_paths": 0,
                            "circ_paths": 1}:
        fail(f"serving path: node B launched {stages['node B']}, expected 3 updates, 1 field "
             "and 1 circular batch")

    def compare_paths(got_resp, want_resp, label):
        err, n_safe, n_poly = 0.0, 0, 0
        for g, w in zip(got_resp["results"], want_resp["results"], strict=True):
            if g["is_safe"] != w["is_safe"]:
                fail(f"serving path {label}: is_safe differs from the CPU node")
            if g.get("untraversable_polygon") != w.get("untraversable_polygon"):
                fail(f"serving path {label}: an untraversable polygon differs from the CPU node")
            if abs(g["area"] - w["area"]) > 1e-5 * abs(w["area"]) + 1e-6:
                fail(f"serving path {label}: area {g['area']} vs {w['area']}")
            err = max(err, abs(g["traversability"] - w["traversability"]))
            n_safe += g["is_safe"]
            n_poly += "untraversable_polygon" in g
        if err > 1e-6:
            fail(f"serving path {label}: traversability differs from the CPU node by {err:g}")
        return err, n_safe, n_poly

    def compare_planes(got_resp, want_resp, label):
        if got_resp["map_info"] != want_resp["map_info"]:
            fail(f"serving path {label}: map info {got_resp['map_info']} vs {want_resp['map_info']}")
        worst = 0.0
        for k, w in want_resp["data"].items():
            g = got_resp["data"][k]
            if k in ("traversability_step", "traversable_mask"):
                if not np.array_equal(g, w, equal_nan=True):
                    fail(f"serving path {label}: layer {k} differs from the CPU node")
            else:
                if not np.array_equal(np.isnan(g), np.isnan(w)):
                    fail(f"serving path {label}: layer {k} has NaN in other cells")
                worst = max(worst, float(np.nanmax(np.abs(g - w))) if np.isfinite(w).any() else 0.0)
        if worst > 1e-6:
            fail(f"serving path {label}: a float layer differs from the CPU node by {worst:g}")
        return worst

    err, n_safe, n_poly, n_paths = 0.0, 0, 0, 0
    all_safe = []
    for k, (g, w) in enumerate(zip(got["paths"][:N_REFEREED], want["paths"], strict=True)):
        e, s_k, p_k = compare_paths(g, w, f"tick {k}")
        err, n_safe, n_poly = max(err, e), n_safe + s_k, n_poly + p_k
        n_paths += len(w["results"])
        all_safe.append(s_k)
    if not (0 < n_safe < n_paths and n_poly > 0):
        fail(f"serving path: the verdicts are all alike ({n_safe} of {n_paths} safe, "
             f"{n_poly} polygons)")
    err_b, safe_b, poly_b = compare_paths(got["b_paths"], want["b_paths"], "node B")
    sub_err = compare_planes(got["submap"], want["submap"], "submap")
    map_err = compare_planes(got["b_map"], want["b_map"], "node B map")
    for name in ("push", "footprint", "load"):
        if got[name] != want[name]:
            fail(f"serving path: {name} answered {got[name]}, the CPU node {want[name]}")
    sub_known = int(np.isfinite(got["submap"]["data"]["traversability"]).sum())
    log(f"serving path vs nodes on the CPU ({card_s:.1f} s on the card, {cpu_s:.1f} s on the "
        f"CPU): node A launches {a_counts} over {N_UPDATES} update requests; safe paths per "
        f"tick {all_safe} of {N_CIRCULAR + N_POLYGONAL}; ticks 0-{N_REFEREED - 1}: is_safe "
        f"and {n_poly} untraversable polygons equal on {n_paths} paths ({n_safe} safe), path "
        f"trav max diff {err:g}; submap {got['submap']['map_info']['size']} ({sub_known} known "
        f"cells): step layer exact, traversability max diff {sub_err:g}; node B (336 x 336): "
        f"launches {stages['node B']}, {safe_b} of {len(b_paths)} paths safe, {poly_b} polygons "
        f"equal, trav max diff {err_b:g}, step layer and mask exact, float layers max diff "
        f"{map_err:g}; the saved bag loads back bit-identical")
    for kind, ms in walls.items():
        log(f"serving request ({card_line}): {kind}: {len(ms)} x, wall median "
            f"{np.median(ms):.3f} ms, max {np.max(ms):.3f} ms, first {ms[0]:.3f} ms")
    return {k: sum(st[k] for st in stages.values())
            for k in ("fused_update", "circle_field", "poly_paths", "circ_paths")}


# the kernel-3 phase's batches beyond phase 5's: block-tier paths, convex
# octagon (conservative: 32 hull points), a convex 700-gon (1,400 ring
# points: past the shared memory, its slots in the global scratch)
K3_BLOCK_PATHS, K3_BLOCK_POSES, K3_BLOCK_STEP = 1024, 128, 0.05
K3_OCTAGON_PATHS = 256
K3_MANY_VERTICES, K3_MANY_PATHS, K3_MANY_POSES = 700, 64, 20
K3_FEW_PATHS = 8
# the first design of kernel 3 (one block of 8 warps per path), measured on
# this phase's batches and phase 6's by scripts/kernel3_profile.py on its
# tree with the stage-timing instantiation (PERF.md, PR 11): device ms,
# stage shares (of the summed warp cycles), registers and resident blocks
K3_FIRST_DESIGN = {
    "registers": 119, "blocks_per_sm": 2,
    "identity 1024x50": (0.2134, {
        "transform": 0.064, "hull tests": 0.035, "hull walk": 0.000, "ring area": 0.066,
        "straddle tests": 0.090, "searches": 0.288, "cell sweep": 0.311, "aggregation": 0.095,
        "barrier waits": 0.000, "other": 0.051}),
    "random yaw 1024x50": (0.3595, {
        "transform": 0.036, "hull tests": 0.223, "hull walk": 0.047, "ring area": 0.039,
        "straddle tests": 0.074, "searches": 0.259, "cell sweep": 0.199, "aggregation": 0.097,
        "barrier waits": 0.000, "other": 0.025}),
    "conservative random yaw 1024x50": (0.7635, {
        "transform": 0.017, "hull tests": 0.499, "hull walk": 0.039, "ring area": 0.017,
        "straddle tests": 0.063, "searches": 0.155, "cell sweep": 0.093, "aggregation": 0.106,
        "barrier waits": 0.000, "other": 0.011}),
    "served 8x10": (0.1093, {
        "transform": 0.011, "hull tests": 0.044, "hull walk": 0.010, "ring area": 0.017,
        "straddle tests": 0.144, "searches": 0.158, "cell sweep": 0.210, "aggregation": 0.385,
        "barrier waits": 0.000, "other": 0.021}),
}


def k3_registers() -> int:
    """Registers of kernel 3's production instantiation (its ptxas report)."""
    from traversability_estimation_tpu_torch.kernels import build

    lines = build.build_log("poly_paths").splitlines()
    entry = next(i for i, line in enumerate(lines)
                 if "entry function" in line and "Lb0ELb0ELb0E" in line)
    used = next(line for line in lines[entry:] if "Used" in line and "registers" in line)
    return int(used.split("Used")[1].split("registers")[0])


def k3_profile_line(name, card_line, ms, inputs, first_design):
    """The first design's numbers beside this tree's for one batch: device
    ms, registers, resident blocks and warps per SM, stage shares."""
    from traversability_estimation_tpu_torch.ops import poly_kernel

    cycles = poly_kernel.stage_cycles(inputs)
    shares = {k: c / max(sum(cycles), 1) for k, c in zip(poly_kernel.STAGES, cycles)}
    first_ms, first_shares = first_design
    blocks = poly_kernel.occupancy(inputs.plan)

    def fmt(sh):
        return ", ".join(f"{k} {v:.3f}" for k, v in sh.items())

    log(f"kernel 3 stage profile, {name} ({card_line}): first design (PERF.md) {first_ms:.4f} "
        f"ms, {K3_FIRST_DESIGN['registers']} registers, {K3_FIRST_DESIGN['blocks_per_sm']} "
        f"blocks/SM ({8 * K3_FIRST_DESIGN['blocks_per_sm']} warps), stages {fmt(first_shares)}; "
        f"this kernel {ms:.4f} ms, {k3_registers()} registers, {blocks} blocks/SM "
        f"({8 * blocks} warps), {inputs.plan.grid[0]} blocks ({inputs.plan.cluster} per path), "
        f"stages {fmt(shares)}")


def poly_kernel_phase(card_line, res, est, rect, pos3, quats_id, quats_rot, device_ms, cuda_ms):
    """Phase 5b: kernel 3 against its plain version on the card (see the
    module docstring). Returns {max_abs_err, ms, plain_ms, bound_ms,
    bound_by} at the 1024 x 50 random-yaw batch."""
    import torch

    from traversability_estimation_tpu_torch import EstimatorConfig, TraversabilityEstimator
    from traversability_estimation_tpu_torch.models.estimator import _GROUPED_ELEMS_CAP
    from traversability_estimation_tpu_torch.ops import footprint, poly_kernel
    from traversability_estimation_tpu_torch.scripts.kernel3_profile import span_boundary_batch
    from traversability_estimation_tpu_torch.utils import roofline

    dev = torch.device("cuda")
    qs = est.query_state
    P, N = pos3.shape[:2]
    full = np.full((P,), N, np.int32)

    def windows(b_pos, b_quats, fp, identity, res):
        ext = b_pos[..., :2].max(axis=1) - b_pos[..., :2].min(axis=1)
        group = footprint.path_group_window(fp, ext, res, True) if identity else \
            footprint.path_group_window_exact(fp, b_pos, b_quats, res)
        return group, footprint.path_block_window(fp, b_pos, res, identity)

    def ragged(b_pos, b_quats, n_poses):
        b_pos, b_quats = b_pos.copy(), b_quats.copy()
        for p, n in enumerate(n_poses):
            b_pos[p, n:] = b_pos[p, n - 1]
            b_quats[p, n:] = b_quats[p, n - 1]
        return b_pos, b_quats, n_poses

    rng = np.random.default_rng(11)
    # block tier: straight 6.4 m paths heading along their yaw, many leaving the map
    heading = rng.uniform(0, 2 * np.pi, K3_BLOCK_PATHS)
    k = np.arange(K3_BLOCK_POSES)
    starts = rng.uniform(-3.0, 3.0, (K3_BLOCK_PATHS, 2))
    xy = starts[:, None] + K3_BLOCK_STEP * k[None, :, None] * np.stack(
        [np.cos(heading), np.sin(heading)], -1)[:, None]
    b_pos = np.concatenate([xy, np.zeros(xy.shape[:2] + (1,))], -1).astype(np.float32)
    b_quats = np.zeros(b_pos.shape[:2] + (4,), np.float32)
    b_quats[..., 2] = np.sin(heading / 2)[:, None]
    b_quats[..., 3] = np.cos(heading / 2)[:, None]
    n_rag = rng.integers(1, N + 1, P).astype(np.int32)
    n_rag[:16] = 1
    off = pos3.copy()
    off[: P // 2, :, 0] += 12.0  # wholly off the 10 m map
    off[P // 2 :, :, 0] += 5.0  # partly off
    unknown = TraversabilityEstimator(EstimatorConfig(resolution=res), device=dev)
    unknown.update(np.full(qs.shape, np.nan, np.float32))
    octagon = np.float32([[0.4 * np.cos(a), 0.3 * np.sin(a)] for a in np.arange(8) * np.pi / 4])
    o_p = K3_OCTAGON_PATHS
    v_p, v_n = K3_MANY_PATHS, K3_MANY_POSES
    many = np.float32([[0.45 * np.cos(a), 0.3 * np.sin(a)]
                       for a in np.arange(K3_MANY_VERTICES) * -2 * np.pi / K3_MANY_VERTICES])
    sb_res, sb_shape, sb_position, sb_pos3, sb_quats, sb_n, sb_fp = span_boundary_batch()
    boundary = TraversabilityEstimator(EstimatorConfig(resolution=sb_res), device=dev)
    boundary.update(synthetic_terrain(*sb_shape, sb_res, seed=2), position=sb_position)
    f_p = K3_FEW_PATHS
    # name -> (query state, positions, quaternions, n_poses, footprint, conservative,
    # identity, block tier, shared memory the launch may use)
    smem = poly_kernel.SMEM_LIMIT
    batches = {
        "identity 1024x50": (qs, pos3, quats_id, full, rect, False, True, False, smem),
        "random yaw 1024x50": (qs, pos3, quats_rot, full, rect, False, False, False, smem),
        "conservative random yaw 1024x50": (qs, pos3, quats_rot, full, rect, True, False, False,
                                            smem),
        f"block tier {K3_BLOCK_PATHS}x{K3_BLOCK_POSES}": (
            qs, b_pos, b_quats, np.full((K3_BLOCK_PATHS,), K3_BLOCK_POSES, np.int32), rect,
            False, False, True, smem),
        "ragged n_poses, random yaw": (qs, *ragged(pos3, quats_rot, n_rag), rect, False, False,
                                       False, smem),
        "wholly and partly off the map": (qs, off, quats_id, full, rect, False, True, False,
                                          smem),
        "only unknown cells": (unknown.query_state, pos3, quats_rot, full, rect, False, False,
                               False, smem),
        f"octagon conservative {o_p}x50": (qs, pos3[:o_p], quats_rot[:o_p], full[:o_p], octagon,
                                          True, False, False, smem),
        # the same kernel with its slots in the global scratch: forced here,
        # taken by itself for the many-vertex footprint below
        f"octagon conservative {o_p}x50, global slots": (
            qs, pos3[:o_p], quats_rot[:o_p], full[:o_p], octagon, True, False, False, 0),
        f"block tier {K3_BLOCK_PATHS}x{K3_BLOCK_POSES}, global slots": (
            qs, b_pos, b_quats, np.full((K3_BLOCK_PATHS,), K3_BLOCK_POSES, np.int32), rect,
            False, False, True, 0),
        f"{K3_MANY_VERTICES}-gon identity {v_p}x{v_n}": (
            qs, pos3[:v_p, :v_n], quats_id[:v_p, :v_n], np.full((v_p,), v_n, np.int32), many, False,
            True, False, smem),
        # ties decide each ring's first and last columns (a 1/32 m map)
        "span boundary": (boundary.query_state, sb_pos3, sb_quats, sb_n, sb_fp, False, True,
                          False, smem),
        # too few paths to fill the card: a cluster of blocks per path
        f"{f_p} paths random yaw": (qs, pos3[:f_p], quats_rot[:f_p], full[:f_p], rect, False,
                                    False, False, smem),
    }
    summary = {"max_abs_err": 0.0}
    for name, (state, b_pos, b_quats, n_poses, fp, conservative, identity, blocks, smem_limit) \
            in batches.items():
        group, block = windows(b_pos, b_quats, fp, identity, state.resolution)
        n_paths = b_pos.shape[0]
        if blocks and not (group[0] * group[1] * n_paths > _GROUPED_ELEMS_CAP
                           >= block[0] * block[1] * n_paths):
            fail(f"kernel 3 {name}: windows {group} / {block} are not the block tier's")
        args = (state, torch.as_tensor(b_pos, device=dev), torch.as_tensor(b_quats, device=dev),
                n_poses, fp, group, conservative, identity and not conservative,
                block if blocks else None)
        before = poly_kernel.check_polygonal_paths_grouped.launches
        inputs = poly_kernel.kernel_inputs(*args, smem_limit=smem_limit)
        if smem_limit == poly_kernel.SMEM_LIMIT:
            got = poly_kernel.check_polygonal_paths_grouped(*args, return_segments=True)
        else:
            got = poly_kernel.launch(inputs, return_segments=True)
        torch.cuda.synchronize()
        launched = poly_kernel.check_polygonal_paths_grouped.launches - before
        if launched != 1:
            fail(f"kernel 3 {name}: {launched} launches for one batch")
        again = poly_kernel.launch(inputs, return_segments=True)
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   if a.dtype == torch.float32 else torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"kernel 3 {name}: two launches on the same inputs differ")
        want = footprint.check_polygonal_paths_grouped(*args, return_segments=True)
        slots = "global" if inputs.plan.scratch_words else "shared"
        if name.startswith(f"{f_p} paths") and not inputs.plan.grid[0] > n_paths:
            fail(f"kernel 3 {name}: {inputs.plan.grid[0]} blocks for {n_paths} paths")
        (safe, trav, area, fail_r, cells, sums, w_got), (safe_w, trav_w, area_w, fail_w, cells_w,
                                                         sums_w, weights) = got, want
        if not (torch.equal(safe, safe_w) and torch.equal(fail_r, fail_w)
                and torch.equal(cells, cells_w)):
            fail(f"kernel 3 {name}: is_safe differs on {int((safe != safe_w).sum())} paths, "
                 f"ring fail on {int((fail_r != fail_w).sum())} rings, cell counts on "
                 f"{int((cells != cells_w).sum())} rings")
        # the path's area is the sum of its segments' area weights, which the
        # conservative sweep (the hull less a doubled polygon1) and a hull
        # the collinearity band collapses make of mixed sign: float32
        # rounding of a weight then weighs sum|w| / |sum w| in the
        # traversability and sum|w| in the area. With weights >= 0 the bars
        # are traversability within 2e-5 and area within rtol 1e-5
        n_t = torch.as_tensor(n_poses, device=dev)
        valid = torch.arange(1, b_pos.shape[1], device=dev)[None, :] < n_t[:, None]
        w_seg = torch.where(valid, weights[:, 1:], 0.0)
        single = n_t == 1
        abs_sum = torch.where(single, weights[:, 0].abs(), w_seg.abs().sum(1))
        net = torch.where(single, weights[:, 0].abs(), w_seg.sum(1).abs())
        cond = abs_sum / net.clamp_min(1e-12)
        trav_err = (trav - trav_w).abs()
        area_err = (area - area_w).abs()
        if bool((trav_err > 2e-5 * cond).any()) or bool((area_err > 1e-5 * abs_sum + 1e-6).any()):
            fail(f"kernel 3 {name}: traversability differs by {float(trav_err.max()):g}, area "
                 f"by {float(area_err.max()):g} (sum|w| / |sum w| up to {float(cond.max()):g})")
        # each ring on its own: the sum of its cells (values in [0, 1]) within
        # rtol 1e-5 plus 1e-7 a cell; its area weight within 1e-5 of the
        # larger of the weight and the footprint's area (ring 0's weight):
        # after the first segment a weight is a hull area less polygon1's,
        # two areas near the footprint's whose float32 rounding remains
        sum_err = (sums - sums_w).abs()
        w_err = (w_got - weights).abs()
        if bool((sum_err > 1e-5 * sums_w.abs() + 1e-7 * cells_w).any()) or bool(
                (w_err > 1e-5 * torch.maximum(weights.abs(), weights[:, :1].abs())).any()):
            fail(f"kernel 3 {name}: a ring's cell sum differs by {float(sum_err.max()):g}, its "
                 f"area weight by {float(w_err.max()):g}")
        summary["max_abs_err"] = max(summary["max_abs_err"], float(trav_err.max()))
        if not bool(torch.isfinite(trav).all() & torch.isfinite(area).all()):
            fail(f"kernel 3 {name}: non-finite values")
        log(f"kernel 3 {name}: one launch of {inputs.plan.grid[0]} blocks, {slots} slots, window "
            f"{block if blocks else group}; two launches bit-identical; "
            f"vs the plain version on the card: is_safe equal ({int(safe.sum())} of {n_paths} "
            f"safe), ring fail and cell counts exact ({int(cells.sum())} cells), ring sums max "
            f"diff {float(sum_err.max()):g}, ring weights {float(w_err.max()):g}, trav max diff "
            f"{float(trav_err.max()):g}, area max diff {float(area_err.max()):g} (sum|w| / "
            f"|sum w| up to {float(cond.max()):.4g})")

    for name in ("identity 1024x50", "random yaw 1024x50", "conservative random yaw 1024x50"):
        state, b_pos, b_quats, n_poses, fp, conservative, identity, _, _ = batches[name]
        group, _ = windows(b_pos, b_quats, fp, identity, res)
        args = (state, torch.as_tensor(b_pos, device=dev), torch.as_tensor(b_quats, device=dev),
                n_poses, fp, group, conservative, identity and not conservative)
        inputs = poly_kernel.kernel_inputs(*args)
        ms = device_ms(lambda: poly_kernel.launch(inputs), 50)
        call_ms = cuda_ms(lambda: poly_kernel.check_polygonal_paths_grouped(*args), 20)
        plain_ms = cuda_ms(lambda: footprint.check_polygonal_paths_grouped(*args), 3, 1)
        cells = int(poly_kernel.launch(inputs, True)[4].sum())
        hull_tests, searches, straddles = poly_kernel.work_counts(inputs)
        H, W = state.shape
        gpad = max(group)
        bound_ms, bound_by = roofline.bound(
            poly_kernel.kernel_bytes(P, N, len(fp), (H + 2 * gpad) * (W + 2 * gpad)),
            poly_kernel.kernel_operations(P, N, len(fp), group[0], conservative,
                                          identity and not conservative, cells, hull_tests,
                                          searches, straddles))
        plan = inputs.plan
        log(f"kernel 3 {name} ({card_line}): {ms:.4f} ms device time, bound {bound_ms:.5f} ms "
            f"({bound_by}; {hull_tests} hull point tests, {searches} searches, {straddles} "
            f"straddle tests, {cells} cells); wrapper call {call_ms:.4f} ms; plain version "
            f"{plain_ms:.3f} ms; grid {plan.grid} x block {plan.block}, {plan.cluster} blocks "
            f"per path, smem {plan.smem_bytes} B, {poly_kernel.occupancy(plan)} resident "
            f"blocks/SM")
        k3_profile_line(name, card_line, ms, inputs, K3_FIRST_DESIGN[name])
        if name == "random yaw 1024x50":
            summary.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    return summary


# phase 6's served-size polygonal batch: paths x poses, from one corner of
# the 2048^2 map to the other (a window of millions of cells, a cluster of
# kernel 3's blocks per path)
SERVED_PATHS, SERVED_POSES = 8, 10


def served_polygonal_batch(card_line, res, est, rect, device_ms, cuda_ms):
    """Phase 6's polygonal batch of a served request's size on the 2048^2
    map: dispatched to kernel 3 with a window of millions of cells, held to
    the plain version on the card, and timed (kernel, batch, plain)."""
    import torch

    from traversability_estimation_tpu_torch.ops import footprint, poly_kernel

    rng = np.random.default_rng(21)
    P, N = SERVED_PATHS, SERVED_POSES
    ends = (rng.uniform(-24.0, -20.0, (P, 2)), rng.uniform(20.0, 24.0, (P, 2)))
    t = np.linspace(0.0, 1.0, N)[None, :, None]
    xy = ends[0][:, None] + t * (ends[1] - ends[0])[:, None]
    pos3 = np.concatenate([xy, np.zeros((P, N, 1))], -1).astype(np.float32)
    yaw = rng.uniform(0, 2 * np.pi, (P, N))
    quats = np.zeros((P, N, 4), np.float32)
    quats[..., 2] = np.sin(yaw / 2)
    quats[..., 3] = np.cos(yaw / 2)
    n_poses = np.full((P,), N, np.int32)
    before = poly_kernel.check_polygonal_paths_grouped.launches
    est.check_polygonal_paths_batch(pos3, quats, n_poses, rect)
    torch.cuda.synchronize()
    st = dict(est.last_polygonal_dispatch)
    if (st["evaluator"], st["reason"], st["block_window"]) != ("grouped", "ok", None) or \
            poly_kernel.check_polygonal_paths_grouped.launches != before + 1:
        fail(f"served-size polygonal batch: dispatched as {st}, not one launch of kernel 3")
    gw = st["group_window"]
    args = (est.query_state, pos3, quats, n_poses, rect, gw)
    inputs = poly_kernel.kernel_inputs(*args)
    got = poly_kernel.launch(inputs, return_segments=True)
    want = footprint.check_polygonal_paths_grouped(*args, return_segments=True)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
            and torch.equal(got[4], want[4])):
        fail("served-size polygonal batch: is_safe or a ring's fail or cell count differs from "
             "the plain version")
    ms = device_ms(lambda: poly_kernel.launch(inputs), 20)
    batch_ms = cuda_ms(lambda: est.check_polygonal_paths_batch(pos3, quats, n_poses, rect), 10)
    plain_ms = cuda_ms(lambda: footprint.check_polygonal_paths_grouped(*args), 3, 1)
    log(f"served-size polygonal batch ({card_line}): {P} paths x {N} poses, window {gw} "
        f"({gw[0] * gw[1]} cells), {inputs.plan.grid[0]} blocks; equal to the plain version in "
        f"is_safe and every ring's fail and cell count ({int(got[4].sum())} cells); kernel 3 "
        f"{ms:.4f} ms device time, the batch {batch_ms:.4f} ms, the plain version "
        f"{plain_ms:.3f} ms")
    k3_profile_line(f"served {P}x{N}", card_line, ms, inputs, K3_FIRST_DESIGN["served 8x10"])


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def circ_edge_batch(est, res, default, N, seed, max_cells=None):
    """Kernel 4's edge batch on a query state (map centre at the origin), its
    default traversability replaced by `default`: 64 random-walk paths of
    `N` poses, pose counts 0, 1, 2, N and N + 1 among them, a path wholly
    off the map, one on its near border (row 0) and one on its far border
    (off the map), one of segments of ~1 m (33 cells), one of zero length
    and one whose first segments have zero length. Returns the arguments of
    ``check_circular_paths`` on the estimator's query state: radius 0.3,
    offset 0.15, `max_cells` samples' cells (None: every segment whole, as
    the estimator walks them on the card), the state's field, single-pose
    paths present."""
    import torch

    from traversability_estimation_tpu_torch.ops import field_kernel, footprint

    state = est.query_state
    st = footprint.QueryState(state.traversability, state.traversable_mask, state.position,
                              res, default)
    rng = np.random.default_rng(seed)
    P = 64
    starts = rng.uniform(-1.5, 1.5, (P, 2))
    poses = np.concatenate(
        [starts[:, None], starts[:, None] + np.cumsum(rng.uniform(-0.1, 0.1, (P, N - 1, 2)), 1)],
        1)
    n_poses = rng.integers(0, N + 2, P).astype(np.int32)
    n_poses[:5] = [0, 1, 2, N, N + 1]
    half = state.shape[0] * res / 2
    poses[5] += 3 * half
    poses[6, :, 0] = half
    poses[7, :, 1] = -half
    poses[8] = poses[8, :1] + np.arange(N)[:, None] * np.float32([0.9, -0.4])
    poses[9] = poses[9, :1]
    poses[10, : N // 2] = poses[10, :1]
    poses = poses.astype(np.float32)
    dev = state.traversability.device
    field = field_kernel.dense_circle_field(st, 0.45, 0.3)
    return (st, torch.as_tensor(poses, device=dev), torch.as_tensor(n_poses, device=dev), 0.3,
            0.15, max_cells, field, True)


def circ_kernel_phase(card_line, batches, device_ms, cuda_ms):
    """Phase 7g: kernel 4 (the circular path batch, ``csrc/circ_paths.cu``)
    against its plain version on the card (see the module docstring).
    `batches`: name -> the arguments of ``check_circular_paths``, on the
    card; the first is the main path's 1024 x 50 walked whole, the second
    the tick's 256 x 10 walked whole. `device_ms` / `cuda_ms`: the kernel's
    device time and a call's time per call. Returns kernel 4's numbers for
    the kernels line: the largest difference over the batches; at the first
    batch its time, the plain version's, its bound, the wrapper call's
    (device tensors and host arrays) and the empty launch's; the second
    batch's time."""
    import torch

    from traversability_estimation_tpu_torch.ops import circ_kernel, footprint
    from traversability_estimation_tpu_torch.utils import roofline

    circles = footprint.check_circles.card_calls

    def kernel(args):
        """One call of the dispatch: one launch, no check_circles."""
        before = circ_kernel.check_circular_paths.launches
        out = footprint.check_circular_paths(*args)
        if circ_kernel.check_circular_paths.launches != before + 1:
            fail(f"kernel 4: {circ_kernel.check_circular_paths.launches - before} launches "
                 "for one call")
        if footprint.check_circles.card_calls != circles:
            fail("kernel 4: check_circles ran on the card")
        return out

    def plain(args):
        """The referee: its own check_circles calls are not the path's."""
        out = footprint.check_circular_paths_plain(*args)
        footprint.check_circles.card_calls = circles
        return out

    worst, n_safe_all, n_all, times = 0.0, 0, 0, []
    for name, args in batches.items():
        P, N = args[1].shape[:2]
        got = kernel(args)
        again = kernel(args)
        want = plain(args)
        torch.cuda.synchronize()
        if got[0].shape != (P,) or got[1].shape != (P,) or not got[0].is_cuda \
                or not bool(torch.isfinite(got[1]).all()):
            fail(f"kernel 4 {name}: wrong shape, device or non-finite values")
        if not torch.equal(got[0], want[0]):
            fail(f"kernel 4 {name}: is_safe differs from the plain version on "
                 f"{int((got[0] != want[0]).sum())} of {P} paths")
        err = float((got[1] - want[1]).abs().max())
        if err > 1e-6:
            fail(f"kernel 4 {name}: traversability differs from the plain version by {err:g}")
        one = torch.ones(P, dtype=torch.bool, device=got[1].device) if N == 1 \
            else (args[2] == 1) & bool(args[7])
        n_one = int(one.sum())
        if not torch.equal(got[1][one].view(torch.int32), want[1][one].view(torch.int32)):
            fail(f"kernel 4 {name}: a single-pose path's traversability differs in its bits")
        if not (torch.equal(got[0], again[0])
                and torch.equal(got[1].view(torch.int32), again[1].view(torch.int32))):
            fail(f"kernel 4 {name}: a second launch gave other bits")
        n_safe = int(got[0].sum())
        n_safe_all, n_all = n_safe_all + n_safe, n_all + P
        worst = max(worst, err)
        ms = device_ms(lambda: kernel(args), 100)
        plain_ms = cuda_ms(lambda: plain(args), 20)
        times.append(ms)
        work = circ_kernel.work_counts(*args[:6], args[7])
        bound_ms, bound_by = roofline.bound(circ_kernel.kernel_bytes(P, N, work),
                                            circ_kernel.kernel_operations(P, work))
        cap = "whole segments" if args[5] is None else f"max_segment_cells {args[5]}"
        log(f"kernel 4 {name} ({card_line}): {P} x {N}, {cap}, {n_safe} safe, {n_one} "
            f"single-pose paths bit-identical; against the plain version is_safe equal, trav "
            f"max diff {err:g}, a second launch bit-identical; {ms:.4f} ms a call on the "
            f"device, plain {plain_ms:.4f} ms; bound {bound_ms:.6f} ms ({bound_by}, "
            f"{100 * bound_ms / ms:.2f}%), {work.samples} samples, {work.spiral_cells} spiral "
            f"cells")
    # config 4's circle meets no plateau (the tick's paths are all safe);
    # the other batches hold both verdicts
    if not 0 < n_safe_all < n_all:
        fail(f"kernel 4: the verdicts are all alike ({n_safe_all} of {n_all} safe)")
    name, args = next(iter(batches.items()))
    state, poses, n_poses, m, single = args[0], args[1], args[2], args[5], args[7]
    P, N = poses.shape[:2]
    dev = poses.device
    host_args = (state, poses.cpu().numpy(), n_poses.cpu().numpy()) + tuple(args[3:])
    ms = device_ms(lambda: kernel(args), 100)
    empty_ms = device_ms(lambda: circ_kernel.empty_launch(P, dev), 100)
    call_ms = cuda_ms(lambda: kernel(args), 100)
    host_call_ms = cuda_ms(lambda: kernel(host_args), 100)
    plain_ms = cuda_ms(lambda: plain(args), 20)
    work = circ_kernel.work_counts(state, poses, n_poses, args[3], args[4], m, single)
    nbytes = circ_kernel.kernel_bytes(P, N, work)
    ops = circ_kernel.kernel_operations(P, work)
    bound_ms, bound_by = roofline.bound(nbytes, ops)
    t_args = list(batches.values())[1]
    t_host = (t_args[0], t_args[1].cpu().numpy(), t_args[2].cpu().numpy()) + tuple(t_args[3:])
    tick_call_ms = cuda_ms(lambda: kernel(t_args), 100)
    tick_host_call_ms = cuda_ms(lambda: kernel(t_host), 100)
    log(f"kernel 4 at the tick's 256 x 10 ({card_line}): wrapper call {tick_call_ms:.4f} ms on "
        f"device tensors, {tick_host_call_ms:.4f} ms from host arrays (uploaded)")
    log(f"kernel 4 at {name} ({card_line}): {ms:.4f} ms device time, an empty kernel at its "
        f"geometry {empty_ms:.4f} ms; wrapper call {call_ms:.4f} ms on device tensors, "
        f"{host_call_ms:.4f} ms from host arrays (uploaded); plain {plain_ms:.4f} ms; "
        f"{work}, {nbytes} bytes, {ops} operations: bound {bound_ms:.6f} ms ({bound_by}), "
        f"{100 * bound_ms / ms:.2f}% of it")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "empty_ms": empty_ms, "call_ms": call_ms,
            "host_call_ms": host_call_ms, "tick_ms": times[1],
            "tick_host_call_ms": tick_host_call_ms}


# phase 9's sizes: (b) config 4's map and submaps, 10 ticks on a 5 m circle of
# 256 paths; (c) config 5's 60 m tile at 0.03 m, its rollout batch and a
# polygonal batch
TILED_MAP_M = 50.0
TILED_CIRCLE_M = 20.0
TILED_TICKS = 10
TILED_TICK_PATHS = 256
TILED_TILE_CELLS = 2000
TILED_ROLLOUTS = 100_000
TILED_POLY_PATHS = 4096


def tiled_phase(card_line, res, terrain, cfg, source, zero_counts, counts, timer, kernel_timer,
                trace):
    """Phase 9: the tiled multi-process path (``parallel/``) on the one card
    (see the module docstring). `zero_counts` / `counts`: the kernels' launch
    counters; `timer(fn, reps)`: ms per call, `kernel_timer(fn, reps)`: device
    ms per call of a kernel wrapper, `trace(label, fn, reps, top_n)`: where a
    call's time goes. The sizes are the TILED_* constants. Returns the
    launches of both kernels over the phase's tile bodies, sharded ticks and
    tiled queries (the referees' own launches excluded)."""
    import torch
    import torch.distributed as dist

    from traversability_estimation_tpu_torch import TraversabilityEstimator
    from traversability_estimation_tpu_torch.grid.geometry import global_in_map
    from traversability_estimation_tpu_torch.ops import field_kernel, footprint, update_kernel
    from traversability_estimation_tpu_torch.parallel import multihost
    from traversability_estimation_tpu_torch.parallel import sharding as sh
    from traversability_estimation_tpu_torch.scripts import rollouts

    dev = torch.device("cuda")
    chain, veto = cfg.chain, cfg.veto
    radius, offset = 0.3, cfg.footprint.circular_footprint_offset
    rmax = radius + offset
    halo, fh = sh.required_halo(chain, veto), sh.field_halo(rmax, res)
    launches = {"fused_update": 0, "circle_field": 0, "poly_paths": 0, "circ_paths": 0}

    def tally(want, label):
        got = counts()
        # the tiled path runs no grouped evaluator, and its circular paths
        # are the tiled path's own composition
        want = {"poly_paths": 0, "circ_paths": 0, **want}
        if got != want:
            fail(f"tiled path, {label}: kernel launches {got}, expected {want}")
        for k in launches:
            launches[k] += got[k]

    def same(a, b):
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.is_floating_point():
            return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
        return bool(torch.equal(a, b))

    def check_layers(got, want, label):
        for k, w in want.items():
            if not same(got[k], w):
                fail(f"tiled path, {label}: layer {k} differs")

    # (a) the tile bodies, each tile's halo cut from the NaN-padded map on the host
    maps = {"336x336": terrain,
            "337x335 4% NaN": synthetic_terrain(337, 335, res, seed=8, nan_frac=0.04)}
    for label, elev_np in maps.items():
        H, W = elev_np.shape
        whole = update_kernel.fused_update(torch.as_tensor(elev_np, device=dev), chain, veto)
        state = footprint.QueryState(whole["traversability"], whole["traversable_mask"],
                                     torch.zeros(2, device=dev), res, 0.5)
        ok_w, tv_w = field_kernel.dense_circle_field(state, rmax, radius)
        for gx, gy in ((2, 2), (2, 4)):
            Hp, Wp = -(-H // gx) * gx, -(-W // gy) * gy
            th, tw = Hp // gx, Wp // gy
            big = np.full((Hp + 2 * halo, Wp + 2 * halo), np.nan, np.float32)
            big[halo : halo + H, halo : halo + W] = elev_np
            tv_big = np.full((Hp + 2 * fh, Wp + 2 * fh), np.nan, np.float32)
            tv_big[fh : fh + H, fh : fh + W] = whole["traversability"].cpu().numpy()
            mk_big = np.zeros(tv_big.shape, bool)
            mk_big[fh : fh + H, fh : fh + W] = whole["traversable_mask"].cpu().numpy()
            tiles = [(ix, iy) for ix in range(gx) for iy in range(gy)]

            def cut(ix, iy):
                return torch.as_tensor(
                    big[ix * th : (ix + 1) * th + 2 * halo, iy * tw : (iy + 1) * tw + 2 * halo],
                    device=dev), ((ix * th - halo, iy * tw - halo), (H, W))

            got = {k: torch.empty((Hp, Wp), dtype=v.dtype, device=dev) for k, v in whole.items()}
            ok_t = torch.empty((Hp, Wp), dtype=torch.bool, device=dev)
            tv_t = torch.empty((Hp, Wp), dtype=torch.float32, device=dev)
            zero_counts()
            for ix, iy in tiles:
                tile, (origin, gshape) = cut(ix, iy)
                for k, v in sh.tile_update(tile, chain, veto, halo, origin, gshape).items():
                    got[k][ix * th : (ix + 1) * th, iy * tw : (iy + 1) * tw] = v
            tally({"fused_update": len(tiles), "circle_field": 0}, f"{label} {gx}x{gy} update")
            zero_counts()
            for ix, iy in tiles:
                win = (slice(ix * th, (ix + 1) * th + 2 * fh),
                       slice(iy * tw, (iy + 1) * tw + 2 * fh))
                o, t = sh.tile_circle_field(
                    torch.as_tensor(tv_big[win], device=dev),
                    torch.as_tensor(mk_big[win], device=dev),
                    fh, (ix * th - fh, iy * tw - fh), (H, W), rmax, radius, res)
                ok_t[ix * th : (ix + 1) * th, iy * tw : (iy + 1) * tw] = o
                tv_t[ix * th : (ix + 1) * th, iy * tw : (iy + 1) * tw] = t
            tally({"fused_update": 0, "circle_field": len(tiles)}, f"{label} {gx}x{gy} field")
            check_layers({k: v[:H, :W] for k, v in got.items()}, whole,
                         f"{label} {gx}x{gy} stitched tiles vs the whole map")
            if not (same(ok_t[:H, :W], ok_w) and same(tv_t[:H, :W], tv_w)):
                fail(f"tiled path, {label} {gx}x{gy}: the stitched circle field differs")
            # kernel 1 with a map origin against its plain version with the same
            # frame: the corner tile (its halo leaves the map) and the last one
            # (it holds the padding that makes the map divide the grid)
            for ix, iy in ((0, 0), (gx - 1, gy - 1)):
                tile, frame = cut(ix, iy)
                check_layers(update_kernel.fused_update(tile, chain, veto, *frame),
                             update_kernel.fused_update_plain(tile, chain, veto, *frame),
                             f"{label} tile ({ix}, {iy}) of {gx}x{gy}, kernel 1 vs plain")
            # both kernels at the shapes of the last tile's bodies
            tile, frame = cut(gx - 1, gy - 1)
            win = (slice(Hp - th, Hp + 2 * fh), slice(Wp - tw, Wp + 2 * fh))
            state_t = footprint.QueryState(
                torch.as_tensor(tv_big[win], device=dev), torch.as_tensor(mk_big[win], device=dev),
                torch.zeros(2, device=dev), res, 0.5)
            in_map_t = global_in_map(state_t.shape, (Hp - th - fh, Wp - tw - fh), (H, W), dev)
            k1_ms = kernel_timer(lambda: update_kernel.fused_update(tile, chain, veto, *frame), 50)
            k2_ms = kernel_timer(
                lambda: field_kernel.dense_circle_field(state_t, rmax, radius, in_map_t), 50)
            log(f"tiled path (a) {label} on a {gx}x{gy} grid (tiles {th}x{tw}, halo {halo}, field "
                f"halo {fh}): kernel 1 and kernel 2 launched once per tile; the stitched crops "
                f"bit-identical in every layer to the whole map's kernel 1 and kernel 2; kernel 1 "
                f"at origins {frame[0]} and (-{halo}, -{halo}) bit-identical to its plain version; "
                f"({card_line}) kernel 1 on the {tuple(tile.shape)} padded tile {k1_ms:.4f} ms, "
                f"kernel 2 on the {state_t.shape} padded tile {k2_ms:.4f} ms device time")

    # (b) world size 1 over nccl: the sharded online tick at config 4's width
    grid = multihost.initialize_multihost(f"localhost:{free_port()}", 1, 0, device=dev)
    if (grid.gx, grid.gy) != (1, 1) or dist.get_backend() != sh.backend_for(dev):
        fail(f"initialize_multihost: grid {grid.gx}x{grid.gy} over {dist.get_backend()}")

    def tile_kernel_ms(elev_t, layers_t):
        """Device ms of kernel 1 and kernel 2 on the halo-padded tiles of
        the world-size-1 grid, as the tile bodies launch them."""
        gshape = tuple(elev_t.shape)
        pt = sh.halo_pad(elev_t, halo, float("nan"), grid)
        pf = sh.halo_pad(torch.stack([layers_t["traversability"],
                                      layers_t["traversable_mask"].to(torch.float32)]),
                         fh, (float("nan"), 0.0), grid)
        st = footprint.QueryState(pf[0].contiguous(), pf[1] > 0.5, torch.zeros(2, device=dev),
                                  res, 0.5)
        im = global_in_map(st.shape, (-fh, -fh), gshape, dev)
        return {
            f"kernel 1 on the {tuple(pt.shape)} padded tile": kernel_timer(
                lambda: update_kernel.fused_update(pt, chain, veto, (-halo, -halo), gshape), 20),
            f"kernel 2 on the {st.shape} padded tile": kernel_timer(
                lambda: field_kernel.dense_circle_field(st, rmax, radius, im), 20),
        }
    n_map = int(round(TILED_MAP_M / res))
    # a circle of TILED_CIRCLE_M / 4
    near = online_ticks(source, TILED_TICKS, TILED_CIRCLE_M, 4.0, TILED_TICK_PATHS)
    elev = torch.full((n_map, n_map), float("nan"), device=dev)
    ref = TraversabilityEstimator(cfg, device=dev)
    tick_ms, n_safe = [], []
    def sharded_tick(elev, patch, start, poses, n_poses):
        return sh.sharded_online_tick(elev, patch, start, poses, n_poses, grid=grid,
                                      chain_cfg=chain, veto_cfg=veto, radius=radius,
                                      offset=offset, resolution=res, max_segment_cells=16)

    for k, (patch, (cx, cy), poses, n_poses) in enumerate(near):
        ph, pw = patch.shape
        start = (int(np.floor((n_map * res / 2 - (cx + ph * res / 2)) / res)),
                 int(np.floor((n_map * res / 2 - (cy + pw * res / 2)) / res)))
        merged = elev.clone()
        merged[start[0] : start[0] + ph, start[1] : start[1] + pw] = torch.as_tensor(
            patch, device=dev)
        t0 = time.perf_counter()
        zero_counts()
        elev, layers, safe, trav = sharded_tick(elev, patch, start, poses, n_poses)
        safe, trav = safe.cpu(), trav.cpu()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        tally({"fused_update": 1, "circle_field": 1}, f"sharded tick {k}")
        ref.update(merged)
        if not same(elev, merged):
            fail(f"sharded tick {k}: the merged elevation differs")
        check_layers(layers, {key: ref.traversability_map[key] for key in layers},
                     f"sharded tick {k} vs update() of the merged elevation")
        field = field_kernel.dense_circle_field(ref.query_state, rmax, radius)
        safe_l, trav_l = footprint.check_circular_paths_plain(
            ref.query_state, poses, n_poses, radius, offset, 16, field, False)
        if not (same(safe, safe_l.cpu()) and same(trav, trav_l.cpu())):
            fail(f"sharded tick {k}: verdicts differ from check_circular_paths_plain on the "
                 "same field "
                 f"({int((safe != safe_l.cpu()).sum())} paths)")
        n_safe.append(int(safe.sum()))
    if not 0 < sum(n_safe) < TILED_TICKS * TILED_TICK_PATHS:
        fail(f"sharded ticks: the verdicts are all alike: {n_safe}")
    try:
        sharded_tick(elev, patch, (n_map - ph // 2, 0), poses, n_poses)
    except ValueError as e:
        refused = str(e)
    else:
        fail("sharded tick: a merge start off the map did not raise")
    log(f"tiled path (b) sharded_online_tick, world size 1 over {dist.get_backend()}, "
        f"{n_map}x{n_map} map, {ph}x{pw} submaps, {TILED_TICK_PATHS} paths x 10 poses, "
        f"{TILED_TICKS} ticks on a {TILED_CIRCLE_M / 4:g} m circle: kernel 1 and kernel 2 once "
        f"per tick; after every tick "
        f"the map state bit-identical to update() of the merged elevation and the verdicts "
        f"({n_safe} safe) bit-identical to check_circular_paths_plain on the same field; a "
        f"merge off "
        f"the map raises ({refused!r})")
    stage_ms = {
        "tick": timer(lambda: sharded_tick(elev, patch, start, poses, n_poses), 10),
        "sharded_update (halo pad + kernel 1 + crop)": timer(
            lambda: sh.sharded_update(elev, chain, veto, grid), 10),
        "whole-map fused_update": timer(lambda: update_kernel.fused_update(elev, chain, veto), 10),
        "sharded_circle_field (halo pad + kernel 2 + crop)": timer(
            lambda: sh.sharded_circle_field(layers, grid, rmax, radius, res), 10),
    }
    stage_ms.update(tile_kernel_ms(elev, layers))
    ok_f, tv_f = sh.sharded_circle_field(layers, grid, rmax, radius, res)
    poses_d = torch.as_tensor(poses, device=dev)
    n_d = torch.as_tensor(n_poses, device=dev)
    stage_ms["check_circular_paths_tiled (per sample)"] = timer(
        lambda: sh.check_circular_paths_tiled(ok_f, tv_f, poses_d, n_d, grid, (0.0, 0.0), res, 16),
        20)
    log(f"tiled path (b) times ({card_line}): tick wall to fetched verdicts, ticks 1-"
        f"{TILED_TICKS - 1}: median {np.median(tick_ms[1:]):.4f} ms, "
        f"max {np.max(tick_ms[1:]):.4f} ms; "
        + "; ".join(f"{k} {v:.4f} ms" for k, v in stage_ms.items()))
    trace("sharded tick", lambda: sharded_tick(elev, patch, start, poses, n_poses)[2].cpu(), 5, 8)

    # (c) config 5's tile: the 60 m map any process of the grid owns
    n5 = TILED_TILE_CELLS
    elev5 = torch.as_tensor(synthetic_terrain(n5, n5, res, seed=5), device=dev)
    zero_counts()
    layers5 = sh.sharded_update(elev5, chain, veto, grid)
    ok5, tv5 = sh.sharded_circle_field(layers5, grid, rmax, radius, res)
    tally({"fused_update": 1, "circle_field": 1}, "config 5 update and field")
    state5 = footprint.QueryState(layers5["traversability"], layers5["traversable_mask"],
                                  torch.zeros(2, device=dev), res, 0.5)
    # the rollouts script's batch: every rollout from the traversable cell
    # nearest the map's centre (a corner of the terrain's plateau)
    robot = rollouts.nearest_traversable(ok5.cpu().numpy(), res)
    rng = np.random.default_rng(5)
    N5 = 12
    poses5 = rollouts.rollout_batch(rng, robot, TILED_ROLLOUTS, N5)
    poses5_d = torch.as_tensor(poses5, device=dev)
    n5_d = torch.full((TILED_ROLLOUTS,), N5, dtype=torch.int32, device=dev)
    samples = TILED_ROLLOUTS * (N5 - 1) * 4
    if samples < sh._PATH_REDUCE_SAMPLES:
        fail(f"config 5: {samples} samples do not reach the per-path mode")

    def circular_tiled():
        return sh.check_circular_paths_tiled(ok5, tv5, poses5_d, n5_d, grid, (0.0, 0.0), res, 16)

    def circular_local():
        return footprint.check_circular_paths(
            state5, poses5_d, n5_d, radius, offset, 16, (ok5, tv5), False)

    zero_counts()
    safe5, trav5 = circular_tiled()
    tally({"fused_update": 0, "circle_field": 0}, "config 5 circular paths")
    safe_l, trav_l = circular_local()
    if not same(safe5, safe_l):
        fail(f"config 5: tiled circular verdicts differ on {int((safe5 != safe_l).sum())} paths")
    c_err = float((trav5 - trav_l).abs().max())
    if c_err > 1e-5:
        fail(f"config 5: tiled circular traversability differs by {c_err:g}")

    fp5 = np.float32([[0.25, 0.15], [0.25, -0.15], [-0.25, -0.15], [-0.25, 0.15]])
    pos3 = torch.as_tensor(np.concatenate(
        [poses5[:TILED_POLY_PATHS], np.zeros((TILED_POLY_PATHS, N5, 1), np.float32)], -1),
        device=dev)
    yaw = rng.uniform(0, 2 * np.pi, (TILED_POLY_PATHS, N5))
    quats = np.zeros((TILED_POLY_PATHS, N5, 4), np.float32)
    quats[..., 2], quats[..., 3] = np.sin(yaw / 2), np.cos(yaw / 2)
    quats = torch.as_tensor(quats, device=dev)
    seg = float(np.linalg.norm(np.diff(poses5[:TILED_POLY_PATHS], axis=1), axis=-1).max())
    window = footprint.polygon_window_cells(fp5, seg, res, False)
    n5p = n5_d[:TILED_POLY_PATHS]

    def polygonal_tiled(rows):
        saved = sh._PATH_REDUCE_SAMPLES
        if rows:  # the per-row sums, as below the threshold
            sh._PATH_REDUCE_SAMPLES = 1 << 62
        try:
            return sh.check_polygonal_paths_tiled(
                layers5, pos3, quats, n5p, fp5, grid, window, (0.0, 0.0), res, False, 0.5)
        finally:
            sh._PATH_REDUCE_SAMPLES = saved

    def polygonal_local():
        return footprint.check_polygonal_paths(state5, pos3, quats, n5p, fp5, window, False)

    want = polygonal_local()
    poly_err = {}
    for mode, rows in (("per polygon", False), ("per row", True)):
        got5 = polygonal_tiled(rows)
        if not same(got5[0], want[0]):
            fail(f"config 5: tiled polygonal verdicts ({mode}) differ on "
                 f"{int((got5[0] != want[0]).sum())} paths")
        t_err = float((got5[1] - want[1]).abs().max())
        a_err = float(((got5[2] - want[2]).abs() - 1e-5 * want[2].abs()).max())
        if t_err > 1e-5 or a_err > 1e-7:
            fail(f"config 5: tiled polygonal ({mode}) traversability off by {t_err:g}, area "
                 f"beyond rtol 1e-5 by {a_err:g}")
        poly_err[mode] = t_err
    log(f"tiled path (c) config 5's tile, {n5}x{n5}, world size 1: kernel 1 and kernel 2 once;"
        f" {TILED_ROLLOUTS} rollouts x {N5} poses through check_circular_paths_tiled "
        f"(per-path mode, {samples} samples): verdicts equal to check_circular_paths "
        f"({int(safe5.sum())} safe), trav max diff {c_err:g}; {TILED_POLY_PATHS} paths x {N5} "
        f"of the "
        f"0.5 x 0.3 m footprint with random yaw (window {window}) through "
        f"check_polygonal_paths_tiled: verdicts ({int(want[0].sum())} safe) and areas equal to "
        f"check_polygonal_paths within rtol 1e-5, trav max diff "
        + ", ".join(f"{k} {v:g}" for k, v in poly_err.items()))
    times5 = {
        "sharded_update": timer(lambda: sh.sharded_update(elev5, chain, veto, grid), 10),
        "whole-map fused_update": timer(lambda: update_kernel.fused_update(elev5, chain, veto), 10),
        "sharded_circle_field": timer(
            lambda: sh.sharded_circle_field(layers5, grid, rmax, radius, res), 10),
        "whole-map dense_circle_field": timer(
            lambda: field_kernel.dense_circle_field(state5, rmax, radius), 10),
        "check_circular_paths_tiled (per path)": timer(circular_tiled, 5),
        "check_circular_paths (local)": timer(circular_local, 5),
        "check_polygonal_paths_tiled (per polygon)": timer(lambda: polygonal_tiled(False), 3),
        "check_polygonal_paths_tiled (per row)": timer(lambda: polygonal_tiled(True), 3),
        "check_polygonal_paths (local)": timer(polygonal_local, 3),
        **tile_kernel_ms(elev5, layers5),
    }
    log(f"tiled path (c) times ({card_line}): "
        + "; ".join(f"{k} {v:.4f} ms" for k, v in times5.items())
        + f" -> {TILED_ROLLOUTS * N5 / times5['check_circular_paths_tiled (per path)'] * 1e3:.4g} "
        "pose-checks/s tiled")
    dist.destroy_process_group()
    return launches


# the keys of the JAX package's online-loop row (scripts/online_loop.py), which
# the port's row must carry
ONLINE_ROW_KEYS = {
    "kind", "fused", "pipelined_fetch", "fetch_depth", "fetch_bytes", "dispatch_only",
    "drain_s", "upload_bytes_per_tick", "upload_probe_ms", "query", "mode", "map_cells",
    "target_hz", "free_run", "achieved_hz", "warmup_ticks", "warmup_s", "measured_s", "ticks",
    "update_ms", "query_ms", "paths_per_tick",
}
# phase 10's online-loop runs of config 4: label -> the script's arguments
ONLINE_RUNS = {
    "free-run circular": ["--seconds", "3", "--rate", "0"],
    "10 Hz circular": ["--seconds", "2", "--rate", "10"],
    "free-run polygonal": ["--seconds", "2", "--rate", "0", "--footprint"],
    "free-run roaming, 20 m window": ["--seconds", "2", "--rate", "0", "--window-m", "20"],
}
ROLLOUT_SAMPLE = 1024


def drivers_phase(card_line, res, cfg, zero_counts, counts, k1_at, k2_at):
    """Phase 10: the roofline and the user-facing drivers on the card (see
    the module docstring). `k1_at` / `k2_at`: device ms of kernels 1 and 2
    by (H, W) from the earlier phases. Returns (the launches of the three
    kernels over the online-loop and rollout runs, the roofline at 336^2 of
    each kernel: {name: (bound ms, pct_sol)})."""
    import tempfile

    import torch

    from traversability_estimation_tpu_torch import TraversabilityEstimator
    from traversability_estimation_tpu_torch.ops import footprint, update_kernel
    from traversability_estimation_tpu_torch.ops.veto import required_halo
    from traversability_estimation_tpu_torch.parallel.sharding import backend_for
    from traversability_estimation_tpu_torch.scripts import online_loop, rollouts, scaling_bench
    from traversability_estimation_tpu_torch.utils import native, roofline
    from traversability_estimation_tpu_torch.utils.sources import SyntheticTerrainSource

    dev = torch.device("cuda")
    launches = {"fused_update": 0, "circle_field": 0, "poly_paths": 0, "circ_paths": 0}
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_drivers_")

    # (a) the card's peaks, and the JAX package's work counts priced at them
    t0 = time.perf_counter()
    peaks = roofline.measure_peaks(device=dev)
    spec = roofline.spec_peaks(dev)
    for key, unit in (("vpu_f32_flops_per_s", "TFLOP/s"), ("bool_ops_per_s", "Tops/s"),
                      ("hbm_bytes_per_s", "TB/s")):
        ratio = peaks[key] / spec[key]
        log(f"peak {key} ({card_line}): measured {peaks[key] / 1e12:.4f} {unit}, spec "
            f"{spec[key] / 1e12:.4f} {unit}, {100 * ratio:.1f}% of spec")
        if ratio > 1.05:
            fail(f"the measured {key} reads {100 * ratio:.1f}% of the spec sheet: a broken "
                 "measurement")
    shift_s = roofline.measure_static_shift_cost(
        (336, 336), vpu_f32_ops_per_s=peaks["vpu_f32_ops_per_s"], device=dev)
    radius, offset = 0.3, cfg.footprint.circular_footprint_offset
    work = {"fused_update": (roofline.update_op_estimate(cfg.chain, cfg.veto), k1_at),
            "dense_circle_field": (roofline.circle_field_op_estimate(radius + offset, res),
                                   k2_at)}
    sol = {}
    for name, (counts_k, times) in work.items():
        for (h, w), ms in sorted(times.items()):
            rep = roofline.sol_report(h * w, ms / 1e3, counts_k, peaks["vpu_f32_flops_per_s"],
                                      peaks["hbm_bytes_per_s"], peaks["bool_ops_per_s"])
            bound_ms = 1e3 * max(rep["t_compute_bound_s"], rep["t_memory_bound_s"])
            extra = ""
            if (h, w) == (336, 336):
                sol[name] = (bound_ms, rep["pct_sol"])
                rep_s = roofline.sol_report(h * w, ms / 1e3, counts_k,
                                            peaks["vpu_f32_flops_per_s"],
                                            peaks["hbm_bytes_per_s"], peaks["bool_ops_per_s"],
                                            shift_cost_s=shift_s)
                extra = (f"; with shifted reads priced at {shift_s * 1e6:.4f} us a plane: "
                         f"pct_sol {rep_s['pct_sol']:.2f}")
            log(f"roofline {name} at {h}x{w} ({card_line}): {ms:.4f} ms device time, bound "
                f"{bound_ms:.4f} ms from measured peaks over the JAX work counts "
                f"({rep['binding']}), pct_sol {rep['pct_sol']:.2f}{extra}")
    log(f"roofline: {time.perf_counter() - t0:.1f} s")

    # (b) the online loop of config 4, as a user runs it
    src = SyntheticTerrainSource(res)
    for label, extra in ONLINE_RUNS.items():
        record = []
        path = os.path.join(out_dir, "online.json")
        zero_counts()
        argv = extra + ["--json", path]
        opts = online_loop.parser().parse_args(argv)
        row = online_loop.main(argv, record=record)
        got = counts()
        with open(path) as f:
            if json.loads(f.readline()) != row:
                fail(f"online loop {label}: the JSON file differs from the returned row")
        missing = ONLINE_ROW_KEYS - set(row)
        if missing:
            fail(f"online loop {label}: the row lacks {sorted(missing)}")
        n_ticks = row["warmup_ticks"] + row["ticks"]
        want = {"fused_update": n_ticks,
                "circle_field": 0 if "--footprint" in extra else n_ticks,
                "poly_paths": n_ticks if "--footprint" in extra else 0,
                "circ_paths": 0 if "--footprint" in extra else n_ticks}
        if got != want:
            fail(f"online loop {label}: kernel launches {got}, expected {want}")
        depth = 3 if row["free_run"] else 1
        if not (row["ticks"] >= 1 and row["achieved_hz"] > 0 and row["fetch_bytes"] == opts.paths
                and row["fetch_depth"] == depth and len(record) == n_ticks):
            fail(f"online loop {label}: row {row}, {len(record)} ticks collected")
        for k in launches:
            launches[k] += got[k]
        if label == "free-run circular":
            # the script's first ticks against online_tick on the same inputs
            est = TraversabilityEstimator(cfg, device=dev)
            n = row["map_cells"][0]
            est.set_elevation_map(np.full((n, n), np.nan, np.float32))
            rng = np.random.default_rng(0)
            for t in range(3):
                patch, center, poses, n_poses = online_loop.tick_inputs(
                    t, rng, src, opts.map_m, opts.paths)
                safe = est.online_tick(patch, center, poses, n_poses, radius=0.3)[0].cpu()
                if record[t][0] != t or not np.array_equal(record[t][1], safe.numpy()):
                    fail(f"online loop tick {t}: the verdicts differ from online_tick's")
            del est
        upd, qry = row["update_ms"], row["query_ms"]
        log(f"online loop {label} ({card_line}): {row['ticks']} ticks in {row['measured_s']} s, "
            f"{row['achieved_hz']} Hz, map {row['map_cells']}, fetch depth {row['fetch_depth']};"
            f" tick queued p50 {upd['p50_ms']:.4f} ms p99 {upd['p99_ms']:.4f} ms; verdicts "
            f"collected p50 {qry.get('p50_ms', float('nan')):.4f} ms p99 "
            f"{qry.get('p99_ms', float('nan')):.4f} ms; upload probe {row['upload_probe_ms']} "
            f"ms; launches {got}"
            + ("; ticks 0-2 equal to online_tick on the same inputs"
               if label == "free-run circular" else ""))

    # (c) config 5's rollouts at the script's defaults, three steps
    steps = 3
    record = {}
    zero_counts()
    t0 = time.perf_counter()
    row = rollouts.main(["--steps", str(steps), "--stages"], record=record)
    wall = time.perf_counter() - t0
    got = counts()
    if row is None or len(record["steps"]) != steps:
        fail("rollouts: no traversable start, or steps missing")
    want = {"fused_update": 1 + steps, "circle_field": 1 + steps, "poly_paths": 0,
            "circ_paths": 1 + steps}
    if got != want:
        fail(f"rollouts: kernel launches {got}, expected {want}: the initial update and the "
             "start check's whole-map field and batch, then one update, one query-crop field "
             "and one batch a step")
    for k in launches:
        launches[k] += got[k]
    est, start, r0 = record["estimator"], record["start"], record["steps"][0]
    lay, (i0, j0, h, w) = r0["layers"], r0["window"]
    win = (slice(i0, i0 + h), slice(j0, j0 + w))

    def same_np(a, b):
        return a.dtype == b.dtype and np.array_equal(a, b, equal_nan=a.dtype.kind == "f")

    # kernel 1 at config 5's size: the plain update on the card over step 0's
    # query window (cells of the initial whole-map update and of step 0's
    # refresh), bit-identical to the map's layers inside the window's halo
    m = required_halo(est.config.chain, est.config.veto)
    plain = update_kernel.fused_update_plain(
        torch.as_tensor(lay["elevation"], device=dev), est.config.chain, est.config.veto,
        origin=(i0, j0), global_shape=tuple(row["map_cells"]))
    inner = (slice(m, h - m), slice(m, w - m))
    for k in ("traversability", "traversability_slope", "traversability_step",
              "traversable_mask"):
        if not same_np(plain[k].cpu().numpy()[inner], lay[k][inner]):
            fail(f"rollouts: the map's {k} differs from the plain update over step 0's "
                 f"{h}x{w} window, {m} cells of halo off")
    # kernel 2 at config 5's size: the start check's whole-map field over the
    # same window, bit-identical to the plain field over the start map's
    # planes there, beyond the circle's reach of the window's edge
    st = start["state"]
    sub = footprint.QueryState(st.traversability[win], st.traversable_mask[win], st.position,
                               res, st.default_traversability)
    ok_p, trav_p = (f.cpu().numpy() for f in footprint.dense_circle_field(
        sub, radius + offset, radius))
    reach = int(np.ceil((radius + offset) / res)) + 1
    inner2 = (slice(reach, h - reach), slice(reach, w - reach))
    ok_w, trav_w = (f[win].cpu().numpy() for f in start["field"])
    if not (same_np(ok_w[inner2], ok_p[inner2]) and same_np(trav_w[inner2], trav_p[inner2])):
        fail(f"rollouts: the start check's whole-map circle field differs from the plain field "
             f"over the {h}x{w} window")
    # the start check's verdicts against check_circles on the CPU over its planes
    st_cpu = footprint.QueryState(st.traversability.cpu(), st.traversable_mask.cpu(),
                                  st.position.cpu(), res, st.default_traversability)
    ok_s, trav_s = footprint.check_circles(
        st_cpu, torch.from_numpy(start["candidates"][:, 0]), radius + offset, radius)
    ok_s = ok_s.numpy()
    start_err = float(np.abs(np.where(ok_s, trav_s.numpy(), 0.0) - start["trav"]).max())
    if not np.array_equal(ok_s, start["ok"]) or start_err > 1e-6:
        fail(f"rollouts: the start check's verdicts differ from check_circles on the CPU "
             f"({int((ok_s != start['ok']).sum())} verdicts, trav by {start_err:g})")

    def cpu_paths(trav_plane, mask_plane, position, poses, max_cells):
        """check_circular_paths on the CPU over a query window's planes."""
        state_c = footprint.QueryState(
            torch.as_tensor(trav_plane).cpu(), torch.as_tensor(mask_plane).cpu(),
            torch.as_tensor(position).cpu(), res, 0.5)
        field_c = footprint.dense_circle_field(state_c, radius + offset, radius)
        s, t = footprint.check_circular_paths(
            state_c, poses, np.full((len(poses),), poses.shape[1], np.int32), radius, offset,
            max_cells, field_c, False)
        return s.numpy(), t.numpy()

    # a sample of step 0's rollouts, and a batch beside an obstacle (the start
    # field's untraversable cell nearest the robot) answered by the estimator
    # on the final map, each against the CPU on the query window it was
    # answered on
    P, N = r0["poses"].shape[:2]
    n_pick = min(ROLLOUT_SAMPLE, P)
    pick = np.random.default_rng(7).choice(P, n_pick, replace=False)
    t0 = time.perf_counter()
    safe_c, trav_c = cpu_paths(lay["traversability"], lay["traversable_mask"], r0["position"],
                               r0["poses"][pick], r0["max_cells"])
    ok_whole = start["field"][0]
    p0 = st.position.cpu().numpy().astype(np.float64) + np.array(ok_whole.shape) * res / 2
    bad = torch.nonzero(~ok_whole).double()
    if not len(bad):
        fail("rollouts: the start check's field has no untraversable cell")
    rc = torch.as_tensor(np.floor((p0 - r0["robot"]) / res), device=dev)
    b = bad[torch.argmin(((bad - rc) ** 2).sum(1))]
    lo = torch.clamp(b - 32, min=0).long()
    good = torch.nonzero(ok_whole[lo[0] : lo[0] + 65, lo[1] : lo[1] + 65]).double() + lo
    if not len(good):
        fail("rollouts: no traversable cell within 32 cells of the obstacle")
    edge = p0 - (good[torch.argmin(((good - b) ** 2).sum(1))].cpu().numpy() + 0.5) * res
    poses_e = rollouts.rollout_batch(np.random.default_rng(11), edge, n_pick, N)
    n_e = np.full((n_pick,), N, np.int32)
    safe_e, trav_e = (x.cpu().numpy() for x in est.check_circular_paths_batch(
        poses_e, n_e, radius))
    crop_e, _ = est._cropped_state_and_field(est._current_epoch(), poses_e, radius, offset)
    safe_ec, trav_ec = cpu_paths(crop_e.traversability, crop_e.traversable_mask,
                                 crop_e.position, poses_e, est._max_segment_cells(poses_e, n_e))
    cpu_s = time.perf_counter() - t0
    safe_g = np.concatenate([r0["safe"][pick], safe_e])
    safe_w = np.concatenate([safe_c, safe_ec])
    if not np.array_equal(safe_g, safe_w):
        fail(f"rollouts: is_safe of the sample differs from the CPU run on "
             f"{int((safe_g != safe_w).sum())} of {len(safe_g)}")
    t_err = float(np.abs(np.concatenate([r0["trav"][pick], trav_e]) - np.concatenate(
        [trav_c, trav_ec])).max())
    if t_err > 1e-6:
        fail(f"rollouts: traversability of the sample differs from the CPU run by {t_err:g}")
    if safe_g.all() or not safe_g.any():
        fail(f"rollouts: the sample holds one verdict only ({int(safe_g.sum())} of "
             f"{len(safe_g)} safe)")
    try:
        eng = native.BaselineQueryEngine(
            {k: lay[k] for k in ("elevation", "traversability", "traversability_slope",
                                 "traversability_step")}, res)
        centers = (r0["poses"][pick].reshape(-1, 2) - r0["position"]).astype(np.float64)
        t0 = time.perf_counter()
        eng.check_circles(centers, radius + offset, radius)
        native_rate = f"{len(centers) / (time.perf_counter() - t0):.6g} circle checks/s"
    except native.NativeUnavailable as e:
        native_rate = f"not measured ({e})"
    log(f"rollouts (config 5, {row['map_cells']} cells, {P} x {N}, {card_line}): budget p50 "
        f"{row['budget_p50_ms']} ms -> {row['pose_checks_per_s']:.6g} pose-checks/s; stage "
        f"p50 ms {row['stage_p50_ms']}; {wall:.1f} s with the map's set-up; launches {got}; "
        f"on step 0's {h}x{w} query window the map's layers bit-identical to the plain update "
        f"({m} cells of halo off) and the start check's whole-map field to the plain field; "
        f"the start check's {len(ok_s)} verdicts ({int(ok_s.sum())} ok) equal to check_circles "
        f"on the CPU, trav within {start_err:g}; {n_pick} rollouts of step 0 and {n_pick} "
        f"beside the obstacle at {np.round(edge, 3).tolist()} against the CPU on their query "
        f"windows ({cpu_s:.1f} s): is_safe equal ({int(safe_c.sum())} and "
        f"{int(safe_ec.sum())} safe), trav max diff {t_err:g}; the native C++ baseline on "
        f"this host, one thread, step 0's sample's {n_pick * N} poses: {native_rate}")

    # (d) scaling of the tiled path, one process over nccl
    t0 = time.perf_counter()
    rows = scaling_bench.main(["--sizes", "1"])
    kinds = sorted(r["kind"] for r in rows)
    if kinds != ["scaling_summary", "scaling_tiled_query", "scaling_update"] or \
            rows[0]["backend"] != backend_for(dev):
        fail(f"scaling_bench: rows {rows}")
    log(f"scaling_bench --sizes 1 ({card_line}, {time.perf_counter() - t0:.1f} s): "
        + "; ".join(json.dumps(r) for r in rows[:2]))
    return launches, sol


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import traversability_estimation_tpu_torch as port
        from traversability_estimation_tpu_torch import (
            ChainConfig,
            EstimatorConfig,
            FootprintConfig,
            FootprintPath,
            SyntheticTerrainSource,
            TraversabilityEstimator,
        )
        from traversability_estimation_tpu_torch.kernels import build
        from traversability_estimation_tpu_torch.ops import (
            circ_kernel,
            field_kernel,
            footprint,
            poly_kernel,
            update_kernel,
        )
        from traversability_estimation_tpu_torch.ops.veto import required_halo
        from traversability_estimation_tpu_torch.utils import roofline
    except ImportError as e:
        fail(f"the port is not importable here: {e}")
    # the port under test is the one beside this script, never an installed copy
    if not Path(port.__file__).resolve().is_relative_to(Path(root).resolve()):
        fail(f"the port was imported from {port.__file__}, not from {root}")
    if any(m == "jax" or m.startswith(("jax.", "traversability_estimation_tpu."))
           or m == "traversability_estimation_tpu" for m in sys.modules):
        fail("the port imported jax or the JAX package")
    if "yaml" in sys.modules:
        fail("the port imported yaml: it must run where PyYAML is absent")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    # kernel 4 evaluates a circular path's single pose itself: outside the
    # referees, check_circles never runs on the card (checked at the end)
    footprint.check_circles.card_calls = 0

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
    k3_plan = poly_kernel.launch_plan(1024, 50, 4, 76, False)  # the 1024 x 50 random-yaw batch
    k3_occ = poly_kernel.occupancy(k3_plan)
    k4_plan = circ_kernel.launch_plan(1024, 50)  # the main path's 1024 x 50
    k4_occ = circ_kernel.occupancy(50)
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
        "poly_paths": launch_line(k3_plan.grid, k3_plan.block, k3_plan.smem_bytes, k3_occ,
                                  k3_plan.warps) + " (1024 paths)",
        "circ_paths": launch_line((k4_plan.grid, 1), (k4_plan.block, 1), k4_plan.smem, k4_occ,
                                  k4_plan.grid * circ_kernel.WARPS) + " (1024 paths x 50)",
    }
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if any(w in line for w in ("entry function", "registers", "spill")):
                log(f"ptxas {name}: {line.strip()}")
    for name, line in geometry.items():
        log(f"launch {name} at {H}x{W}: {line}")
    if min(*k1_occ, k2_occ, k3_occ, k4_occ) < 1:
        fail(f"a kernel cannot be resident on an SM: {k1_occ}, {k2_occ}, {k3_occ}, {k4_occ}")

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
        # a sleep of N cycles lasts at least N / the boost clock
        torch.cuda._sleep(int(4 * issue_s * roofline.SM_CLOCK_MAX_HZ))
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

    fused_steps = [0]  # the most float32 steps a fused layer was off its plain version

    def check_update(got, ref, label, ulps=0):
        """Kernel 1's layers against the plain version's: every layer
        bit-identical; with `ulps`, the fused layer within that many float32
        steps instead. Returns the largest float difference."""
        torch.cuda.synchronize()
        if set(got) != set(ref):
            fail(f"kernel 1 layer set {sorted(got)} != plain {sorted(ref)}")
        err = 0.0
        for k in ref:
            if ulps and k == "traversability" and got[k].dtype == ref[k].dtype:
                fin = torch.isfinite(ref[k])
                if not torch.equal(torch.isnan(got[k]), torch.isnan(ref[k])):
                    fail(f"kernel 1 {label}: {k} has NaN in other cells than the plain version")
                steps = int((got[k][fin].view(torch.int32)
                             - ref[k][fin].view(torch.int32)).abs().max()) if bool(fin.any()) else 0
                fused_steps[0] = max(fused_steps[0], steps)
                if steps > ulps:
                    fail(f"kernel 1 {label}: {k} is {steps} float32 steps off the plain version "
                         f"(bar {ulps})")
            elif got[k].dtype != ref[k].dtype or not same(got[k], ref[k]):
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
    expr_cfgs = {
        name: EstimatorConfig(resolution=res, chain=ChainConfig(
            resolution=res, fusion_expression=expression, compute_roughness=rough))
        for name, (expression, rough, _) in EXPRESSIONS.items()
    }
    for name, ecfg in expr_cfgs.items():
        ulps = EXPRESSIONS[name][2]
        n_prog = update_kernel.kernel_params(ecfg.chain, ecfg.veto).n_prog
        fused_steps[0] = 0
        before = update_kernel.fused_update.launches
        for label, elev_np in shapes.items():
            elev = torch.as_tensor(elev_np, device=dev)
            got = update_kernel.fused_update(elev, ecfg.chain, ecfg.veto)
            ref = update_kernel.fused_update_plain(elev, ecfg.chain, ecfg.veto)
            err = check_update(got, ref, f"{label} expression {name!r}", ulps)
            k1_err = max(k1_err, err)
        if update_kernel.fused_update.launches != before + len(shapes):
            fail(f"expression {name!r}: kernel 1 did not launch once per update")
        log(f"kernel 1 parity, fusion expression {name!r} ({n_prog} program entries), "
            f"{len(shapes)} shapes: "
            + ("every layer bit-identical" if not ulps else
               f"fused layer within {fused_steps[0]} float32 steps (bar {ulps}, largest "
               f"difference {err:g} at the last shape), the other layers bit-identical"))
    for bad, what in (("+".join(["traversability_slope"] * 40), "program entries"),
                      ("traversability_slope+(1+(2+(3+(4+(5+(6+(7+(8+9))))))))", "stack")):
        try:
            update_kernel.fused_update(
                torch.as_tensor(terrain, device=dev),
                ChainConfig(resolution=res, fusion_expression=bad), cfg.veto)
        except ValueError as e:
            if what not in str(e):
                fail(f"an expression over the kernel's cap raised {e!r}, expected {what!r}")
        else:
            fail(f"an expression over the kernel's {what} cap did not raise")

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
    rng3 = np.random.default_rng(3)
    poses = make_paths(rng3, P, N, H * res / 2 * 0.8)
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
    circ_kernel.check_circular_paths.launches = 0
    circ_kernel.device_inputs.copies = 0
    est.update(terrain)
    safe, trav = est.check_circular_paths_batch(poses, n_poses, radius)
    few_res = est.check_footprint_path(few)
    torch.cuda.synchronize()
    launches = {
        "fused_update": update_kernel.fused_update.launches,
        "circle_field": field_kernel.dense_circle_field.launches,
        "circ_paths": circ_kernel.check_circular_paths.launches,
    }
    log(f"main path launches: {launches}; circular batches' pose uploads: "
        f"{circ_kernel.device_inputs.copies}; check_circles on the card: "
        f"{footprint.check_circles.card_calls}")
    if min(launches.values()) < 1:
        fail(f"a kernel of the main path did not launch: {launches}")
    # each circular batch: one launch of kernel 4, one upload of its poses,
    # no check_circles (the few include a path of one pose)
    if circ_kernel.device_inputs.copies != launches["circ_paths"] \
            or footprint.check_circles.card_calls:
        fail(f"main path: {circ_kernel.device_inputs.copies} pose uploads and "
             f"{footprint.check_circles.card_calls} check_circles calls on the card for "
             f"{launches['circ_paths']} circular batches")

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
    # the same update under each fusion expression, in turns with the weighted
    # sum (sum, expressions, sum)
    ref_cfg = expr_cfgs["reference"]
    k1_expr_ms = {
        name: device_ms(lambda: update_kernel.fused_update(elev_dev, c.chain, c.veto), 100)
        for name, c in expr_cfgs.items()
    }
    k1_ms_again = device_ms(lambda: update_kernel.fused_update(elev_dev, cfg.chain, cfg.veto), 100)
    log(f"kernel 1 at {H}x{W} by fusion ({card_line}): weighted sum {k1_ms:.4f} ms and "
        f"{k1_ms_again:.4f} ms; "
        + "; ".join(f"{name} {ms:.4f} ms" for name, ms in k1_expr_ms.items()))
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

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def trace(label, fn, reps, top_n):
        """Where the time of `fn` goes: wall time per call, the device's busy
        time and idle share, and its kernels by device time."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                n, us = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        if not by_name:
            log(f"{label} trace: wall {wall_ms:.4f} ms; device time not measured "
                "(no CUDA events traced)")
            return
        busy_ms = sum(us for _, us in by_name.values()) / 1e3 / reps
        per_call = sum(n for n, _ in by_name.values()) / reps
        log(f"{label} trace ({card_line}): wall {wall_ms:.4f} ms, device busy {busy_ms:.4f} ms, "
            f"idle share {1 - busy_ms / wall_ms:.4f}, {per_call:.0f} kernels per call")
        for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top_n]:
            log(f"  {us / 1e3 / reps:.4f} ms/call  x{n // reps:<4d} {name[:90]}")

    def epoch():
        """One map epoch: update -> field -> path batch."""
        est.update(terrain)
        est.check_circular_paths_batch(poses, n_poses, radius)

    trace("epoch", epoch, 5, 8)

    # ---- 5. polygonal paths and the dense footprint services, config 3 ----
    rect = np.asarray(est.config.footprint.footprint_polygon, np.float32)
    l_shape = np.float32(
        [[0.45, 0.3], [0.45, -0.3], [-0.45, -0.3], [-0.45, 0.0], [0.0, 0.0], [0.0, 0.3]])
    pos3 = np.concatenate([poses, np.zeros((P, N, 1), np.float32)], -1)
    quats_id = np.zeros((P, N, 4), np.float32)
    quats_id[..., 3] = 1.0
    yaw = rng3.uniform(0, 2 * np.pi, (P, N)).astype(np.float32)  # bench.py's rotated batch
    quats_rot = np.zeros((P, N, 4), np.float32)
    quats_rot[..., 2] = np.sin(yaw / 2)
    quats_rot[..., 3] = np.cos(yaw / 2)
    # name -> (batch arguments, expected evaluator, reason, translate_only)
    poly_batches = {
        "identity": ((pos3, quats_id, n_poses, rect, False), "grouped", "ok", True),
        "identity conservative": ((pos3, quats_id, n_poses, rect, True), "grouped", "ok", False),
        "random yaw": ((pos3, quats_rot, n_poses, rect, False), "grouped", "ok", False),
        "non-convex L, 128 paths": (
            (pos3[:128], quats_rot[:128], n_poses[:128], l_shape, False),
            "per_segment", "non_convex_footprint", False),
    }
    few_poly = [
        FootprintPath(poses=poses[3, :9], footprint=rect),
        FootprintPath(poses=poses[4], orientations=quats_rot[4], footprint=rect,
                      conservative=True),
        FootprintPath(poses=poses[5, :1], footprint=l_shape),
        FootprintPath(poses=poses[6, :20], orientations=quats_rot[6, :20], footprint=l_shape),
        FootprintPath(poses=poses[7, :12], radius=radius),
        FootprintPath(poses=poses[8, :33], orientations=quats_rot[8, :33], footprint=rect),
    ]
    dense_layers = ("traversability_x", "traversability_rot", "traversability_footprint")

    def drive_polygonal(e):
        """The polygonal path through the estimator's entry points: update,
        the four batches, a few FootprintPaths, both dense services."""
        e.update(terrain)
        outs, stats = {}, {}
        for name, (args, *_) in poly_batches.items():
            outs[name] = e.check_polygonal_paths_batch(*args)
            stats[name] = dict(e.last_polygonal_dispatch)
        few_out = e.check_footprint_path(few_poly)
        e.traversability_footprint()
        gmap = e.traversability_footprint_circle()
        return outs, stats, few_out, {k: gmap[k] for k in dense_layers}

    update_kernel.fused_update.launches = 0
    field_kernel.dense_circle_field.launches = 0
    poly_kernel.check_polygonal_paths_grouped.launches = 0
    circ_kernel.check_circular_paths.launches = 0
    t0 = time.perf_counter()
    outs, stats, few_out, layers = drive_polygonal(est)
    torch.cuda.synchronize()
    poly_wall = time.perf_counter() - t0
    poly_launches = {
        "fused_update": update_kernel.fused_update.launches,
        "circle_field": field_kernel.dense_circle_field.launches,
        "poly_paths": poly_kernel.check_polygonal_paths_grouped.launches,
        # the circular FootprintPath among the few
        "circ_paths": circ_kernel.check_circular_paths.launches,
    }
    log(f"polygonal path launches: {poly_launches} (first run {poly_wall:.2f} s wall)")
    if min(poly_launches.values()) < 1:
        fail(f"a kernel of the polygonal path did not launch: {poly_launches}")
    t0 = time.perf_counter()
    outs_c, stats_c, few_c, layers_c = drive_polygonal(cpu)
    log(f"polygonal path on the CPU (the referee): {time.perf_counter() - t0:.2f} s wall")

    for name, (args, evaluator, reason, translate_only) in poly_batches.items():
        st = stats[name]
        if st != stats_c[name]:
            fail(f"polygonal {name}: dispatch {st} differs from the CPU run's {stats_c[name]}")
        if (st["evaluator"], st["reason"], st["translate_only"]) != (
                evaluator, reason, translate_only):
            fail(f"polygonal {name}: dispatched as {st}, expected {evaluator}/{reason}")
        (safe_g, trav_g, area_g), (safe_r, trav_r, area_r) = outs[name], outs_c[name]
        n_paths = args[0].shape[0]
        if safe_g.shape != (n_paths,) or not bool(torch.isfinite(trav_g).all()) \
                or not bool(torch.isfinite(area_g).all()):
            fail(f"polygonal {name}: wrong shape or non-finite values")
        if not torch.equal(safe_g.cpu(), safe_r):
            fail(f"polygonal {name}: is_safe differs from the CPU run on "
                 f"{(safe_g.cpu() != safe_r).sum().item()} paths")
        trav_err = float((trav_g.cpu() - trav_r).abs().max())
        area_err = float(((area_g.cpu() - area_r).abs() - 1e-5 * area_r.abs()).max())
        if trav_err > 2e-5:
            fail(f"polygonal {name}: traversability differs from the CPU run by {trav_err:g}")
        if area_err > 1e-6:
            fail(f"polygonal {name}: area differs from the CPU run beyond rtol 1e-5 "
                 f"(excess {area_err:g})")
        window = st["block_window"] or st["group_window"]
        log(f"polygonal {name}: {st['evaluator']} ({st['reason']}, translate_only "
            f"{st['translate_only']}), path window {window}, {int(safe_g.sum())} of "
            f"{n_paths} safe; vs CPU run: is_safe equal, trav max diff {trav_err:g}, "
            f"area {float(area_g.min()):.4f} to {float(area_g.max()):.4f} m^2 within rtol 1e-5")
    for a, b in zip(few_out, few_c):
        if a.is_safe != b.is_safe or abs(a.traversability - b.traversability) > 2e-5 \
                or abs(a.area - b.area) > 1e-5 * abs(b.area) + 1e-6:
            fail(f"polygonal check_footprint_path differs from the CPU run: {a} vs {b}")
    log("polygonal check_footprint_path vs CPU run: equal, "
        f"{[(r.is_safe, round(r.traversability, 4), round(r.area, 3)) for r in few_out]}")
    if est.polygonal_dispatch_counts != cpu.polygonal_dispatch_counts:
        fail(f"dispatch counts {est.polygonal_dispatch_counts} differ from the CPU run's "
             f"{cpu.polygonal_dispatch_counts}")
    # the dispatch's window plan on the card against the NumPy planners
    for name in ("identity", "random yaw"):
        b_pos, b_quats, _, b_fp, _ = poly_batches[name][0]
        plan = footprint.path_window_plan(
            *(torch.as_tensor(a, device=dev) for a in (b_pos, b_quats, b_fp))).cpu().tolist()
        identity = bool(np.all(np.abs(b_quats - np.asarray([0, 0, 0, 1])) < 1e-12))
        ext = b_pos[..., :2].max(axis=1) - b_pos[..., :2].min(axis=1)
        group = footprint.path_group_window(b_fp, ext, res, True) if identity else \
            footprint.path_group_window_exact(b_fp, b_pos, b_quats, res)
        want = (identity, group, footprint.path_block_window(b_fp, b_pos, res, identity))
        got = footprint.planned_windows(plan, b_fp, res)
        if got != want:
            fail(f"polygonal {name}: window plan on the card {got} differs from the NumPy "
                 f"planners' {want}")
        log(f"polygonal {name}: window plan on the card equal to the NumPy planners' "
            f"(identity {identity}, group window {group}, block window {want[2]})")
    for k in dense_layers:
        got, want = layers[k].cpu(), layers_c[k]
        if got.shape != (H, W) or not bool(torch.isfinite(got).all()):
            fail(f"dense layer {k}: wrong shape or non-finite values")
        if not torch.equal(got != 0, want != 0):
            fail(f"dense layer {k}: ok differs from the CPU run")
        err = float((got - want).abs().max())
        if err > 1e-5:
            fail(f"dense layer {k}: score differs from the CPU run by {err:g}")
        log(f"dense layer {k} vs CPU run: ok equal ({int((got != 0).sum())} of {H * W} cells "
            f"traversable), score max diff {err:g}")
    ok_g, _ = footprint.dense_polygon_field(est.query_state, rect.astype(np.float64))
    ok_r, _ = footprint.dense_polygon_field(cpu.query_state, rect.astype(np.float64))
    if not torch.equal(ok_g.cpu(), ok_r):
        fail("dense_polygon_field: ok differs from the CPU run")

    # ---- 5b. kernel 3 against its plain version ----------------------------
    t0 = time.perf_counter()
    k3 = poly_kernel_phase(card_line, res, est, rect, pos3, quats_id, quats_rot, device_ms,
                           cuda_ms)
    log(f"kernel 3 phase: {time.perf_counter() - t0:.1f} s wall")

    poly_ms = {}
    for name, (args, *_) in poly_batches.items():
        poly_ms[name] = cuda_ms(lambda: est.check_polygonal_paths_batch(*args), 10)
    # the hull stage alone: transformed footprints -> one convex ring per segment
    pos3_dev = torch.as_tensor(pos3, device=dev)
    rect_dev = torch.as_tensor(rect, device=dev)
    polys_rot = footprint.transform_footprint(
        rect_dev, pos3_dev, torch.as_tensor(quats_rot, device=dev))
    polys_id = footprint.transform_footprint(
        rect_dev, pos3_dev, torch.as_tensor(quats_id, device=dev))
    hull_ms = {
        "random yaw (device hull, 8 points)": cuda_ms(
            lambda: footprint._segment_rings(polys_rot, pos3_dev, rect_dev, False, False), 10),
        "identity conservative (device hull, 16 points)": cuda_ms(
            lambda: footprint._segment_rings(polys_id, pos3_dev, rect_dev, True, False), 5),
        "identity (swept hull)": cuda_ms(
            lambda: footprint._segment_rings(polys_id, pos3_dev, rect_dev, False, True), 10),
    }
    service_ms = cuda_ms(lambda: est.traversability_footprint(), 3, 1)
    circle_service_ms = cuda_ms(lambda: est.traversability_footprint_circle(), 20)
    for name in ("identity", "random yaw"):
        args = poly_batches[name][0]
        trace(f"polygonal {name}", lambda: est.check_polygonal_paths_batch(*args), 3, 6)
    for name, ms in poly_ms.items():
        n_checks = poly_batches[name][0][0].shape[0] * N
        log(f"polygonal batch time ({card_line}): {name}: {ms:.4f} ms -> "
            f"{n_checks / (ms / 1e3):.4g} pose-checks/s")
    log(f"polygonal hull stage ({card_line}): "
        + "; ".join(f"{k} {v:.4f} ms" for k, v in hull_ms.items()))
    log(f"dense services ({card_line}): traversability_footprint (two polygon layers) "
        f"{service_ms:.3f} ms, traversability_footprint_circle {circle_service_ms:.4f} ms")

    # ---- 6. large map: the query-crop path --------------------------------
    HL = 2048
    big = synthetic_terrain(HL, HL, res, seed=1)
    big_poses = make_paths(np.random.default_rng(4), P, N, HL * res / 2 * 0.8)
    est_big = TraversabilityEstimator(EstimatorConfig(resolution=res))
    update_kernel.fused_update.launches = 0
    field_kernel.dense_circle_field.launches = 0
    circ_kernel.check_circular_paths.launches = 0
    t0 = time.perf_counter()
    est_big.update(big)
    safe_b, trav_b = est_big.check_circular_paths_batch(big_poses, n_poses, radius)
    torch.cuda.synchronize()
    big_wall = (time.perf_counter() - t0) * 1e3
    big_launches = {
        "fused_update": update_kernel.fused_update.launches,
        "circle_field": field_kernel.dense_circle_field.launches,
        "circ_paths": circ_kernel.check_circular_paths.launches,
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
    served_polygonal_batch(card_line, res, est_big, rect, device_ms, cuda_ms)

    # ---- 7. the online loop, config 4 --------------------------------------
    MAP_M, SUB_M, WINDOW_M, ON_P, N_TICKS = 50.0, 4.0, 20.0, 256, 60
    n_map, n_sub, n_win = (int(round(m / res)) for m in (MAP_M, SUB_M, WINDOW_M))
    halo = required_halo(cfg.chain, cfg.veto)
    n_crop = n_sub + 4 * halo
    source = SyntheticTerrainSource(res)
    t0 = time.perf_counter()
    ticks = online_ticks(source, N_TICKS + 12, MAP_M, SUB_M, ON_P)
    log(f"online loop (config 4): map {n_map}x{n_map}, submap {n_sub}x{n_sub}, update crop "
        f"{n_crop}x{n_crop} (halo {halo}), {ON_P} paths x 10 poses per tick; "
        f"{len(ticks)} ticks of input made in {time.perf_counter() - t0:.2f} s")

    def blank(n, device=None):
        e = TraversabilityEstimator(EstimatorConfig(resolution=res), device=device)
        e.set_elevation_map(np.full((n, n), np.nan, np.float32))
        return e

    def zero_counts():
        update_kernel.fused_update.launches = 0
        field_kernel.dense_circle_field.launches = 0
        poly_kernel.check_polygonal_paths_grouped.launches = 0
        circ_kernel.check_circular_paths.launches = 0

    def counts():
        return {"fused_update": update_kernel.fused_update.launches,
                "circle_field": field_kernel.dense_circle_field.launches,
                "poly_paths": poly_kernel.check_polygonal_paths_grouped.launches,
                "circ_paths": circ_kernel.check_circular_paths.launches}

    def check_maps(got, want, label, float_atol):
        """Two traversability maps: the same layers; elevation, the step
        layer and every veto plane bit-identical; the other float layers
        within `float_atol` (0: bit-identical too), NaN in the same cells."""
        if set(got.layers) != set(want.layers):
            fail(f"{label}: layer sets differ: {sorted(got.layers)} vs {sorted(want.layers)}")
        worst = 0.0
        for k, w in want.layers.items():
            g = got[k].to(w.device)
            if g.dtype != w.dtype or g.shape != w.shape:
                fail(f"{label}: layer {k} is {g.dtype} {tuple(g.shape)}, expected {w.dtype} "
                     f"{tuple(w.shape)}")
            loose = float_atol > 0 and k in (
                "traversability", "traversability_slope", "traversability_roughness")
            if not loose:
                if not same(g, w):
                    fail(f"{label}: layer {k} differs")
                continue
            if not torch.equal(torch.isnan(g), torch.isnan(w)):
                fail(f"{label}: layer {k} has NaN in other cells")
            err = float((g - w).nan_to_num(0.0).abs().max())
            worst = max(worst, err)
            if err > float_atol:
                fail(f"{label}: layer {k} differs by {err:g} (bar {float_atol:g})")
        if not torch.equal(got.position.cpu(), want.position.cpu()):
            fail(f"{label}: map positions differ")
        return worst

    def check_ticks(got, want, label, trav_atol, share=1.0, on_border=None):
        """Per-tick verdicts of two runs: on at least `share` of each tick's
        paths is_safe equal and traversability within `trav_atol`; with
        `on_border` (a tick's inputs and the map's width in cells), every
        other path must have a pose within 1e-3 cell of a cell border, where
        two float32 map origins may round it into different cells."""
        worst_share, worst_err, n_differ = 1.0, 0.0, 0
        for k, ((s_g, t_g), (s_w, t_w)) in enumerate(zip(got, want)):
            if s_g.shape != s_w.shape or not bool(torch.isfinite(t_g).all()):
                fail(f"{label} tick {k}: wrong shape or non-finite traversability")
            agree = (s_g == s_w) & ((t_g - t_w).abs() <= trav_atol)
            n_differ += int((~agree).sum())
            if on_border is not None and not bool(agree.all()):
                tick_inputs, n_cells = on_border
                # the map centre is a whole number of cells from the origin,
                # so borders lie at n_cells * res / 2 - i * res on both axes
                frac = ((n_cells * res / 2 - tick_inputs[k][2].astype(np.float64)) / res) % 1.0
                near = np.minimum(frac, 1.0 - frac).min(axis=(1, 2)) < 1e-3
                if not near[~agree.numpy()].all():
                    fail(f"{label} tick {k}: a path differs that has no pose on a cell border")
            worst_share = min(worst_share, float(agree.float().mean()))
            if bool(agree.any()):
                worst_err = max(worst_err, float((t_g - t_w)[agree].abs().max()))
            if float(agree.float().mean()) < share:
                fail(f"{label} tick {k}: only {int(agree.sum())} of {len(agree)} paths agree "
                     f"(is_safe equal, traversability within {trav_atol:g})")
        return worst_share, worst_err, n_differ

    class TickClock:
        """Per tick: CUDA events around the tick's queued work, and the
        host's clock from the call to the fetched verdicts."""

        def __init__(self):
            self.events, self.wall, self._t = {}, {}, {}

        def __call__(self, k, what):
            if what == "start":
                self.events[k] = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                self._t[k] = time.perf_counter()
                self.events[k][0].record()
            elif what == "queued":
                self.events[k][1].record()
            else:
                self.wall[k] = (time.perf_counter() - self._t[k]) * 1e3

        def device_ms(self, k):
            return self.events[k][0].elapsed_time(self.events[k][1])

    # 7a. 60 circular ticks on the card
    est_on = blank(n_map)
    clock = TickClock()
    zero_counts()
    outs_on, maps_on = drive_online(
        est_on, ticks[:N_TICKS], "circular", keep_maps=(5, N_TICKS - 1), clock=clock)
    torch.cuda.synchronize()
    online_launches = counts()
    log(f"online loop launches over {N_TICKS} circular ticks: {online_launches} "
        f"(tick 0 unfused on the whole map, {N_TICKS - 1} fused)")
    if online_launches != {"fused_update": N_TICKS, "circle_field": N_TICKS, "poly_paths": 0,
                           "circ_paths": N_TICKS}:
        fail(f"kernels 1, 2 and 4 must launch once per tick, kernel 3 never: {online_launches} "
             f"over {N_TICKS} ticks")
    if not any(k[0] == "tick_crop" for k in est_on._epoch.fields):
        fail("the fused tick did not run (no query crop kept with the map epoch)")
    n_safe = [int(s.sum()) for s, _ in outs_on]

    # 7b. the first 6 ticks on the CPU
    t0 = time.perf_counter()
    est_cpu = blank(n_map, "cpu")
    outs_cpu, maps_cpu = drive_online(est_cpu, ticks[:6], "circular", keep_maps=(5,))
    cpu_s = time.perf_counter() - t0
    _, err, _ = check_ticks(outs_on[:6], outs_cpu, "online circular vs CPU", 1e-6)
    map_err = check_maps(maps_on[5], maps_cpu[5], "online circular vs CPU, map after tick 5", 1e-6)
    known = int(torch.isfinite(maps_cpu[5]["elevation"]).sum())
    log(f"online circular vs CPU run, ticks 0-5 ({cpu_s:.1f} s on the CPU): is_safe equal on "
        f"every path ({sum(n_safe)} of {N_TICKS * ON_P} safe over all ticks), path trav max diff {err:g}; elevation, step "
        f"layer and veto planes bit-identical over the whole map ({known} known cells), float "
        f"layers max diff {map_err:g}")

    # 7c. the incrementally kept map against one full update of the merged map
    est_full = TraversabilityEstimator(EstimatorConfig(resolution=res))
    est_full.set_elevation_map(est_on._elevation.clone(), est_on._position)
    est_full.update()
    check_maps(maps_on[N_TICKS - 1], est_full.traversability_map,
               f"incremental map after {N_TICKS} ticks vs one full update", 0.0)
    log(f"incremental map after {N_TICKS} ticks vs one full update of the merged elevation on "
        f"the card: every layer bit-identical "
        f"({int(torch.isfinite(est_on._elevation).sum())} known cells)")
    del est_full

    # 7d. the unfused sequence on a second card estimator
    est_un = blank(n_map)
    outs_un, maps_un = drive_online(
        est_un, ticks[:N_TICKS], "circular", fused=False, keep_maps=(N_TICKS - 1,))
    share, err, n_differ = check_ticks(outs_on, outs_un, "online circular vs unfused", 1e-6, 0.98,
                                       on_border=(ticks, n_map))
    check_maps(maps_on[N_TICKS - 1], maps_un[N_TICKS - 1], "online circular vs unfused, map", 0.0)
    log(f"online circular vs the unfused sequence, {N_TICKS} ticks: map state bit-identical; "
        f"{n_differ} of {N_TICKS * ON_P} paths differ (lowest agreeing share of a tick "
        f"{share:.4f}), trav max diff on the others {err:g}")
    del est_un, maps_un

    # 7e. polygonal and roaming ticks. Config 4's circle of 12.5 m meets none
    # of the source's 0.3 m plateaus (every path above is safe); these runs
    # drive a circle of 5 m, which crosses a plateau's edge, so their verdicts
    # are of both kinds
    short = {}
    n_short = 10
    near = online_ticks(source, n_short, WINDOW_M, SUB_M, ON_P)
    for kind, n_cells in (("polygonal", n_map), ("roaming", n_win)):
        est_k = blank(n_cells)
        zero_counts()
        outs_k, maps_k = drive_online(est_k, near, kind, footprint=rect,
                                      keep_maps=(2, n_short - 1))
        torch.cuda.synchronize()
        short[kind] = counts()
        online_launches = {k: v + short[kind][k] for k, v in online_launches.items()}
        fused_ran = est_k._pwindow_hwm if kind == "polygonal" else any(
            k[0] == "tick_crop" for k in est_k._epoch.fields)
        if short[kind]["fused_update"] != n_short or not fused_ran:
            fail(f"online {kind}: kernel 1 launches {short[kind]} over {n_short} ticks, "
                 f"fused marks {fused_ran}")
        if kind == "roaming" and short[kind]["circle_field"] != n_short:
            fail(f"online roaming: kernel 2 launches {short[kind]} over {n_short} ticks")
        if short[kind]["poly_paths"] != (n_short if kind == "polygonal" else 0):
            fail(f"online {kind}: kernel 3 launches {short[kind]} over {n_short} ticks")
        if short[kind]["circ_paths"] != (0 if kind == "polygonal" else n_short):
            fail(f"online {kind}: kernel 4 launches {short[kind]} over {n_short} ticks")
        est_u = blank(n_cells)
        outs_u, maps_u = drive_online(est_u, near, kind, fused=False, footprint=rect,
                                      keep_maps=(n_short - 1,))
        atol = 2e-5 if kind == "polygonal" else 1e-6
        share, err, n_differ = check_ticks(
            outs_k, outs_u, f"online {kind} vs unfused", atol, 0.98,
            on_border=(near, n_cells) if kind == "roaming" else None)
        check_maps(maps_k[n_short - 1], maps_u[n_short - 1], f"online {kind} vs unfused, map", 0.0)
        est_c = blank(n_cells, "cpu")
        outs_c, maps_c = drive_online(est_c, near[:3], kind, footprint=rect, keep_maps=(2,))
        _, err_c, _ = check_ticks(outs_k[:3], outs_c, f"online {kind} vs CPU", atol)
        check_maps(maps_k[2], maps_c[2], f"online {kind} vs CPU, map after tick 2", 1e-6)
        if kind == "roaming" and not np.array_equal(est_k._position, est_u._position):
            fail("online roaming: positions differ from the unfused sequence")
        n_safe_k = [int(s.sum()) for s, _ in outs_k]
        if not 0 < sum(n_safe_k) < n_short * ON_P:
            fail(f"online {kind}: the verdicts are all alike: {n_safe_k}")
        log(f"online {kind}, {n_short} ticks on {n_cells}x{n_cells}: launches {short[kind]}; "
            f"{n_safe_k} of {ON_P} safe; vs the unfused sequence: map "
            f"state bit-identical, {n_differ} of {n_short * ON_P} paths differ (lowest share "
            f"{share:.4f}), trav max diff on the others {err:g}; vs CPU run (3 ticks): is_safe "
            f"equal, trav max diff {err_c:g}"
            + (f"; window mark {list(est_k._pwindow_hwm.values())}" if kind == "polygonal"
               else f"; final position {est_k._position.tolist()}"))
        del est_k, est_u, est_c, maps_k, maps_u, maps_c

    # 7f. times
    fused_ticks = range(10, N_TICKS)
    dev_ms = [clock.device_ms(k) for k in fused_ticks]
    wall_ms = [clock.wall[k] for k in fused_ticks]
    log(f"online tick times ({card_line}), ticks 10-{N_TICKS - 1}: CUDA events around the "
        f"tick's queued work mean {np.mean(dev_ms):.4f} ms, max {np.max(dev_ms):.4f} ms; wall "
        f"to fetched verdicts mean {np.mean(wall_ms):.4f} ms, max {np.max(wall_ms):.4f} ms -> "
        f"{1e3 / np.mean(wall_ms):.1f} Hz; tick 0 (unfused, whole map) wall "
        f"{clock.wall[0]:.2f} ms")
    layers_on = est_on.traversability_map.layers
    qs_on = est_on.query_state
    elev_on = est_on._elevation
    # the shapes are timed where the last tick cut them: the update crop around
    # its submap, the query crop around the robot (known terrain, not the
    # unknown cells that fill most of the map)
    cx, cy = ticks[N_TICKS - 1][1]
    ci, cj = (v - 2 * halo for v in est_on.traversability_map.index_of(
        (cx + SUB_M / 2, cy + SUB_M / 2)).tolist())
    crop_view = elev_on[ci : ci + n_crop, cj : cj + n_crop]
    crop_dense = crop_view.contiguous()
    qi, qj = (min(max(c + n_crop // 2 - 128, 0), n_map - 256) for c in (ci, cj))
    k1_params = update_kernel.kernel_params(cfg.chain, cfg.veto)
    produced = update_kernel.fused_update(crop_dense, cfg.chain, cfg.veto)
    cloned = [layers_on[k] for k in produced if k in layers_on] + [elev_on]
    # device ms of each kernel at the online shapes, for phase 10's roofline
    k1_at, k2_at = {(H, W): k1_ms}, {(H, W): k2_ms}
    for hh in (n_crop, n_map):
        plan_h = update_kernel.launch_plan(k1_params, hh, hh)
        occ_h = update_kernel.occupancy(plan_h)
        elev_h = crop_dense if hh == n_crop else elev_on
        ms_h = device_ms(lambda: update_kernel.fused_update(elev_h, cfg.chain, cfg.veto), 50)
        ms_e = device_ms(
            lambda: update_kernel.fused_update(elev_h, ref_cfg.chain, ref_cfg.veto), 50)
        b_h, by_h = roofline.bound(
            update_kernel.kernel_bytes(cfg.chain, cfg.veto, hh, hh),
            update_kernel.kernel_operations(cfg.chain, cfg.veto, hh, hh))
        b_e, by_e = roofline.bound(
            update_kernel.kernel_bytes(ref_cfg.chain, ref_cfg.veto, hh, hh),
            update_kernel.kernel_operations(ref_cfg.chain, ref_cfg.veto, hh, hh))
        k1_at[(hh, hh)] = ms_h
        if hh == n_crop:
            crop_expr = (ms_h, ms_e, b_e)
        log(f"kernel 1 at {hh}x{hh} ({card_line}): {ms_h:.4f} ms device time, bound {b_h:.4f} ms "
            f"({by_h}); with the reference fusion expression {ms_e:.4f} ms, bound {b_e:.4f} ms "
            f"({by_e}); layers kernel "
            + launch_line(plan_h.grid_layers, plan_h.block_layers, plan_h.smem_layers, occ_h[0],
                          plan_h.warps[0])
            + "; veto kernel "
            + launch_line(plan_h.grid_veto, plan_h.block_veto, plan_h.smem_veto, occ_h[1],
                          plan_h.warps[1]))
    q_shapes = sorted({(256, 256), (n_map, n_map)})
    for hq, wq in q_shapes:
        q0 = (qi, qj) if hq == 256 else (0, 0)
        state_q = footprint.QueryState(
            traversability=qs_on.traversability[q0[0] : q0[0] + hq, q0[1] : q0[1] + wq].contiguous(),
            traversable_mask=qs_on.traversable_mask[q0[0] : q0[0] + hq, q0[1] : q0[1] + wq].contiguous(),
            position=qs_on.position, resolution=res, default_traversability=0.5)
        plan_q = field_kernel.device_tables(radius + offset, res, hq, wq, dev)[0]
        ms_q = device_ms(
            lambda: field_kernel.dense_circle_field(state_q, radius + offset, radius), 50)
        k2_at[(hq, wq)] = ms_q
        b_q, by_q = roofline.bound(field_kernel.kernel_bytes(hq, wq),
                                   field_kernel.kernel_operations(n_off, hq, wq))
        log(f"kernel 2 at {hq}x{wq} ({card_line}): {ms_q:.4f} ms device time, bound "
            f"{b_q:.4f} ms ({by_q}); "
            + launch_line(plan_q.grid, plan_q.block, plan_q.smem_bytes,
                          field_kernel.occupancy(plan_q), plan_q.warps))
    clone_ms = device_ms(lambda: [t.clone() for t in cloned], 50)
    clone_mb = sum(t.numel() * t.element_size() for t in cloned) / 1e6
    crop_copy_ms = device_ms(lambda: crop_view.contiguous(), 100)
    q_view = (qs_on.traversability[qi : qi + 256, qj : qj + 256],
              qs_on.traversable_mask[qi : qi + 256, qj : qj + 256])
    q_copy_ms = device_ms(lambda: [v.contiguous() for v in q_view], 100)
    known_share = float(torch.isfinite(crop_dense).float().mean())
    log(f"timed at the last tick's crops: update crop at ({ci}, {cj}), {known_share:.3f} of its "
        f"cells known; query crop at ({qi}, {qj})")
    log(f"online tick copies ({card_line}): clone of the {len(cloned)} planes a tick replaces "
        f"({clone_mb:.1f} MB) {clone_ms:.4f} ms; contiguous copy of the {n_crop}x{n_crop} "
        f"elevation crop {crop_copy_ms:.4f} ms, of the 256x256 query crop (two planes) "
        f"{q_copy_ms:.4f} ms")
    traced = iter(ticks[N_TICKS:])

    def one_more_tick():
        drive_online(est_on, [next(traced)], "circular")

    trace("online tick", one_more_tick, 10, 8)

    # 7g. kernel 4 against its plain version: the main path's 1024 x 50 on
    # config 3's map, the tick's 256 x 10 on the query crop it answered on,
    # and the edge batches
    last_tick = next(traced)
    drive_online(est_on, [last_tick], "circular")
    _, _, tick_poses, tick_n = last_tick
    tick_epoch = est_on._current_epoch()
    (tick_key,) = [k for k in tick_epoch.fields if k[0] == "tick_crop"]
    tick_state, tick_field = tick_epoch.fields[tick_key]
    qs3 = est.query_state
    field3 = field_kernel.dense_circle_field(qs3, radius + offset, radius)
    poses_d, n_d = torch.as_tensor(poses, device=dev), torch.as_tensor(n_poses, device=dev)
    tick_d, tick_n_d = torch.as_tensor(tick_poses, device=dev), torch.as_tensor(tick_n, device=dev)
    rng_g = np.random.default_rng(24)
    n_mixed = rng_g.integers(2, N + 1, P).astype(np.int32)
    n_mixed[rng_g.random(P) < 0.25] = 1
    long_poses = make_paths(rng_g, 64, 800, H * res / 2 * 0.8, step=0.02)
    circ_batches = {
        "main path 1024 x 50": (qs3, poses_d, n_d, radius, offset, None, field3, False),
        "online tick 256 x 10": (
            tick_state, tick_d, tick_n_d, radius, offset, None, tick_field, False),
        "main path with single-pose paths": (
            qs3, poses_d, torch.as_tensor(n_mixed, device=dev), radius, offset, None, field3,
            True),
        "main path at the estimator's cap": (
            qs3, poses_d, n_d, radius, offset, est._max_segment_cells(poses, n_poses), field3,
            False),
        "online tick at the estimator's cap": (
            tick_state, tick_d, tick_n_d, radius, offset,
            est_on._max_segment_cells(tick_poses, tick_n), tick_field, False),
        "edge, default 0.5, segments cut at 8 cells": circ_edge_batch(est, res, 0.5, 12, 21, 8),
        "edge, default 0": circ_edge_batch(est, res, 0.0, 12, 22),
        "edge, single poses": circ_edge_batch(est, res, 0.5, 1, 23),
        "64 paths of 800 poses": (
            qs3, torch.as_tensor(long_poses, device=dev),
            torch.full((64,), 800, dtype=torch.int32, device=dev), radius, offset, None, field3,
            False),
    }
    t0 = time.perf_counter()
    k4 = circ_kernel_phase(card_line, circ_batches, device_ms, cuda_ms)
    log(f"kernel 4 phase: {time.perf_counter() - t0:.1f} s wall")

    # ---- 8. the serving path ----------------------------------------------
    serve_launches = serving_phase(
        card_line, res, terrain, rect, source, zero_counts, counts)

    # ---- 9. the tiled multi-process path ------------------------------------
    t0 = time.perf_counter()
    tiled_launches = tiled_phase(card_line, res, terrain, cfg, source, zero_counts, counts,
                                 cuda_ms, device_ms, trace)
    log(f"tiled path: {time.perf_counter() - t0:.1f} s wall, launches {tiled_launches}")

    # ---- 10. the roofline and the drivers -----------------------------------
    t0 = time.perf_counter()
    driver_launches, sol = drivers_phase(card_line, res, cfg, zero_counts, counts, k1_at, k2_at)
    log(f"roofline and drivers: {time.perf_counter() - t0:.1f} s wall, launches "
        f"{driver_launches}")

    # ---- 11. report -------------------------------------------------------
    if footprint.check_circles.card_calls:
        fail(f"check_circles ran {footprint.check_circles.card_calls} times on the card's "
             "circular paths (kernel 4 evaluates single poses itself)")
    log("check_circles on the card's circular paths: 0 calls")
    b1e, _ = roofline.bound(update_kernel.kernel_bytes(ref_cfg.chain, ref_cfg.veto, H, W),
                            update_kernel.kernel_operations(ref_cfg.chain, ref_cfg.veto, H, W))
    b1, by1 = roofline.bound(update_kernel.kernel_bytes(cfg.chain, cfg.veto, H, W),
                             update_kernel.kernel_operations(cfg.chain, cfg.veto, H, W))
    b2, by2 = roofline.bound(field_kernel.kernel_bytes(H, W),
                             field_kernel.kernel_operations(n_off, H, W))
    kernels = [
        {"name": "fused_update", "route": "cuda",
         "source": "traversability_estimation_tpu_torch/csrc/fused_update.cu",
         "replaces": "traversability_estimation_tpu/ops/pallas_chain.py:117",
         "launches": launches["fused_update"] + poly_launches["fused_update"]
         + online_launches["fused_update"] + serve_launches["fused_update"]
         + tiled_launches["fused_update"] + driver_launches["fused_update"],
         "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain_ms, "bound_ms": b1, "bound_by": by1, "library_ms": None,
         # the same kernel under the reference fusion expression, at 336^2 and
         # at the online tick's 189^2 crop (beside its weighted-sum time there)
         "expression_ms": k1_expr_ms["reference"], "expression_bound_ms": b1e,
         "crop_ms": crop_expr[0], "crop_expression_ms": crop_expr[1],
         "crop_expression_bound_ms": crop_expr[2],
         # measured peaks over the JAX package's work counts (utils/roofline.py)
         "sol_bound_ms": sol["fused_update"][0], "pct_sol": sol["fused_update"][1]},
        {"name": "dense_circle_field", "route": "cuda",
         "source": "traversability_estimation_tpu_torch/csrc/circle_field.cu",
         "replaces": "traversability_estimation_tpu/ops/pallas_field.py:125",
         "launches": launches["circle_field"] + poly_launches["circle_field"]
         + online_launches["circle_field"] + serve_launches["circle_field"]
         + tiled_launches["circle_field"] + driver_launches["circle_field"],
         "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": b2, "bound_by": by2, "library_ms": None,
         "sol_bound_ms": sol["dense_circle_field"][0], "pct_sol": sol["dense_circle_field"][1]},
        # not the port of a TPU kernel: the JAX package's grouped evaluator is
        # XLA-fused code; its time, bound and plain time at the 1024 x 50
        # random-yaw batch (phase 5b)
        {"name": "check_polygonal_paths_grouped", "route": "cuda",
         "source": "traversability_estimation_tpu_torch/csrc/poly_paths.cu",
         "replaces": "traversability_estimation_tpu/ops/footprint.py:1208",
         "launches": poly_launches["poly_paths"] + online_launches["poly_paths"]
         + serve_launches["poly_paths"] + tiled_launches["poly_paths"]
         + driver_launches["poly_paths"],
         "max_abs_err": k3["max_abs_err"], "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"], "library_ms": None},
        # not the port of a TPU kernel either: the JAX package's circular path
        # batch is XLA-fused code; its time, bound and plain time at the main
        # path's 1024 x 50 batch (phase 7g)
        {"name": "check_circular_paths", "route": "cuda",
         "source": "traversability_estimation_tpu_torch/csrc/circ_paths.cu",
         "replaces": "traversability_estimation_tpu/ops/footprint.py:378",
         "launches": launches["circ_paths"] + poly_launches["circ_paths"]
         + online_launches["circ_paths"] + serve_launches["circ_paths"]
         + tiled_launches["circ_paths"] + driver_launches["circ_paths"],
         "max_abs_err": k4["max_abs_err"], "ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"], "library_ms": None,
         # the tick's 256 x 10, an empty kernel at kernel 4's geometry (its
         # launch floor), the wrapper call from device tensors and from host
         # arrays (at the tick's batch too), check_circles' calls on the
         # card's circular paths
         "tick_ms": k4["tick_ms"], "empty_ms": k4["empty_ms"], "call_ms": k4["call_ms"],
         "host_call_ms": k4["host_call_ms"], "tick_host_call_ms": k4["tick_host_call_ms"],
         "check_circles_on_card": footprint.check_circles.card_calls},
    ]
    log(json.dumps({"kernels": kernels}))
    log(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
