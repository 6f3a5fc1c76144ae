"""Planner-in-the-loop rollouts, config 5: 100,000 footprint-path rollouts
per replanning step over a 200 m x 200 m map (6667^2 = 44M cells at 0.03 m).

Each step refreshes the map region around the robot from a 6 m submap,
builds the dense circle field, scores every rollout and moves the robot
along the best safe one; the replanning budget is the wall time of one full
step. Three modes:

- default: through the estimator, the query state and the field cropped to
  the rollouts' reach (``check_circular_paths_batch``); rollouts generated on
  the host from ``np.random.default_rng(0)``. ``--stages`` splits each step
  into gen / upload / update / field / query / fetch, timed by CUDA events
  on the device's timeline (the host clock for gen);
- ``--device-gen``: rollouts generated on the device from a
  ``torch.Generator`` seeded with the step number (its streams are
  PyTorch's, not ``jax.random``'s), scored, and only the best rollout and
  the counts fetched;
- ``--tiled``: the map tiled over the processes of ``parallel/sharding.py``
  (halo-exchanged update, tiled field, rollout verdicts summed over the
  ranks). Alone it is a world of one process; under ``torchrun
  --nproc-per-node N`` each process owns one tile (one GPU each, ``nccl``;
  with ``--device cpu``, CPU processes over ``gloo``).

Usage: python -m traversability_estimation_tpu_torch.scripts.rollouts
       [--rollouts 100000] [--map-m 200] [--steps 5] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

import numpy as np
import torch

RADIUS = 0.3
MAX_SEGMENT_CELLS = 16
FOOTPRINT = np.array([[0.25, 0.15], [0.25, -0.15], [-0.25, -0.15], [-0.25, 0.15]], np.float32)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def rollout_batch(rng: np.random.Generator, robot, P: int, N: int) -> np.ndarray:
    """P random-walk rollouts of N poses from `robot`: a heading per
    rollout, steps of 0.25 m along it plus uniform jitter of +-0.08 m.
    (P, N, 2) float32."""
    headings = rng.uniform(0, 2 * np.pi, P)
    base = np.stack([np.cos(headings), np.sin(headings)], -1) * 0.25
    steps_xy = base[:, None, :] + rng.uniform(-0.08, 0.08, (P, N - 1, 2))
    return np.concatenate(
        [np.broadcast_to(robot, (P, 1, 2)), robot + np.cumsum(steps_xy, 1)], axis=1
    ).astype(np.float32)


def device_rollouts(gen: torch.Generator, seed: int, robot, P: int, N: int, dev) -> torch.Tensor:
    """``rollout_batch``'s rollouts generated on `dev` from `gen` seeded
    with `seed` (PyTorch's random streams). (P, N, 2) float32."""
    gen.manual_seed(seed)
    headings = torch.rand((P,), generator=gen, device=dev) * (2 * np.pi)
    base = torch.stack([torch.cos(headings), torch.sin(headings)], -1) * 0.25
    jitter = torch.rand((P, N - 1, 2), generator=gen, device=dev) * 0.16 - 0.08
    robot_d = torch.as_tensor(robot, dtype=torch.float32, device=dev)
    return torch.cat([robot_d.expand(P, 1, 2),
                      robot_d + torch.cumsum(base[:, None, :] + jitter, 1)], 1)


def _best_rollout(poses, safe, trav):
    """The best safe rollout's 4th pose (float64), whether it is safe, its
    traversability and the number of safe rollouts, in one fetch."""
    N = poses.shape[1]
    best = torch.argmax(torch.where(safe, trav, torch.full_like(trav, -1.0)))
    out = torch.cat([poses[best, min(3, N - 1)], torch.stack(
        [safe[best].float(), trav[best], safe.sum().float()])]).cpu().numpy()
    return out[:2].astype(np.float64), bool(out[2]), float(out[3]), int(out[4])


def nearest_traversable(ok: np.ndarray, res: float):
    """The map position (float64) of the traversable cell of `ok` nearest
    the map's centre (the map centred at (0, 0)), or None."""
    ii, jj = np.nonzero(ok)
    if len(ii) == 0:
        return None
    H, W = ok.shape
    k = int(np.argmin((ii - H / 2) ** 2 + (jj - W / 2) ** 2))
    return np.array([H * res / 2 - (ii[k] + 0.5) * res, W * res / 2 - (jj[k] + 0.5) * res],
                    np.float64)


def initial_map(src, n: int, map_m: float, res: float) -> np.ndarray:
    """The whole n x n world from the source, made in bands of 1024 rows."""
    elev = np.empty((n, n), np.float32)
    for i0 in range(0, n, 1024):
        rows = min(1024, n - i0)
        cx = map_m / 2 - (i0 + rows / 2) * res
        elev[i0 : i0 + rows], _ = src.sample((cx, 0.0), (rows * res, map_m))
    return elev


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _write(args, blob):
    if args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps(blob) + "\n")
    return blob


def _steady(budgets):
    return float(np.median(budgets[1:])) if len(budgets) > 1 else budgets[0]


class _Stages:
    """Stage boundaries of one step: a CUDA event on the current stream and
    the host clock at each; a stage's time is its span on the device's
    timeline (the host clock's on the CPU, or where `host` is set)."""

    def __init__(self, cuda: bool):
        self.cuda, self.marks = cuda, []

    def mark(self, name=None, host=False):
        ev = None
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        self.marks.append((name, host, ev, time.perf_counter()))

    def spans_ms(self):
        if self.cuda:
            self.marks[-1][2].synchronize()
        out = {}
        for (_, _, e0, t0), (name, host, e1, t1) in zip(self.marks, self.marks[1:]):
            out[name] = (t1 - t0) * 1e3 if host or not self.cuda else e0.elapsed_time(e1)
        return out


def _answered_window(est, epoch):
    """The map window the step's batch was answered on, as the estimator
    cached it in the step's map epoch: its query crop (maps over 4M cells)
    or else the whole map. Its first cell ``window`` (i, j, rows, cols), its
    centre ``position`` and the layers ``elevation``, ``traversability``,
    ``traversability_slope``, ``traversability_step``,
    ``traversable_mask`` there, on the host."""
    crops = [k for k in epoch.fields if k[0] == "crop"]
    if crops:
        (key,) = crops  # one batch a step, so one crop a map epoch
        i0, j0, h, w = key[3:]
        pos = epoch.fields[key][0].position
    else:
        (h, w), i0, j0, pos = epoch.state.shape, 0, 0, epoch.state.position
    gmap = est.traversability_map
    names = ("elevation", "traversability", "traversability_slope", "traversability_step",
             "traversable_mask")
    return {"window": (i0, j0, h, w), "position": pos.cpu().numpy(),
            "layers": {k: gmap[k][i0 : i0 + h, j0 : j0 + w].cpu().numpy() for k in names}}


def run_query_cropped(args, est, src, robot, dev, record=None):
    """The default mode: host-generated rollouts through the estimator."""
    from traversability_estimation_tpu_torch.ops import footprint as fp_ops

    rng = np.random.default_rng(0)
    P, N = args.rollouts, args.poses
    cuda = dev.type == "cuda"
    offset = est.config.footprint.circular_footprint_offset
    stage_names = ("update", "gen", "upload", "field", "query", "fetch")
    stage_t = {k: [] for k in stage_names}
    budgets = []
    for step in range(args.steps):
        t_step = time.perf_counter()
        st = _Stages(cuda)
        st.mark()
        # refresh a 6 m window around the robot (sensor update)
        patch, _ = src.sample(tuple(robot), (6.0, 6.0))
        est.update_with_submap(patch, tuple(robot), sync=False)
        st.mark("update")
        poses = rollout_batch(rng, robot, P, N)
        n_poses = np.full((P,), N, np.int32)
        st.mark("gen", host=True)
        epoch = est._current_epoch()
        if args.stages:
            # check_circular_paths_batch's work, one stage at a time
            max_cells = est._max_segment_cells(poses, n_poses)
            poses_d = torch.as_tensor(poses, device=dev)
            n_d = torch.as_tensor(n_poses, device=dev)
            st.mark("upload")
            state, field = est._cropped_state_and_field(epoch, poses, RADIUS, offset)
            st.mark("field")
            safe_d, trav_d = fp_ops.check_circular_paths(
                state, poses_d, n_d, RADIUS, offset, max_cells, field, False)
            st.mark("query")
        else:
            safe_d, trav_d = est.check_circular_paths_batch(poses, n_poses, RADIUS)
        safe, trav = safe_d.cpu().numpy(), trav_d.cpu().numpy()
        st.mark("fetch")
        budgets.append(time.perf_counter() - t_step)
        spans = st.spans_ms()
        for k in stage_names:
            if k in spans:
                stage_t[k].append(spans[k])
        if record is not None:
            record.append({"step": step, "robot": robot.copy(), "poses": poses, "safe": safe,
                           "trav": trav, "max_cells": est._max_segment_cells(poses, n_poses),
                           **_answered_window(est, epoch)})
        best = int(np.argmax(np.where(safe, trav, -1.0)))
        msg = (f"step {step}: {budgets[-1] * 1e3:7.1f} ms budget | safe {safe.sum():>6}/{P} "
               f"| best trav {trav[best]:.3f}")
        if args.stages:
            msg += " | " + " ".join(f"{k} {spans[k]:.2f}" for k in stage_names)
        log(msg)
        if safe[best]:
            robot = poses[best, min(3, N - 1), :].astype(np.float64)
    steady = _steady(budgets)
    print(f"replanning budget p50: {steady * 1e3:.1f} ms -> "
          f"{P * N / steady / 1e6:.1f}M pose-checks/s sustained")
    blob = {
        "kind": "rollouts",
        "device": args.device_name,
        "map_cells": list(est.query_state.shape),
        "rollouts": P,
        "poses": N,
        "steps": args.steps,
        "budget_p50_ms": round(steady * 1e3, 3),
        "pose_checks_per_s": round(P * N / steady, 1),
    }
    if args.stages:
        blob["stage_p50_ms"] = {
            k: round(float(np.median(v[1:] if len(v) > 1 else v)), 4) for k, v in stage_t.items()
        }
    return _write(args, blob)


def run_device_gen(args, est, src, robot, dev, record=None):
    """``--device-gen``: rollouts generated and scored on the device; the
    host fetches the best rollout and the counts (one small copy a step)."""
    from traversability_estimation_tpu_torch.ops import footprint as fp_ops

    P, N = args.rollouts, args.poses
    offset = est.config.footprint.circular_footprint_offset
    reach = (0.25 + 0.08) * (N - 1) + 0.1
    n_poses = torch.full((P,), N, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev)
    budgets = []
    for step in range(args.steps):
        t_step = time.perf_counter()
        patch, _ = src.sample(tuple(robot), (6.0, 6.0))
        est.update_with_submap(patch, tuple(robot), sync=False)
        corners = np.array([[robot[0] - reach, robot[1] - reach],
                            [robot[0] + reach, robot[1] + reach]], np.float32)
        state, field = est._cropped_state_and_field(est._current_epoch(), corners, RADIUS, offset)
        poses = device_rollouts(gen, step, robot, P, N, dev)
        safe, trav = fp_ops.check_circular_paths(
            state, poses, n_poses, RADIUS, offset, MAX_SEGMENT_CELLS, field, False)
        best_pose, best_safe, best_trav, n_safe = _best_rollout(poses, safe, trav)
        budgets.append(time.perf_counter() - t_step)
        if record is not None:
            record.append({"step": step, "robot": robot.copy(), "n_safe": n_safe,
                           "best_trav": best_trav})
        log(f"step {step}: {budgets[-1] * 1e3:7.1f} ms | safe {n_safe:>6}/{P} "
            f"| best {best_trav:.3f}")
        if best_safe:
            robot = best_pose
    steady = _steady(budgets)
    print(f"device-gen replanning budget p50: {steady * 1e3:.1f} ms -> "
          f"{P * N / steady / 1e6:.1f}M pose-checks/s sustained")
    return _write(args, {
        "kind": "rollouts_device_gen",
        "device": args.device_name,
        "map_cells": list(est.query_state.shape),
        "rollouts": P,
        "poses": N,
        "steps": args.steps,
        "budget_p50_ms": round(steady * 1e3, 3),
        "pose_checks_per_s": round(P * N / steady, 1),
    })


def run_tiled(args, elev, res, dev, record=None):
    """``--tiled``: the map tiled over the process group (world size 1 when
    run alone), never replicated: halo-exchanged update, tiled field,
    rollout verdicts summed over the ranks; with ``--device-gen`` each step
    is one ``sharded_online_tick`` on rollouts generated on the device (the
    same seed on every rank gives every rank the same rollouts)."""
    import torch.distributed as dist

    from traversability_estimation_tpu_torch.ops import footprint as fp_ops
    from traversability_estimation_tpu_torch.ops.filters import ChainConfig
    from traversability_estimation_tpu_torch.ops.veto import VetoConfig
    from traversability_estimation_tpu_torch.parallel import multihost
    from traversability_estimation_tpu_torch.parallel import sharding as sh
    from traversability_estimation_tpu_torch.utils.sources import SyntheticTerrainSource

    if "MASTER_ADDR" in os.environ:  # under torchrun
        grid = multihost.initialize_multihost(device=dev)
    else:
        grid = multihost.initialize_multihost(f"localhost:{_free_port()}", 1, 0, device=dev)
    dev = grid.device
    rank0 = grid.rank == 0
    ccfg = ChainConfig(resolution=res)
    vcfg = VetoConfig(resolution=res, check_roughness=False)
    radius, offset = RADIUS, 0.15
    if rank0:
        log(f"tiled mode: grid {grid.gx}x{grid.gy} over {dist.get_backend()}")
    padded, orig = sh.pad_to_mesh(elev, grid)
    tile = torch.as_tensor(np.ascontiguousarray(sh.tile_of(padded, grid)), device=dev)
    t0 = time.perf_counter()
    layers = sh.sharded_update(tile, ccfg, vcfg, grid, orig_shape=orig)
    field = sh.sharded_circle_field(layers, grid, radius + offset, radius, res, 0.5,
                                    orig_shape=orig)
    ok_host = sh.gather_tiles(field[0], grid).cpu().numpy()[: orig[0], : orig[1]]
    if rank0:
        log(f"sharded update + field: {time.perf_counter() - t0:.2f}s (first use included)")
    robot = nearest_traversable(ok_host, res)
    if robot is None:
        log("no traversable cell on the map")
        dist.destroy_process_group()
        return None
    P, N = args.rollouts, args.poses
    budgets = []
    if args.device_gen:
        src = SyntheticTerrainSource(resolution=res)
        half = np.array(orig) * res / 2.0
        th, tw = tile.shape
        n_d = torch.full((P,), N, dtype=torch.int32, device=dev)
        gen = torch.Generator(device=dev)
        for step in range(args.steps):
            t_step = time.perf_counter()
            patch, _ = src.sample(tuple(robot), (6.0, 6.0))
            ph, pw = patch.shape
            i0 = int(np.floor((half[0] - (robot[0] + ph * res / 2)) / res))
            j0 = int(np.floor((half[1] - (robot[1] + pw * res / 2)) / res))
            i0, j0 = max(0, min(i0, orig[0] - ph)), max(0, min(j0, orig[1] - pw))
            poses = device_rollouts(gen, step, robot, P, N, dev)
            tile, _, safe, trav = sh.sharded_online_tick(
                tile, patch, (i0, j0), poses, n_d, grid=grid, chain_cfg=ccfg, veto_cfg=vcfg,
                radius=radius, offset=offset, resolution=res,
                max_segment_cells=MAX_SEGMENT_CELLS, orig_shape=orig)
            best_pose, best_safe, best_trav, n_safe = _best_rollout(poses, safe, trav)
            budgets.append(time.perf_counter() - t_step)
            if rank0:
                log(f"step {step}: {budgets[-1] * 1e3:7.1f} ms | safe {n_safe:>6}/{P} "
                    f"| best {best_trav:.3f}")
            if best_safe:
                robot = best_pose
        kind = "rollouts_tiled_device_gen"
    else:
        rng = np.random.default_rng(0)
        window = fp_ops.polygon_window_cells(FOOTPRINT, 0.3, res, False)
        K = min(1024, P)
        quats = np.zeros((K, N, 4), np.float32)
        quats[..., 3] = 1.0
        quats_d = torch.as_tensor(quats, device=dev)
        n_poses = np.full((P,), N, np.int32)
        n_d = torch.as_tensor(n_poses, device=dev)
        for step in range(args.steps):
            t_step = time.perf_counter()
            poses = rollout_batch(rng, robot, P, N)
            poses_d = torch.as_tensor(poses, device=dev)
            safe_d, trav_d = sh.check_circular_paths_tiled(
                field[0], field[1], poses_d, n_d, grid, (0.0, 0.0), res, MAX_SEGMENT_CELLS,
                orig_shape=orig)
            # polygonal verdicts of the first K rollouts, exact over the ranks
            pos3 = torch.cat([poses_d[:K], torch.zeros((K, N, 1), device=dev)], -1)
            safe_p, _, _ = sh.check_polygonal_paths_tiled(
                layers, pos3, quats_d, n_d[:K], FOOTPRINT, grid, window, (0.0, 0.0), res,
                False, 0.5, orig_shape=orig)
            safe, trav = safe_d.cpu().numpy(), trav_d.cpu().numpy()
            n_safe_p = int(safe_p.sum())
            budgets.append(time.perf_counter() - t_step)
            if record is not None:
                record.append({"step": step, "robot": robot.copy(), "poses": poses,
                               "safe": safe, "trav": trav, "poly_safe": safe_p.cpu().numpy()})
            best = int(np.argmax(np.where(safe, trav, -1.0)))
            if rank0:
                log(f"step {step}: {budgets[-1] * 1e3:7.1f} ms | circ safe {safe.sum():>6}/{P} "
                    f"| poly safe {n_safe_p:>5}/{K} | best {trav[best]:.3f}")
            if safe[best]:
                robot = poses[best, min(3, N - 1), :].astype(np.float64)
        kind = "rollouts_tiled"
    steady = _steady(budgets)
    blob = {
        "kind": kind,
        "device": args.device_name,
        "backend": dist.get_backend(),
        "grid": [grid.gx, grid.gy],
        "map_cells": list(orig),
        "rollouts": P,
        "poses": N,
        "steps": args.steps,
        "budget_p50_ms": round(steady * 1e3, 3),
        "pose_checks_per_s": round(P * N / steady, 1),
    }
    if rank0:
        print(f"tiled replanning budget p50: {steady * 1e3:.1f} ms -> "
              f"{P * N / steady / 1e6:.1f}M pose-checks/s")
        _write(args, blob)
    dist.destroy_process_group()
    return blob


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--map-m", type=float, default=200.0)
    ap.add_argument("--res", type=float, default=0.03)
    ap.add_argument("--rollouts", type=int, default=100_000)
    ap.add_argument("--poses", type=int, default=12)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="cuda (default; fails without a card) or cpu (the plain PyTorch versions; "
        "plumbing only, its times are the CPU's)")
    ap.add_argument(
        "--device-gen", action="store_true",
        help="generate the rollouts on the device (torch.Generator seeded with the step) and "
        "fetch only the best rollout and the counts")
    ap.add_argument(
        "--stages", action="store_true",
        help="split each host-generated step into gen / upload / update / field / query / "
        "fetch, timed by CUDA events (written to the JSON row)")
    ap.add_argument(
        "--tiled", action="store_true",
        help="keep the map tiled over the processes of parallel/sharding.py and sum the "
        "rollout verdicts over them. Alone: a world of one process. Under torchrun "
        "--nproc-per-node N: N processes, one tile each (nccl, one GPU each; with "
        "--device cpu, CPU processes over gloo)")
    ap.add_argument("--json", default="", help="append a result JSON line here")
    return ap


def main(argv=None, record=None):
    """Run the rollouts; returns the JSON row (None when no start was
    found). `record`, when a dict, receives ``steps``: one dict per step
    (the robot, and in the host-generated modes the rollouts, their verdicts
    and the map window they were answered on); outside ``--tiled`` also
    ``estimator`` and ``start``: the start check's 256 ``candidates``
    (256, 1, 2), their verdicts ``ok`` and ``trav`` and its whole-map query
    ``state`` and circle ``field`` (device tensors)."""
    args = parser().parse_args(argv)
    steps = None
    if record is not None:
        steps = record["steps"] = []

    from traversability_estimation_tpu_torch.device import resolve_device
    from traversability_estimation_tpu_torch.models.estimator import TraversabilityEstimator
    from traversability_estimation_tpu_torch.utils.config import EstimatorConfig
    from traversability_estimation_tpu_torch.utils.sources import SyntheticTerrainSource

    dev = resolve_device(args.device)
    args.device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    res = args.res
    n = int(round(args.map_m / res))
    log(f"map {n}x{n} = {n * n / 1e6:.0f}M cells, {args.rollouts} rollouts x {args.poses} "
        f"poses, device={args.device_name}")
    src = SyntheticTerrainSource(resolution=res)
    elev = initial_map(src, n, args.map_m, res)
    if args.tiled:
        return run_tiled(args, elev, res, dev, steps)

    est = TraversabilityEstimator(EstimatorConfig(resolution=res), device=dev)
    t0 = time.perf_counter()
    est.update(elev)
    log(f"initial full-map update: {time.perf_counter() - t0:.2f}s "
        f"(its kernel and synchronise {est.last_update_seconds * 1e3:.1f} ms)")
    del elev
    rng = np.random.default_rng(0)
    # a traversable start: single-pose circle checks over 256 candidates
    # within 20 m of the centre (0.4 of the map's side on maps under 50 m)
    span = min(20.0, 0.4 * args.map_m)
    cand = np.stack([rng.uniform(-span, span, 256), rng.uniform(-span, span, 256)], -1).astype(
        np.float32)[:, None, :]
    ok, trav = est.check_circular_paths_batch(cand, np.ones(256, np.int32), RADIUS, crop=False)
    ok = ok.cpu().numpy()
    if record is not None:
        epoch = est._current_epoch()
        offset = est.config.footprint.circular_footprint_offset
        record.update(estimator=est, start={
            "candidates": cand, "ok": ok, "trav": trav.cpu().numpy(), "state": epoch.state,
            "field": est._circle_field(RADIUS, offset, epoch)})
    if not ok.any():
        log("no traversable start found")
        return None
    robot = cand[int(np.argmax(ok)), 0].astype(np.float64)
    log(f"start at {robot}")
    if args.device_gen:
        return run_device_gen(args, est, src, robot, dev, steps)
    return run_query_cropped(args, est, src, robot, dev, steps)


if __name__ == "__main__":
    main()
