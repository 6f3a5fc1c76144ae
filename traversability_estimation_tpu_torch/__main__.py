"""Command line: the counterpart of roslaunch / rosrun.

  python -m traversability_estimation_tpu_torch run --map <file.bag|.npz> [...]
      one end-to-end update: load elevation, run the chain, print layer
      statistics, optionally dump PNG visualisations and save a checkpoint.

  python -m traversability_estimation_tpu_torch serve [--port N] [--map ...]
      start the node (a periodic timer if the rate is > 0) and the JSON-lines
      TCP service front end: the traversability_estimation.launch
      counterpart.

Both accept --config-dir pointing at reference-format YAML files (robot.yaml,
robot_filter_parameter.yaml, robot_footprint_parameter.yaml; needs PyYAML),
defaulting to built-in reference-equivalent parameters, and --device (``cuda``
by default: without a CUDA device the command fails; ``--device cpu`` runs
the plain PyTorch versions).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np


def _build_config(args):
    from traversability_estimation_tpu_torch.utils.config import EstimatorConfig, load_config

    if args.config_dir:
        d = args.config_dir
        return load_config(
            robot_yaml=_maybe(os.path.join(d, "robot.yaml")),
            filter_yaml=_maybe(os.path.join(d, "robot_filter_parameter.yaml")),
            footprint_yaml=_maybe(os.path.join(d, "robot_footprint_parameter.yaml")),
            resolution=args.res,
        )
    return EstimatorConfig(resolution=args.res)


def _maybe(path):
    return path if os.path.exists(path) else None


def cmd_run(args) -> int:
    from traversability_estimation_tpu_torch.models.estimator import (
        FootprintPath,
        TraversabilityEstimator,
    )

    est = TraversabilityEstimator(_build_config(args), device=args.device)
    t0 = time.perf_counter()
    if args.map:
        if not est.load_elevation_map(args.map):
            print(f"failed to load {args.map}", file=sys.stderr)
            return 1
    else:
        # demo terrain (no --map): rolling ground with a step edge and holes
        rng = np.random.default_rng(0)
        x = np.arange(128)[:, None] * args.res
        y = np.arange(128)[None, :] * args.res
        z = (
            0.15 * np.sin(2.0 * x) * np.cos(1.5 * y)
            + 0.05 * rng.standard_normal((128, 128))
            + 0.3 * ((x > x.mean()) & (y > y.mean()))
        )
        z[rng.random((128, 128)) < 0.02] = np.nan
        est.update(z.astype(np.float32))
    print(f"update: {time.perf_counter() - t0:.2f}s on {est.device} (incl. the kernels' build)")
    gm = est.traversability_map
    rows, cols = gm.size
    print(f"map {rows}x{cols} @ {gm.resolution} m, layers: {sorted(gm.layers)}")
    host = {name: gm.layers[name].cpu().numpy() for name in sorted(gm.layers)}
    for name, arr in host.items():
        if arr.dtype == np.bool_:
            print(f"  {name:28s} true: {arr.mean():.3f}")
        else:
            finite = np.isfinite(arr)
            mean = float(arr[finite].mean()) if finite.any() else float("nan")
            print(f"  {name:28s} mean: {mean: .4f}  valid: {finite.mean():.3f}")
    if args.check:
        poses = np.asarray([[float(v) for v in p.split(",")] for p in args.check], np.float32)
        r = est.check_footprint_path([FootprintPath(poses=poses, radius=args.radius)])[0]
        print(
            f"path check ({len(poses)} poses, r={args.radius}): "
            f"safe={r.is_safe} traversability={r.traversability:.4f}"
        )
    if args.dump_png:
        from traversability_estimation_tpu_torch.utils.viz import dump_layers

        paths = dump_layers(
            {k: v for k, v in host.items() if v.dtype != np.bool_}, args.dump_png
        )
        print(f"wrote {len(paths)} PNGs to {args.dump_png}")
    if args.save:
        est.save(args.save)
        print(f"saved checkpoint to {args.save}")
    return 0


def cmd_serve(args) -> int:
    from traversability_estimation_tpu_torch.node import TraversabilityNode
    from traversability_estimation_tpu_torch.service import TraversabilityServer
    from traversability_estimation_tpu_torch.utils.sources import SyntheticTerrainSource

    cfg = _build_config(args)
    if args.rate is not None:
        cfg = dataclasses.replace(cfg, min_update_rate=args.rate)
    source = SyntheticTerrainSource(resolution=cfg.resolution) if args.synthetic else None
    node = TraversabilityNode(cfg, source=source, device=args.device)
    if args.map and not node.load_elevation_map(args.map):
        print(f"failed to load initial map {args.map}", file=sys.stderr)
        return 1
    node.start()
    with TraversabilityServer(node, args.host, args.port) as srv:
        host, port = srv.address
        print(
            f"serving on {host}:{port} (rate {cfg.min_update_rate} Hz, "
            f"device {node.estimator.device})",
            flush=True,
        )
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            node.stop()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="traversability_estimation_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="one end-to-end update from a map file")
    run.add_argument("--map", help=".bag or .npz elevation map")
    run.add_argument("--res", type=float, default=0.03)
    run.add_argument("--config-dir", help="directory of reference-format YAMLs")
    run.add_argument("--check", nargs="*", default=[],
                     metavar="X,Y", help="path poses to check, e.g. 0,0 0.5,0.2")
    run.add_argument("--radius", type=float, default=0.3)
    run.add_argument("--dump-png", help="directory for PNG layer dumps")
    run.add_argument("--save", help="write .bag/.npz checkpoint after update")
    run.set_defaults(fn=cmd_run)

    serve = sub.add_parser("serve", help="node + TCP service front end")
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument("--port", type=int, default=7334)
    serve.add_argument("--map", help="initial map file")
    serve.add_argument("--res", type=float, default=0.03)
    serve.add_argument("--rate", type=float, help="override min_update_rate")
    serve.add_argument("--config-dir")
    serve.add_argument("--synthetic", action="store_true",
                       help="attach a synthetic elevation source")
    serve.set_defaults(fn=cmd_serve)

    for p in (run, serve):
        p.add_argument("--device", default="cuda",
                       help="cuda (default; fails without a CUDA device) or cpu")

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
