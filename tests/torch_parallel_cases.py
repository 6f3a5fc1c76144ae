"""Worker side of the port's multi-process CPU tests (gloo).

``spawn_world`` starts `n` processes of this file; each joins a gloo group,
builds the process grid, runs the named cases of ``CASES`` on the inputs the
test wrote to an ``.npz`` file and, on rank 0, writes each case's results to
``<out>/<case>.npz`` (an exception as the array ``error``). Results are
replicated on every rank or gathered from the tiles first, so rank 0 holds
all of them. This file imports torch and the port only, never JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
RES = 0.03


def terrain(rows, cols, seed, nan_frac, noise):
    """tests/conftest.py's synthetic terrain with the noise as a parameter:
    at 0.05 (conftest's) nearly every circle of the path queries' radius
    fails; at 0.02 most pass."""
    rng = np.random.default_rng(seed)
    x = np.arange(rows)[:, None] * RES
    y = np.arange(cols)[None, :] * RES
    z = (
        0.15 * np.sin(2.0 * x) * np.cos(1.5 * y)
        + noise * rng.standard_normal((rows, cols))
        + 0.3 * ((x > x.mean()) & (y > y.mean()))
        + 0.1 * x
    )
    z[rng.random((rows, cols)) < nan_frac] = np.nan
    return z.astype(np.float32)


def plain_layers(elev, check_roughness=False):
    """The port's whole-map update (plain version) as numpy planes."""
    import torch

    from traversability_estimation_tpu_torch.ops import update_kernel

    chain, veto = _configs(check_roughness)
    layers = update_kernel.fused_update_plain(torch.from_numpy(elev.copy()), chain, veto)
    return {k: v.numpy() for k, v in layers.items()}


def walks(rng, P, N, H, W, scale=1.0, step=0.15):
    """Random-walk paths (P, N, 2) f32 over an H x W map centred at 0."""
    ex, ey = scale * H * RES / 2, scale * W * RES / 2
    starts = np.stack([rng.uniform(-ex, ex, P), rng.uniform(-ey, ey, P)], -1)
    steps = rng.uniform(-step, step, (P, N - 1, 2))
    return np.concatenate([starts[:, None], starts[:, None] + np.cumsum(steps, 1)], 1).astype(
        np.float32)


def sharding_inputs():
    """The tiled update's and circle field's inputs (test_torch_sharding.py)."""
    q_layers = plain_layers(terrain(60, 120, seed=6, nan_frac=0.03, noise=0.02))
    rng = np.random.default_rng(5)
    return {
        "halo_plane": np.arange(24 * 48, dtype=np.float32).reshape(24, 48),
        "update_elev": terrain(96, 96, seed=31, nan_frac=0.1, noise=0.05),
        "odd_elev": terrain(50, 67, seed=32, nan_frac=0.1, noise=0.05),
        "q_trav": q_layers["traversability"],
        "q_mask": q_layers["traversable_mask"],
        "radii": np.array([0.12 + 0.06, 0.12]),  # tests/test_tiled_queries.py's
        "poses": rng.uniform(-1, 1, (16, 3, 2)).astype(np.float32),
    }


TILED_SHAPE = (60, 120)


def tiled_inputs():
    """The tiled queries' and the sharded tick's inputs
    (test_torch_tiled_queries.py), on a 60 x 120 map."""
    from traversability_estimation_tpu_torch.ops.footprint import polygon_window_cells

    H, W = TILED_SHAPE
    layers = plain_layers(terrain(H, W, seed=6, nan_frac=0.03, noise=0.02))
    inp = {"q_trav": layers["traversability"], "q_mask": layers["traversable_mask"]}
    rng = np.random.default_rng(11)
    inp["paths_poses"] = walks(rng, 64, 6, H, W)
    inp["paths_n"] = rng.integers(2, 7, 64).astype(np.int32)
    inp["far_poses"] = np.float32([[[100.0, 100.0], [100.1, 100.0]]])
    inp["far_n"] = np.int32([2])
    rng = np.random.default_rng(3)
    centres = rng.uniform(-0.3, 0.3, (16, 2)).astype(np.float32)
    inp["single_poses"] = np.stack([centres, centres], 1)
    inp["single_n"] = np.ones(16, np.int32)
    rng = np.random.default_rng(13)
    inp["raster_poses"] = walks(rng, 256, 9, H, W)
    inp["raster_n"] = np.maximum(rng.integers(1, 10, 256), 2).astype(np.int32)
    rng = np.random.default_rng(29)
    inp["reduce_poses"] = walks(rng, 512, 9, H, W, scale=1.3)  # some paths leave the map
    inp["reduce_n"] = rng.integers(2, 10, 512).astype(np.int32)
    inp["reduce1_poses"] = inp["reduce_poses"]
    inp["reduce1_n"] = np.ones(512, np.int32)

    # the shapes of tests/test_tiled_queries.py's polygonal batch
    rng = np.random.default_rng(31)
    fp = np.float32([[0.12, 0.08], [0.12, -0.08], [-0.12, -0.08], [-0.12, 0.08]])
    P, N = 32, 5
    pos2 = walks(rng, P, N, H, W, step=0.12)
    yaw = rng.uniform(0, 2 * np.pi, (P, N))
    quats = np.zeros((P, N, 4), np.float32)
    quats[..., 2], quats[..., 3] = np.sin(yaw / 2), np.cos(yaw / 2)
    inp.update(
        poly_fp=fp, poly_pos=np.concatenate([pos2, np.zeros((P, N, 1), np.float32)], -1),
        poly_quat=quats, poly_n=rng.integers(1, N + 1, P).astype(np.int32),
        poly_window=np.array([polygon_window_cells(fp, 0.25, RES, False)] * 2),
        poly_window_c=np.array([polygon_window_cells(fp, 0.25, RES, True)] * 2),
    )

    rng = np.random.default_rng(21)
    inp["tick_elev"] = terrain(H, W, seed=13, nan_frac=0.03, noise=0.02)
    inp["tick_patch"] = (0.2 + 0.02 * rng.standard_normal((24, 24))).astype(np.float32)
    inp["tick_start"] = np.array([31, 57])  # straddles tile borders of every grid
    inp["tick_bad_start"] = np.array([50, 110])
    inp["tick_poses"] = walks(rng, 32, 5, H, W, step=0.12)
    inp["tick_n"] = rng.integers(2, 6, 32).astype(np.int32)
    return inp


def start_worlds(d, worlds, cases, inputs, timeout, init=None):
    """Write `inputs` to directory `d` and start every world of `worlds`
    (numbers of processes) at once, each running `cases`. Returns
    (result(n, case), which waits for world n first; stop(), which kills
    what still runs). `init(n)`: the rendezvous (a file store in `d` by
    default)."""
    np.savez(d / "inputs.npz", **inputs)
    procs = {n: spawn_world(n, cases, d / "inputs.npz", d / f"w{n}",
                            init(n) if init else f"file://{d}/store{n}") for n in worlds}
    waited = set()

    def result(n, case):
        if n not in waited:
            wait_world(procs[n], timeout)
            waited.add(n)
        return load_result(d / f"w{n}", case)

    def stop():
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()

    return result, stop


def spawn_world(n, cases, inputs_path, out_dir, init):
    """Start the n ranks of one world; returns their processes. `init`: a
    ``file://`` rendezvous, or ``tcp://host:port`` (``initialize_multihost``
    with explicit arguments) or ``env://host:port`` (the same from a
    torchrun-style environment), all over gloo on the CPU; or
    ``nccl://host:port``: one process per GPU over nccl."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["OMP_NUM_THREADS"] = "1"
    os.makedirs(out_dir, exist_ok=True)
    return [
        subprocess.Popen(
            [sys.executable, __file__, str(rank), str(n), init, str(inputs_path), str(out_dir),
             ",".join(cases)],
            env=env, cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(n)
    ]


def wait_world(procs, timeout):
    """Wait for every rank (killing all of them past `timeout` seconds);
    returns the ranks' outputs. Raises when a rank failed."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {rank} exited {p.returncode}:\n{out[-3000:]}")
    return outs


def load_result(out_dir, case):
    """One case's results; raises the worker's error."""
    with np.load(Path(out_dir) / f"{case}.npz") as f:
        res = {k: f[k] for k in f.files}
    if "error" in res:
        raise AssertionError(f"case {case} failed in the worker:\n{res['error']}")
    return res


# ---------------------------------------------------------------------------
# cases: case(grid, inputs) -> {name: numpy array}
# ---------------------------------------------------------------------------


def _np(t):
    return t.detach().cpu().numpy()


def _configs(check_roughness):
    from traversability_estimation_tpu_torch.ops.filters import ChainConfig
    from traversability_estimation_tpu_torch.ops.veto import VetoConfig

    return ChainConfig(resolution=RES), VetoConfig(resolution=RES, check_roughness=check_roughness)


def case_grid(grid, inp):
    return {"shape": np.array([grid.gx, grid.gy])}


def case_halo(grid, inp):
    """Two channels of unique values, halo 3, fills -1 and -2: every
    padded tile, gathered."""
    import torch

    from traversability_estimation_tpu_torch.parallel import sharding as sh

    plane = torch.from_numpy(inp["halo_plane"])
    tile = sh.tile_of(torch.stack([plane, -plane]), grid)
    padded = sh.halo_pad(tile.contiguous(), 3, (-1.0, -2.0), grid)
    return {"padded": _np(sh.gather_tiles(padded, grid))}


def _update(grid, elev, check_roughness, orig_shape=None):
    from traversability_estimation_tpu_torch.parallel import sharding as sh

    chain, veto = _configs(check_roughness)
    layers = sh.sharded_update(sh.tile_of(elev, grid), chain, veto, grid, orig_shape=orig_shape)
    return {k: _np(sh.gather_tiles(v, grid)) for k, v in layers.items()}


def case_update(grid, inp):
    return _update(grid, inp["update_elev"], True)


def case_update_padded(grid, inp):
    from traversability_estimation_tpu_torch.parallel import sharding as sh

    padded, orig = sh.pad_to_mesh(inp["odd_elev"], grid)
    out = _update(grid, padded, False, orig)
    return {k: v[: orig[0], : orig[1]] for k, v in out.items()}


def _layer_tiles(grid, inp):
    from traversability_estimation_tpu_torch.parallel import sharding as sh

    return {
        "traversability": sh.tile_of(inp["q_trav"], grid),
        "traversable_mask": sh.tile_of(inp["q_mask"], grid),
    }


def case_field(grid, inp):
    from traversability_estimation_tpu_torch.parallel import sharding as sh

    rmax, rmin = (float(v) for v in inp["radii"])
    ok, tv = sh.sharded_circle_field(_layer_tiles(grid, inp), grid, rmax, rmin, RES, 0.5)
    return {"ok": _np(sh.gather_tiles(ok, grid)), "trav": _np(sh.gather_tiles(tv, grid))}


def case_scatter(grid, inp):
    from traversability_estimation_tpu_torch.parallel import sharding as sh

    first = grid.rank == 0
    f = sh.scatter_tiles(inp["q_trav"] if first else None, grid)
    b = sh.scatter_tiles(inp["q_mask"] if first else None, grid)
    return {"trav": _np(sh.gather_tiles(f, grid)), "mask": _np(sh.gather_tiles(b, grid)),
            "tile_shape": np.array(f.shape)}


def case_replicate(grid, inp):
    import torch
    import torch.distributed as dist

    from traversability_estimation_tpu_torch.parallel import sharding as sh

    padded, orig = sh.pad_to_mesh(inp["odd_elev"], grid)
    chain, veto = _configs(False)
    layers = sh.sharded_update(sh.tile_of(padded, grid), chain, veto, grid, orig_shape=orig)
    state = sh.replicate_query_state(layers, grid, (0.1, -0.2), RES, 0.5, orig)
    mine = sh.shard_pose_batch(inp["poses"], grid)
    parts = [torch.empty_like(mine) for _ in range(grid.size)]
    dist.all_gather(parts, mine.contiguous())
    return {"trav": _np(state.traversability), "mask": _np(state.traversable_mask),
            "position": _np(state.position), "poses": _np(torch.cat(parts))}


def _field_tiles(grid, inp):
    from traversability_estimation_tpu_torch.parallel import sharding as sh

    return sh.sharded_circle_field(_layer_tiles(grid, inp), grid, 0.18, 0.12, RES, 0.5)


def _circular(grid, inp, prefix, max_cells, reduce_from=None):
    from traversability_estimation_tpu_torch.parallel import sharding as sh

    ok, tv = _field_tiles(grid, inp)
    saved = sh._PATH_REDUCE_SAMPLES
    if reduce_from is not None:
        sh._PATH_REDUCE_SAMPLES = reduce_from
    try:
        safe, trav = sh.check_circular_paths_tiled(
            ok, tv, inp[f"{prefix}_poses"], inp[f"{prefix}_n"], grid, (0.0, 0.0), RES, max_cells)
    finally:
        sh._PATH_REDUCE_SAMPLES = saved
    return {"safe": _np(safe), "trav": _np(trav)}


def case_paths(grid, inp):
    return _circular(grid, inp, "paths", 64)


def case_paths_offmap(grid, inp):
    return _circular(grid, inp, "far", 16)


def case_paths_single(grid, inp):
    return _circular(grid, inp, "single", 16)


def case_paths_raster(grid, inp):
    return _circular(grid, inp, "raster", 128)


def case_paths_reduce(grid, inp):
    out = _circular(grid, inp, "reduce", 128, reduce_from=1)
    single = _circular(grid, inp, "reduce1", 128, reduce_from=1)
    return {**out, "safe1": single["safe"], "trav1": single["trav"]}


def _polygonal(grid, inp, conservative, reduce_from=None):
    from traversability_estimation_tpu_torch.parallel import sharding as sh

    saved = sh._PATH_REDUCE_SAMPLES
    if reduce_from is not None:
        sh._PATH_REDUCE_SAMPLES = reduce_from
    key = "poly_window_c" if conservative else "poly_window"
    try:
        out = sh.check_polygonal_paths_tiled(
            _layer_tiles(grid, inp), inp["poly_pos"], inp["poly_quat"], inp["poly_n"],
            inp["poly_fp"], grid, tuple(int(v) for v in inp[key]), (0.0, 0.0), RES,
            conservative, 0.5)
    finally:
        sh._PATH_REDUCE_SAMPLES = saved
    return dict(zip(("safe", "trav", "area"), (_np(t) for t in out)))


def case_polygonal(grid, inp):
    a = _polygonal(grid, inp, False)
    b = _polygonal(grid, inp, True)
    return {**a, **{f"{k}_c": v for k, v in b.items()}}


def case_polygonal_reduce(grid, inp):
    return _polygonal(grid, inp, False, reduce_from=1)


def _tick(grid, inp, start):
    from traversability_estimation_tpu_torch.parallel import sharding as sh

    chain, veto = _configs(False)
    elev, layers, safe, trav = sh.sharded_online_tick(
        sh.tile_of(inp["tick_elev"], grid), inp["tick_patch"], start,
        inp["tick_poses"], inp["tick_n"], grid=grid, chain_cfg=chain, veto_cfg=veto,
        radius=0.12, offset=0.06, resolution=RES, max_segment_cells=64)
    out = {k: _np(sh.gather_tiles(v, grid)) for k, v in layers.items()}
    out.update(elevation=_np(sh.gather_tiles(elev, grid)), safe=_np(safe), trav=_np(trav))
    return out


def case_tick(grid, inp):
    return _tick(grid, inp, tuple(int(v) for v in inp["tick_start"]))


def case_tick_out_of_range(grid, inp):
    try:
        _tick(grid, inp, tuple(int(v) for v in inp["tick_bad_start"]))
    except ValueError as e:
        return {"raised": np.array(str(e))}
    return {"raised": np.array("")}


def case_multihost_update(grid, inp):
    return _update(grid, inp["mh_elev"], False)


def case_multihost_mismatch(grid, inp):
    """initialize_multihost on a group that is up, asking for another size."""
    from traversability_estimation_tpu_torch.parallel import multihost

    try:
        multihost.initialize_multihost(num_processes=grid.size + 1, device="cpu")
    except RuntimeError as e:
        return {"raised": np.array(str(e))}
    return {"raised": np.array("")}


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


def main(argv):
    rank, n, init, inputs_path, out_dir, names = argv
    rank, n = int(rank), int(n)
    import torch

    torch.set_num_threads(1)
    from traversability_estimation_tpu_torch.parallel import multihost

    with np.load(inputs_path) as f:
        inp = {k: f[k] for k in f.files}
    if init.startswith("nccl://"):
        # one process per GPU, as on a multi-GPU host
        grid = multihost.initialize_multihost(init[len("nccl://"):], n, rank)
    elif init.startswith("tcp://"):
        # the multihost entry point, as a user starts it
        grid = multihost.initialize_multihost(init[len("tcp://"):], n, rank, device="cpu")
    elif init.startswith("env://"):
        # the same from the environment torchrun sets
        host, port = init[len("env://"):].rsplit(":", 1)
        os.environ.update(MASTER_ADDR=host, MASTER_PORT=port, WORLD_SIZE=str(n), RANK=str(rank),
                          LOCAL_RANK=str(rank))
        grid = multihost.initialize_multihost(device="cpu")
    else:
        import torch.distributed as dist

        from traversability_estimation_tpu_torch.parallel import sharding as sh

        dist.init_process_group("gloo", init_method=init, world_size=n, rank=rank)
        grid = sh.make_grid("cpu")
    for name in names.split(","):
        try:
            res = CASES[name](grid, inp)
        except Exception:  # noqa: BLE001 - reported to the test through the file
            res = {"error": np.array(traceback.format_exc())}
        if rank == 0:
            np.savez(Path(out_dir) / f"{name}.npz", **res)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
