"""The port's drivers (``traversability_estimation_tpu_torch/scripts``) on
the CPU at small sizes, against the JAX package's:

- ``online_loop``: the JSON row's contract as tests/test_online_loop_script.py
  asserts it for the JAX script (free-run pipelined, then dispatch-only), and
  its first three ticks' inputs equal to the JAX script's and their verdicts
  equal to the JAX estimator's ``online_tick`` on the same seed;
- ``rollouts``: a 6 m map, 64 host-generated rollouts for two steps, each
  step's verdicts equal to the JAX estimator's for the same poses on the same
  refreshed map (traversability within 1e-6, as tests/test_torch_paths.py),
  and the recorded start check equal to the JAX estimator's;
- ``scaling_bench --sizes 1 2 --device cpu`` (worlds of 1 and 2 gloo
  processes) and ``multihost_demo`` in a 2-process gloo world, whose
  verdicts must equal the local evaluator's on the whole map;
- the public names of every module this slice ports against its JAX
  counterpart's, each difference listed with its reason.
"""

import importlib
import importlib.util
import inspect
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from traversability_estimation_tpu.models.estimator import TraversabilityEstimator as JaxEstimator
from traversability_estimation_tpu.utils.config import EstimatorConfig as JaxConfig
from traversability_estimation_tpu.utils.sources import SyntheticTerrainSource as JaxSource
from traversability_estimation_tpu_torch.scripts import online_loop, rollouts, scaling_bench

ROOT = Path(__file__).resolve().parents[1]
RES = 0.03


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the host's cores, and
    OpenMP regions of many small ops stall when threads outnumber cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_online_loop_json_contract(tmp_path):
    out = tmp_path / "ol.json"
    row = online_loop.main([
        "--device", "cpu", "--seconds", "1", "--rate", "0", "--map-m", "6",
        "--paths", "8", "--warmup-ticks", "1", "--json", str(out),
    ])
    assert json.loads(out.read_text()) == row
    assert row["kind"] == "online_loop" and row["free_run"] and row["device"] == "cpu"
    assert row["fetch_depth"] == 3  # auto depth in free-run
    assert row["fetch_bytes"] == 8  # the safe plane only, 1 B per path
    assert row["upload_bytes_per_tick"] > 0
    assert row["upload_probe_ms"] >= 0.0
    assert row["ticks"] >= 1 and row["achieved_hz"] > 0

    out2 = tmp_path / "ol2.json"
    row2 = online_loop.main([
        "--device", "cpu", "--seconds", "1", "--rate", "0", "--map-m", "6",
        "--paths", "8", "--warmup-ticks", "1", "--dispatch-only", "--footprint",
        "--json", str(out2),
    ])
    assert json.loads(out2.read_text()) == row2
    assert row2["dispatch_only"] and row2["query_ms"] == {}
    assert row2["drain_s"] >= 0.0  # the final drain is inside measured_s
    assert row2["query"] == "polygonal"
    # the JAX script's row keys (scripts/online_loop.py), all present
    assert chip_smoke.ONLINE_ROW_KEYS <= set(row) and chip_smoke.ONLINE_ROW_KEYS <= set(row2)


def test_online_loop_ticks_equal_jax_online_tick():
    record = []
    online_loop.main(["--device", "cpu", "--seconds", "0.2", "--rate", "0", "--map-m", "6",
                      "--paths", "8", "--warmup-ticks", "3"], record=record)
    assert [t for t, _ in record[:3]] == [0, 1, 2]
    from traversability_estimation_tpu_torch.utils.sources import SyntheticTerrainSource

    src, jsrc = SyntheticTerrainSource(resolution=RES), JaxSource(resolution=RES)
    est = JaxEstimator(JaxConfig(resolution=RES))
    est.set_elevation_map(np.full((200, 200), np.nan, np.float32))
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    n_safe = 0
    for t in range(3):
        patch, center, poses, n_poses = online_loop.tick_inputs(t, rng, src, 6.0, 8)
        # the JAX script's tick (scripts/online_loop.py, run_tick)
        theta = 0.15 * t
        cx, cy = 6.0 / 4 * np.cos(theta), 6.0 / 4 * np.sin(theta)
        jpatch, _ = jsrc.sample((cx, cy), (4.0, 4.0))
        starts = np.stack([cx + jrng.uniform(-1.5, 1.5, 8), cy + jrng.uniform(-1.5, 1.5, 8)], -1)
        steps = jrng.uniform(-0.1, 0.1, (8, 9, 2))
        jposes = np.concatenate([starts[:, None], starts[:, None] + np.cumsum(steps, 1)],
                                1).astype(np.float32)
        assert np.array_equal(patch, jpatch, equal_nan=True) and center == (cx, cy)
        assert np.array_equal(poses, jposes) and np.array_equal(n_poses, np.full(8, 10))
        safe, _ = est.online_tick(jpatch, (cx, cy), jposes, n_poses, radius=0.3)
        assert np.array_equal(record[t][1], np.asarray(safe)), t
        n_safe += int(np.asarray(safe).sum())
    assert 0 < n_safe < 24


@pytest.fixture(scope="module")
def rollouts_run(_one_thread):
    """Two steps of 64 host-generated rollouts on a 6 m map, recorded."""
    record = {}
    row = rollouts.main(["--device", "cpu", "--map-m", "6", "--rollouts", "64", "--steps", "2"],
                        record=record)
    return row, record


def test_rollouts_match_jax_estimator(rollouts_run):
    row, record = rollouts_run
    assert row["kind"] == "rollouts" and row["map_cells"] == [200, 200]
    assert len(record["steps"]) == 2
    jsrc = JaxSource(resolution=RES)
    est = JaxEstimator(JaxConfig(resolution=RES))
    est.update(rollouts.initial_map(jsrc, 200, 6.0, RES))
    n_safe = 0
    for r in record["steps"]:
        robot = tuple(r["robot"])
        patch, _ = jsrc.sample(robot, (6.0, 6.0))
        assert est.update_with_submap(patch, robot)
        P, N = r["poses"].shape[:2]
        safe, trav = est.check_circular_paths_batch(r["poses"], np.full((P,), N, np.int32), 0.3)
        safe, trav = np.asarray(safe), np.asarray(trav)
        assert np.array_equal(r["safe"], safe)
        assert np.abs(r["trav"] - trav).max() <= 1e-6
        n_safe += int(safe.sum())
        # under 4M cells the batch is answered on the whole map
        assert r["window"] == (0, 0, 200, 200)
        np.testing.assert_array_equal(r["layers"]["traversable_mask"],
                                      np.asarray(est.query_state.traversable_mask))
    assert 0 < n_safe < 128


def test_rollouts_start_check_matches_jax_estimator(rollouts_run):
    """The recorded start check (256 single-pose candidates on the whole
    map, before the first step) against the JAX estimator's on the same
    initial map; the recorded field is the whole map's."""
    _, record = rollouts_run
    start = record["start"]
    est = JaxEstimator(JaxConfig(resolution=RES))
    est.update(rollouts.initial_map(JaxSource(resolution=RES), 200, 6.0, RES))
    ok, trav = est.check_circular_paths_batch(
        start["candidates"], np.ones(256, np.int32), 0.3, crop=False)
    assert np.array_equal(start["ok"], np.asarray(ok))
    assert 0 < start["ok"].sum() < 256
    assert np.abs(start["trav"] - np.asarray(trav)).max() <= 1e-6
    assert start["field"][0].shape == start["state"].shape == (200, 200)


def test_scaling_bench_gloo_worlds(monkeypatch):
    # one thread a process: the suite's other workers share the host
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rows = scaling_bench.main(["--sizes", "1", "2", "--device", "cpu", "--tile", "32",
                               "--paths", "32", "--poses", "4", "--k1", "1", "--k2", "3"])
    upd = [r for r in rows if r["kind"] == "scaling_update"]
    qry = [r for r in rows if r["kind"] == "scaling_tiled_query"]
    assert [r["mesh"] for r in upd] == [1, 2] and [r["mesh"] for r in qry] == [1, 2]
    assert [r["map"] for r in upd] == [[32, 32], [32, 64]]
    assert upd[0]["efficiency"] == 1.0 and upd[1]["efficiency"] > 0
    assert all(r["backend"] == "gloo" and r["t_iter_ms"] > 0 for r in upd + qry)
    assert all(r["lo_ms"] <= r["med_ms"] <= r["hi_ms"] for r in upd + qry)
    summary = rows[-1]
    assert summary["kind"] == "scaling_summary" and summary["meshes"] == [1, 2]
    assert summary["efficiency_at_2"] == upd[1]["efficiency"] and "gloo" in summary["note"]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_multihost_demo_two_gloo_processes():
    n = 160
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
    cmd = [sys.executable, "-m", "traversability_estimation_tpu_torch.scripts.multihost_demo",
           "--num-processes", "2", "--coordinator", f"localhost:{_free_port()}", "--device",
           "cpu", "--map-cells", str(n)]
    procs = [subprocess.Popen(cmd + ["--process-id", str(r)], cwd=str(ROOT), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    lines = [[ln for ln in o.splitlines() if "paths checked" in ln][0] for o in outs]
    assert lines[0].split(":", 1)[1] == lines[1].split(":", 1)[1]
    # the same map and paths through the local evaluator on the whole map
    from traversability_estimation_tpu_torch import EstimatorConfig, TraversabilityEstimator
    from traversability_estimation_tpu_torch.ops import footprint as fp_ops

    rng = np.random.default_rng(0)
    elev = (0.05 * rng.standard_normal((n, n))).astype(np.float32)
    est = TraversabilityEstimator(EstimatorConfig(resolution=RES), device="cpu")
    cfg = est.config
    est.config = type(cfg)(**{**cfg.__dict__, "footprint": type(cfg.footprint)(
        **{**cfg.footprint.__dict__, "verify_roughness_footprint": True})})
    assert est.update(elev)
    P, N = 128, 8
    starts = rng.uniform(-2, 2, (P, 2))
    steps = rng.uniform(-0.1, 0.1, (P, N - 1, 2))
    poses = np.concatenate([starts[:, None], starts[:, None] + np.cumsum(steps, 1)], 1).astype(
        np.float32)
    safe, trav = fp_ops.check_circular_paths(est.query_state, torch.from_numpy(poses),
                                             torch.full((P,), N, dtype=torch.int32), 0.3, 0.15, 16)
    mean = float(trav[safe].mean()) if bool(safe.any()) else float("nan")
    # the demo's terrain (the JAX demo's 5 cm noise) vetoes most paths
    assert lines[0].split(":", 1)[1].strip() == (
        f"{P} paths checked, safe={int(safe.sum())}, mean trav={mean:.3f}")


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_scripts_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _public(mod):
    """Names a module defines itself, not starting with _: its constants and
    the classes and functions whose home it is (not modules, imported
    classes and functions, typing names or ``from __future__`` features)."""
    out = set()
    for n, v in vars(mod).items():
        if n.startswith("_") or inspect.ismodule(v):
            continue
        if getattr(v, "__module__", None) in ("typing", "__future__"):
            continue
        if (inspect.isclass(v) or inspect.isfunction(v)) and v.__module__ != mod.__name__:
            continue
        out.add(n)
    return out


JAX = "traversability_estimation_tpu."
PORT = "traversability_estimation_tpu_torch."
# module -> ({JAX name missing from the port: reason}, {port-only name: reason})
NAME_DIFFERENCES = {
    "utils.profiling": ({}, {}),
    "utils.roofline": ({}, {
        "PEAK_F32_FLOPS": "the data sheet's peaks, moved from chip_smoke.py",
        "PEAK_BYTES": "the data sheet's peaks, moved from chip_smoke.py",
        "SM_CLOCK_MAX_HZ": "the boost clock, moved from chip_smoke.py",
        "LOGIC_PER_SM_PER_CLOCK": "the spec of the logic-instruction rate",
        "bound": "the spec-sheet bound, moved from chip_smoke.py",
        "spec_peaks": "the spec sheet's peaks beside the measured ones",
    }),
    "utils.native": ({}, {
        "PACKAGE_DIR": "the port builds its own libraries (never csrc/build.sh)",
        "CSRC_DIR": "the port builds its own libraries (never csrc/build.sh)",
        "BUILD_DIR": "the port builds its own libraries (never csrc/build.sh)",
        "SOURCES": "the port builds its own libraries (never csrc/build.sh)",
        "CXX_FLAGS": "the port builds its own libraries (never csrc/build.sh)",
        "library_path": "the port builds its own libraries (never csrc/build.sh)",
    }),
    "utils.viz": ({}, {}),
    "oracle.filters": ({}, {}),
    "oracle.footprint": ({}, {}),
    "scripts.online_loop": ({}, {
        "tick_inputs": "the tick's inputs, shared with chip_smoke.py and the tests",
        "parser": "the arguments, shared with chip_smoke.py",
    }),
    "scripts.rollouts": ({
        "run_tiled_device_gen": "--tiled --device-gen is a branch of run_tiled",
    }, {
        "run_query_cropped": "the default mode (inline in the JAX main)",
        "device_rollouts": "the device-generated batch of both --device-gen modes",
        "rollout_batch": "the rollout batch, shared with chip_smoke.py phase 9c",
        "nearest_traversable": "the tiled start, shared with chip_smoke.py phase 9c",
        "initial_map": "the initial world (inline in the JAX main)",
        "log": "stderr logging (inline prints in the JAX script)",
        "parser": "the arguments",
        "RADIUS": "constants the JAX script repeats inline",
        "MAX_SEGMENT_CELLS": "constants the JAX script repeats inline",
        "FOOTPRINT": "constants the JAX script repeats inline",
    }),
    "scripts.scaling_bench": ({
        "run_multiprocess": "every world is a group of processes; run_world starts one",
    }, {
        "run_world": "starts one world of processes (run_multiprocess's role)",
        "parser": "the arguments",
        "REPO": "the repository root the worker processes import from",
    }),
    "scripts.multihost_demo": ({}, {"parser": "the arguments"}),
}


@pytest.mark.parametrize("name", list(NAME_DIFFERENCES))
def test_public_names_match_the_jax_module(name):
    port = importlib.import_module(PORT + name)
    if name.startswith("scripts."):
        jax_mod = _jax_script(name.split(".")[1])
    else:
        jax_mod = importlib.import_module(JAX + name)
    missing, extra = NAME_DIFFERENCES[name]
    assert _public(jax_mod) - _public(port) == set(missing)
    assert _public(port) - _public(jax_mod) == set(extra)
