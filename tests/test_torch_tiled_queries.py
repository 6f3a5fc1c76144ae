"""The port's path queries against the TILED map and its sharded online tick
(parallel/sharding.py), in gloo process grids of 2 (1 x 2), 4 (2 x 2) and
8 (2 x 4) ranks on the CPU.

As tests/test_tiled_queries.py holds the JAX package's tiled queries to its
local evaluators, these hold the port's to the port's local evaluators on
the same field: circular paths in the per-sample mode (and with the raster
split over the ranks) bit-identical in verdict and traversability, single-
pose paths to the field at the pose's cell centre, the per-path mode
(forced with a lowered threshold) exact in verdicts and within 3e-6;
polygonal paths exact in verdicts, within 2e-6 in traversability (rows sum
across tiles) and rtol 1e-5 in area, the per-polygon mode within 3e-6 of the
per-row one; the tick's map state bit-identical to the whole map's update of
the merged elevation. Against the JAX tiled functions on the 8-device CPU
mesh, with the same inputs: verdicts equal, traversability within the
port's tolerances against JAX (1e-6 circular, 2e-6 polygonal; 2e-4 for the
tick, whose traversability layer the port matches to 2e-4). An out-of-range
merge start raises, where the JAX tick clamps it.

Each world is started once for this module, all three together.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import torch_parallel_cases as cases
from traversability_estimation_tpu.ops.filters import ChainConfig as JChain
from traversability_estimation_tpu.ops.veto import VetoConfig as JVeto
from traversability_estimation_tpu.parallel import sharding as jsh
from traversability_estimation_tpu_torch.ops import footprint as tfp

RES = 0.03
H, W = cases.TILED_SHAPE
RADIUS, OFFSET = 0.12, 0.06
WORLDS = (2, 4, 8)
CASES = ["paths", "paths_offmap", "paths_single", "paths_raster", "paths_reduce",
         "polygonal", "polygonal_reduce", "tick", "tick_out_of_range"]
TIMEOUT = 300.0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, result(n, case)): every world started at once."""
    inp = cases.tiled_inputs()
    result, stop = cases.start_worlds(tmp_path_factory.mktemp("tiled"), WORLDS, CASES, inp,
                                      TIMEOUT)
    yield inp, result
    stop()


def _state(trav, mask):
    return tfp.QueryState(torch.from_numpy(trav), torch.from_numpy(mask), torch.zeros(2), RES, 0.5)


@pytest.fixture(scope="module")
def local(world):
    """The port's whole-map query state and circle field."""
    inp, _ = world
    state = _state(inp["q_trav"], inp["q_mask"])
    return state, tfp.dense_circle_field(state, RADIUS + OFFSET, RADIUS)


def _local_paths(local, inp, prefix, max_cells):
    state, field = local
    return [t.numpy() for t in tfp.check_circular_paths(
        state, inp[f"{prefix}_poses"], inp[f"{prefix}_n"], RADIUS, OFFSET, max_cells, field, False)]


def _tiled(x):
    """`x` tiled over the 8-device mesh, as tests/test_tiled_queries.py holds
    its planes: the JAX programs of this module are then the ones it compiles,
    shared through the suite's compile cache."""
    return jax.device_put(jnp.asarray(x), NamedSharding(jsh.make_mesh(8), PartitionSpec("x", "y")))


def _jax_layers(inp):
    return {"traversability": _tiled(inp["q_trav"]), "traversable_mask": _tiled(inp["q_mask"])}


@pytest.fixture(scope="module")
def jax_paths(world):
    inp, _ = world
    mesh = jsh.make_mesh(8)
    field = jsh.sharded_circle_field(_jax_layers(inp), mesh, RADIUS + OFFSET, RADIUS, RES, 0.5)
    out = jsh.check_circular_paths_tiled(
        field[0], field[1], inp["paths_poses"], inp["paths_n"], mesh, (0.0, 0.0), RES, 64)
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("n", WORLDS)
def test_tiled_paths_match_local(world, local, jax_paths, n):
    inp, result = world
    got = result(n, "paths")
    safe, trav = _local_paths(local, inp, "paths", 64)
    np.testing.assert_array_equal(got["safe"], safe)
    np.testing.assert_array_equal(got["trav"], trav)
    np.testing.assert_array_equal(got["safe"], jax_paths[0])
    np.testing.assert_allclose(got["trav"], jax_paths[1], rtol=0, atol=1e-6)
    assert 0 < got["safe"].sum() < len(safe)


@pytest.mark.parametrize("n", WORLDS)
def test_tiled_paths_offmap_default(world, n):
    _, result = world
    got = result(n, "paths_offmap")
    assert bool(got["safe"][0]) is True
    assert got["trav"][0] == pytest.approx(0.5)


@pytest.mark.parametrize("n", WORLDS)
def test_tiled_single_pose_cell_centre(world, local, n):
    inp, result = world
    got = result(n, "paths_single")
    _, (ok_f, tv_f) = local
    p0 = np.array([H, W]) * RES / 2
    idx = np.floor((p0 - inp["single_poses"][:, 0]) / RES).astype(int)
    ok = ok_f.numpy()[idx[:, 0], idx[:, 1]]
    np.testing.assert_array_equal(got["safe"], ok)
    np.testing.assert_array_equal(got["trav"], np.where(ok, tv_f.numpy()[idx[:, 0], idx[:, 1]], 0.0))


@pytest.mark.parametrize("n", WORLDS)
def test_tiled_paths_sharded_raster_matches_local(world, local, n):
    inp, result = world
    assert 256 * 8 * 128 >= 1 << 18  # the raster is split over the ranks
    got = result(n, "paths_raster")
    safe, trav = _local_paths(local, inp, "raster", 128)
    np.testing.assert_array_equal(got["safe"], safe)
    np.testing.assert_array_equal(got["trav"], trav)


@pytest.mark.parametrize("n", WORLDS)
def test_tiled_paths_path_reduce_matches_local(world, local, n):
    inp, result = world
    got = result(n, "paths_reduce")
    safe, trav = _local_paths(local, inp, "reduce", 128)
    np.testing.assert_array_equal(got["safe"], safe)
    np.testing.assert_allclose(got["trav"], trav, rtol=0, atol=3e-6)
    assert 0 < got["safe"].sum() < len(safe)
    assert got["safe1"].shape == (512,) and np.isfinite(got["trav1"]).all()


def _local_polygonal(inp, conservative):
    window = tuple(int(v) for v in inp["poly_window_c" if conservative else "poly_window"])
    return [t.numpy() for t in tfp.check_polygonal_paths(
        _state(inp["q_trav"], inp["q_mask"]), inp["poly_pos"], inp["poly_quat"], inp["poly_n"],
        inp["poly_fp"], window, conservative)]


@pytest.fixture(scope="module")
def jax_polygonal(world):
    inp, _ = world
    out = jsh.check_polygonal_paths_tiled(
        _jax_layers(inp), inp["poly_pos"], inp["poly_quat"], inp["poly_n"],
        tuple(map(tuple, inp["poly_fp"].tolist())), jsh.make_mesh(8), int(inp["poly_window"][0]),
        False, (0.0, 0.0), RES, 0.5)
    return [np.asarray(a) for a in out]


def _assert_polygonal(got, want, trav_atol=2e-6):
    safe, trav, area = got
    np.testing.assert_array_equal(safe, want[0])
    np.testing.assert_allclose(trav, want[1], rtol=0, atol=trav_atol)
    np.testing.assert_allclose(area, want[2], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n", WORLDS)
def test_tiled_polygonal_paths_match_local(world, jax_polygonal, n):
    inp, result = world
    got = result(n, "polygonal")
    for conservative, sfx in ((False, ""), (True, "_c")):
        mine = [got[k + sfx] for k in ("safe", "trav", "area")]
        _assert_polygonal(mine, _local_polygonal(inp, conservative))
    _assert_polygonal([got[k] for k in ("safe", "trav", "area")], jax_polygonal)
    assert 0 < got["safe"].sum() < len(got["safe"])


@pytest.mark.parametrize("n", WORLDS)
def test_tiled_polygonal_row_reduce_matches(world, n):
    inp, result = world
    rows = result(n, "polygonal")
    got = result(n, "polygonal_reduce")
    np.testing.assert_array_equal(got["safe"], rows["safe"])
    np.testing.assert_allclose(got["trav"], rows["trav"], rtol=0, atol=3e-6)
    np.testing.assert_array_equal(got["area"], rows["area"])
    _assert_polygonal([got[k] for k in ("safe", "trav", "area")], _local_polygonal(inp, False), 3e-6)


@pytest.fixture(scope="module")
def jax_tick(world):
    inp, _ = world
    out = jsh.sharded_online_tick(
        _tiled(inp["tick_elev"]), jnp.asarray(inp["tick_patch"]),
        jnp.asarray(inp["tick_start"], jnp.int32), jnp.asarray(inp["tick_poses"]),
        jnp.asarray(inp["tick_n"]), mesh=jsh.make_mesh(8),
        chain_cfg=JChain(resolution=RES), veto_cfg=JVeto(resolution=RES), radius=RADIUS,
        offset=OFFSET, resolution=RES, max_segment_cells=64)
    elev, layers, safe, trav = out
    return np.asarray(elev), {k: np.asarray(v) for k, v in layers.items()}, np.asarray(safe), \
        np.asarray(trav)


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_online_tick_matches_unsharded(world, jax_paths, jax_tick, n):
    inp, result = world
    got = result(n, "tick")
    merged = inp["tick_elev"].copy()
    mi, mj = (int(v) for v in inp["tick_start"])
    merged[mi : mi + 24, mj : mj + 24] = inp["tick_patch"]
    np.testing.assert_array_equal(got["elevation"], merged)
    want = cases.plain_layers(merged)
    for k, v in want.items():
        assert np.array_equal(got[k], v, equal_nan=v.dtype.kind == "f"), k
    state = _state(want["traversability"], want["traversable_mask"])
    field = tfp.dense_circle_field(state, RADIUS + OFFSET, RADIUS)
    safe, trav = tfp.check_circular_paths(
        state, inp["tick_poses"], inp["tick_n"], RADIUS, OFFSET, 64, field, False)
    np.testing.assert_array_equal(got["safe"], safe.numpy())
    np.testing.assert_array_equal(got["trav"], trav.numpy())
    assert 0 < got["safe"].sum() < len(got["safe"])

    elev_j, layers_j, safe_j, trav_j = jax_tick
    np.testing.assert_array_equal(got["elevation"], elev_j)
    for k in ("traversable_mask", "slope_ok", "step_ok", "traversability_step"):
        np.testing.assert_array_equal(got[k], layers_j[k], err_msg=k)
    np.testing.assert_array_equal(got["safe"], safe_j)
    np.testing.assert_allclose(got["trav"], trav_j, rtol=0, atol=2e-4)


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_online_tick_refuses_a_merge_off_the_map(world, n):
    _, result = world
    msg = str(result(n, "tick_out_of_range")["raised"])
    assert "leaves the 60x120 map" in msg
