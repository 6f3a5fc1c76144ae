"""The port's tiled map update and circle field (parallel/sharding.py) in gloo
process grids of 2 (1 x 2), 4 (2 x 2) and 8 (2 x 4) ranks on the CPU,
against the same inputs through the JAX package (its 8-device CPU mesh and
its unsharded functions) and through the port on the whole map.

Bars: every layer of the tiled update bit-identical to the port's whole-map
update (tiles, halos, corners and the padding of a map that does not divide
the grid); against JAX the step layer and every veto plane exact, the float
chain layers within the port's tolerances against JAX (slope 5e-5,
roughness and traversability 2e-4, tests/test_torch_filters.py: XLA:CPU
contracts FMAs), as tests/test_sharding.py holds the JAX sharded update to
its unsharded one. The circle field from the same query planes is
bit-identical to the JAX field, sharded and unsharded.

Each world is started once for this module (one process per rank,
tests/torch_parallel_cases.py), all three together, and runs every case;
each test reads its case's results.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import torch_parallel_cases as cases
from conftest import synthetic_terrain
from traversability_estimation_tpu.models.estimator import _update_step
from traversability_estimation_tpu.ops import footprint as jfp
from traversability_estimation_tpu.ops import veto as jveto
from traversability_estimation_tpu.ops.filters import ChainConfig as JChain
from traversability_estimation_tpu.ops.veto import VetoConfig as JVeto
from traversability_estimation_tpu.parallel import sharding as jsh
from traversability_estimation_tpu_torch.ops import footprint as tfp
from traversability_estimation_tpu_torch.ops import update_kernel, veto
from traversability_estimation_tpu_torch.ops.filters import ChainConfig
from traversability_estimation_tpu_torch.parallel import sharding as sh

RES = 0.03
WORLDS = (2, 4, 8)
CASES = ["grid", "halo", "update", "update_padded", "field", "scatter", "replicate"]
TIMEOUT = 300.0
EXACT = ("traversability_step", "slope_ok", "step_ok", "roughness_ok", "traversable_mask",
         "slope_footprint", "step_footprint", "roughness_footprint")
TOL = {"traversability_slope": 5e-5, "traversability_roughness": 2e-4, "traversability": 2e-4}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, result(n, case)): every world started at once."""
    inp = cases.sharding_inputs()
    result, stop = cases.start_worlds(tmp_path_factory.mktemp("sharding"), WORLDS, CASES, inp,
                                      TIMEOUT)
    yield inp, result
    stop()


def _jax_layers(layers):
    return {k: np.asarray(v) for k, v in layers.items()}


@pytest.fixture(scope="module")
def jax_update(world):
    """The JAX update of the 96^2 map, unsharded and on the 8-device mesh."""
    inp, _ = world
    elev = jnp.asarray(inp["update_elev"])
    jchain, jveto_cfg = JChain(resolution=RES), JVeto(resolution=RES, check_roughness=True)
    unsharded = _update_step(elev, jchain, jveto_cfg)
    sharded = jsh.sharded_update(elev, jchain, jveto_cfg, jsh.make_mesh(8))
    return _jax_layers(unsharded), _jax_layers(sharded)


def _same(a, b):
    return np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


def _assert_like_jax(got, ref):
    for k, v in ref.items():
        if k in EXACT:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert (np.isfinite(got[k]) == np.isfinite(v)).all(), k
            fin = np.isfinite(v)
            np.testing.assert_allclose(got[k][fin], v[fin], rtol=0, atol=TOL[k], err_msg=k)


@pytest.mark.parametrize("n", WORLDS)
def test_grid_matches_the_jax_mesh(world, n):
    _, result = world
    assert tuple(result(n, "grid")["shape"]) == jsh.make_mesh(n).devices.shape


@pytest.mark.parametrize("n", WORLDS)
def test_halo_exchange_fills_edges_and_corners(world, n):
    inp, result = world
    gx, gy = sh.grid_shape(n)
    plane = inp["halo_plane"]
    H, W = plane.shape
    th, tw, h = H // gx, W // gy, 3
    got = result(n, "halo")["padded"]
    assert got.shape == (2, gx * (th + 2 * h), gy * (tw + 2 * h))
    for c, (sign, fill) in enumerate(((1.0, -1.0), (-1.0, -2.0))):
        whole = np.full((H + 2 * h, W + 2 * h), fill, np.float32)
        whole[h:-h, h:-h] = sign * plane
        for ix in range(gx):
            for iy in range(gy):
                want = whole[ix * th : (ix + 1) * th + 2 * h, iy * tw : (iy + 1) * tw + 2 * h]
                tile = got[c, ix * (th + 2 * h) : (ix + 1) * (th + 2 * h),
                           iy * (tw + 2 * h) : (iy + 1) * (tw + 2 * h)]
                np.testing.assert_array_equal(tile, want, err_msg=f"channel {c} tile {ix},{iy}")


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_update_matches_the_whole_map(world, jax_update, n):
    inp, result = world
    got = result(n, "update")
    want = cases.plain_layers(inp["update_elev"], True)
    assert set(got) == set(want)
    for k in want:
        assert _same(got[k], want[k]), k
    unsharded, sharded = jax_update
    assert set(unsharded) == set(got)
    _assert_like_jax(got, unsharded)
    _assert_like_jax(got, sharded)
    assert got["traversable_mask"].any() and not got["traversable_mask"].all()


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_update_of_a_padded_map(world, n):
    """50 x 67 does not divide the grids: pad_to_mesh's NaN padding is out
    of map, and the crop equals the whole map's update."""
    inp, result = world
    got = result(n, "update_padded")
    want = cases.plain_layers(inp["odd_elev"], False)
    for k in want:
        assert _same(got[k], want[k]), k


@pytest.fixture(scope="module")
def jax_field(world):
    inp, _ = world
    trav, mask = jnp.asarray(inp["q_trav"]), jnp.asarray(inp["q_mask"])
    rmax, rmin = (float(r) for r in inp["radii"])
    state = jfp.QueryState(trav, mask, jnp.zeros((2,), jnp.float32), RES, 0.5)
    unsharded = jax.jit(jfp.dense_circle_field, static_argnums=(1, 2))(state, rmax, rmin)
    # tiled over the mesh as tests/test_tiled_queries.py holds its planes, so
    # that this is the program it compiles (shared through the compile cache)
    mesh = jsh.make_mesh(8)
    tiles = NamedSharding(mesh, PartitionSpec("x", "y"))
    layers = {"traversability": jax.device_put(trav, tiles),
              "traversable_mask": jax.device_put(mask, tiles)}
    sharded = jsh.sharded_circle_field(layers, mesh, rmax, rmin, RES, 0.5)
    return [np.asarray(a) for a in unsharded], [np.asarray(a) for a in sharded]


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_circle_field_matches(world, jax_field, n):
    inp, result = world
    got = result(n, "field")
    state = tfp.QueryState(torch.from_numpy(inp["q_trav"]), torch.from_numpy(inp["q_mask"]),
                           torch.zeros(2), RES, 0.5)
    ok_p, tv_p = tfp.dense_circle_field(state, *inp["radii"])
    for ok, tv in ([ok_p.numpy(), tv_p.numpy()], *jax_field):
        np.testing.assert_array_equal(got["ok"], ok)
        np.testing.assert_array_equal(got["trav"], tv)
    assert got["ok"].any() and not got["ok"].all()


@pytest.mark.parametrize("n", WORLDS)
def test_scatter_and_gather_tiles(world, n):
    inp, result = world
    got = result(n, "scatter")
    gx, gy = sh.grid_shape(n)
    np.testing.assert_array_equal(got["trav"], inp["q_trav"])
    np.testing.assert_array_equal(got["mask"], inp["q_mask"])
    assert got["mask"].dtype == np.bool_
    assert tuple(got["tile_shape"]) == (60 // gx, 120 // gy)


@pytest.mark.parametrize("n", WORLDS)
def test_replicated_query_state_and_pose_shards(world, n):
    inp, result = world
    got = result(n, "replicate")
    want = cases.plain_layers(inp["odd_elev"], False)
    assert _same(got["trav"], want["traversability"])
    np.testing.assert_array_equal(got["mask"], want["traversable_mask"])
    np.testing.assert_array_equal(got["position"], np.float32([0.1, -0.2]))
    np.testing.assert_array_equal(got["poses"], inp["poses"])


def test_required_halo_covers_every_stencil():
    assert sh.required_halo is veto.required_halo
    halo = sh.required_halo(ChainConfig(resolution=RES), veto.VetoConfig(resolution=RES))
    assert halo == jsh.required_halo(JChain(resolution=RES), JVeto(resolution=RES)) >= 11


@pytest.mark.parametrize("grid", [(2, 2), (2, 4)])
def test_tile_bodies_on_halos_cut_from_the_whole_map(grid):
    """The tile bodies without processes: each tile's halo cut from the
    NaN-padded whole map on the host, as chip_smoke.py phase 9 does on the
    card; the stitched crops equal the whole map's update and field."""
    gx, gy = grid
    elev = synthetic_terrain(45, 61, RES, seed=9, nan_frac=0.04)
    padded, (H, W) = sh.pad_to_mesh(elev, sh.Grid(gx, gy, 0, torch.device("cpu")))
    th, tw = padded.shape[0] // gx, padded.shape[1] // gy
    chain, vcfg = ChainConfig(resolution=RES), veto.VetoConfig(resolution=RES)
    h = sh.required_halo(chain, vcfg)
    big = np.full((padded.shape[0] + 2 * h, padded.shape[1] + 2 * h), np.nan, np.float32)
    big[h : h + H, h : h + W] = elev
    want = cases.plain_layers(elev, False)
    got = {k: np.empty(padded.shape, v.dtype) for k, v in want.items()}
    for ix in range(gx):
        for iy in range(gy):
            cut = torch.from_numpy(big[ix * th : (ix + 1) * th + 2 * h, iy * tw : (iy + 1) * tw + 2 * h])
            out = sh.tile_update(cut, chain, vcfg, h, (ix * th - h, iy * tw - h), (H, W))
            for k, v in out.items():
                got[k][ix * th : (ix + 1) * th, iy * tw : (iy + 1) * tw] = v.numpy()
    for k in want:
        assert _same(got[k][:H, :W], want[k]), k

    rmax, rmin = 0.45, 0.3
    fh = sh.field_halo(rmax, RES)
    tv_big = np.full((padded.shape[0] + 2 * fh, padded.shape[1] + 2 * fh), np.nan, np.float32)
    mk_big = np.zeros(tv_big.shape, bool)
    tv_big[fh : fh + H, fh : fh + W] = want["traversability"]
    mk_big[fh : fh + H, fh : fh + W] = want["traversable_mask"]
    ok = np.empty(padded.shape, bool)
    tv = np.empty(padded.shape, np.float32)
    for ix in range(gx):
        for iy in range(gy):
            win = (slice(ix * th, (ix + 1) * th + 2 * fh), slice(iy * tw, (iy + 1) * tw + 2 * fh))
            o, t = sh.tile_circle_field(
                torch.from_numpy(tv_big[win]), torch.from_numpy(mk_big[win]), fh,
                (ix * th - fh, iy * tw - fh), (H, W), rmax, rmin, RES)
            ok[ix * th : (ix + 1) * th, iy * tw : (iy + 1) * tw] = o.numpy()
            tv[ix * th : (ix + 1) * th, iy * tw : (iy + 1) * tw] = t.numpy()
    state = tfp.QueryState(torch.from_numpy(want["traversability"]),
                           torch.from_numpy(want["traversable_mask"]), torch.zeros(2), RES, 0.5)
    ok_w, tv_w = tfp.dense_circle_field(state, rmax, rmin)
    np.testing.assert_array_equal(ok[:H, :W], ok_w.numpy())
    np.testing.assert_array_equal(tv[:H, :W], tv_w.numpy())


def test_update_with_a_map_frame_matches_the_jax_veto_with_in_map():
    """fused_update_plain with an origin: the veto planes of JAX's
    compute_veto_fields given the same chain layers and in-map plane (the
    JAX tile body), cell for cell; cells beyond the map hold no elevation."""
    elev = synthetic_terrain(40, 52, RES, seed=12, nan_frac=0.05)
    origin, gshape = (-6, 9), (30, 70)
    vcfg = veto.VetoConfig(resolution=RES, check_roughness=True)
    got = update_kernel.fused_update_plain(
        torch.from_numpy(elev), ChainConfig(resolution=RES), vcfg, origin, gshape)
    in_map = sh.global_in_map(elev.shape, origin, gshape).numpy()
    masked = np.where(in_map, elev, np.nan).astype(np.float32)
    assert not in_map.all() and in_map.any()
    ref = jax.jit(jveto.compute_veto_fields, static_argnums=(1,))(
        {"elevation": jnp.asarray(masked),
         **{k: jnp.asarray(got[k].numpy()) for k in (
             "traversability_slope", "traversability_step", "traversability_roughness")}},
        JVeto(resolution=RES, check_roughness=True), jnp.asarray(in_map))
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    # the default frame is the array itself
    plain = update_kernel.fused_update_plain(
        torch.from_numpy(elev), ChainConfig(resolution=RES), vcfg, (0, 0), elev.shape)
    base = update_kernel.fused_update_plain(torch.from_numpy(elev), ChainConfig(resolution=RES), vcfg)
    for k in base:
        assert _same(plain[k].numpy(), base[k].numpy()), k
