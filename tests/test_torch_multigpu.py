"""The tiled path across four GPUs: one process per card over nccl
(parallel/), running the cases of the gloo grids in test_torch_sharding.py
and test_torch_tiled_queries.py, held to the port's whole-map results on one
card (kernels 1 and 2, the local evaluators).

Marked ``cuda``; skips unless four CUDA devices are present. On a machine
with four cards (no JAX there, so without the suite's conftest):
``python -m pytest --noconftest -m cuda tests/test_torch_multigpu.py``.

Bars: the halo exchange fills every padded tile, corners included; the tiled
update and circle field bit-identical to one card's whole-map kernels
(kernel 1 with each tile's global origin, kernel 2 with its in-map plane),
also for a map that does not divide the grid; circular paths in the
per-sample mode, and with the raster split over the ranks, bit-identical to
check_circular_paths_plain on the same field (the tiled path is the plain
version's arithmetic), the per-path mode exact in verdicts
and within 3e-6; polygonal paths exact in verdicts, within 2e-6 in
traversability (3e-6 per polygon) and rtol 1e-5 in area; the sharded tick's
map state bit-identical to the whole map's update of the merged elevation
and its verdicts to check_circular_paths_plain; a merge off the map raises.
"""

import socket

import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
from traversability_estimation_tpu_torch.ops import field_kernel, footprint, update_kernel
from traversability_estimation_tpu_torch.ops.filters import ChainConfig
from traversability_estimation_tpu_torch.ops.veto import VetoConfig

pytestmark = pytest.mark.cuda

RES = cases.RES
N_CARDS = 4
CASES = ["grid", "halo", "update", "update_padded", "field", "scatter", "paths", "paths_raster",
         "paths_reduce", "polygonal", "polygonal_reduce", "tick", "tick_out_of_range"]
TIMEOUT = 300.0
RADIUS, OFFSET = 0.12, 0.06
DEV = "cuda"


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, result(case)) of one 2 x 2 grid, one process per card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < N_CARDS:
        pytest.skip(f"needs {N_CARDS} CUDA devices: one nccl process per card")
    inp = {**cases.sharding_inputs(), **cases.tiled_inputs()}
    result, stop = cases.start_worlds(
        tmp_path_factory.mktemp("multigpu"), (N_CARDS,), CASES, inp, TIMEOUT,
        init=lambda n: f"nccl://localhost:{_free_port()}")
    yield inp, lambda case: result(N_CARDS, case)
    stop()


def _same(a, b):
    return a.shape == b.shape and np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


def _whole_map(elev, check_roughness=False):
    """Kernel 1 on the whole map, one card."""
    layers = update_kernel.fused_update(
        torch.as_tensor(elev, device=DEV), ChainConfig(resolution=RES),
        VetoConfig(resolution=RES, check_roughness=check_roughness))
    return {k: v.cpu().numpy() for k, v in layers.items()}


def _state(trav, mask):
    return footprint.QueryState(torch.as_tensor(trav, device=DEV), torch.as_tensor(mask, device=DEV),
                                torch.zeros(2, device=DEV), RES, 0.5)


def _local_paths(state, poses, n_poses, max_cells):
    field = field_kernel.dense_circle_field(state, RADIUS + OFFSET, RADIUS)
    return [t.cpu().numpy() for t in footprint.check_circular_paths_plain(
        state, poses, n_poses, RADIUS, OFFSET, max_cells, field, False)]


def test_grid_is_two_by_two(world):
    _, result = world
    assert tuple(result("grid")["shape"]) == (2, 2)


def test_halo_exchange_across_cards(world):
    inp, result = world
    plane = inp["halo_plane"]
    H, W = plane.shape
    th, tw, h = H // 2, W // 2, 3
    got = result("halo")["padded"]
    for c, (sign, fill) in enumerate(((1.0, -1.0), (-1.0, -2.0))):
        whole = np.full((H + 2 * h, W + 2 * h), fill, np.float32)
        whole[h:-h, h:-h] = sign * plane
        for ix in range(2):
            for iy in range(2):
                want = whole[ix * th : (ix + 1) * th + 2 * h, iy * tw : (iy + 1) * tw + 2 * h]
                tile = got[c, ix * (th + 2 * h) : (ix + 1) * (th + 2 * h),
                           iy * (tw + 2 * h) : (iy + 1) * (tw + 2 * h)]
                np.testing.assert_array_equal(tile, want, err_msg=f"channel {c} tile {ix},{iy}")


@pytest.mark.parametrize("case, key, check_roughness",
                         [("update", "update_elev", True), ("update_padded", "odd_elev", False)])
def test_sharded_update_matches_one_card(world, case, key, check_roughness):
    inp, result = world
    got = result(case)
    want = _whole_map(inp[key], check_roughness)
    assert set(got) == set(want)
    for k in want:
        assert _same(got[k], want[k]), k


def test_sharded_circle_field_matches_one_card(world):
    inp, result = world
    got = result("field")
    ok, tv = field_kernel.dense_circle_field(_state(inp["q_trav"], inp["q_mask"]), *inp["radii"])
    assert _same(got["ok"], ok.cpu().numpy()) and _same(got["trav"], tv.cpu().numpy())


def test_scatter_and_gather_across_cards(world):
    inp, result = world
    got = result("scatter")
    assert _same(got["trav"], inp["q_trav"]) and _same(got["mask"], inp["q_mask"])
    assert tuple(got["tile_shape"]) == (30, 60)


@pytest.mark.parametrize("case, prefix, max_cells", [("paths", "paths", 64),
                                                     ("paths_raster", "raster", 128)])
def test_tiled_circular_paths_match_one_card(world, case, prefix, max_cells):
    inp, result = world
    got = result(case)
    safe, trav = _local_paths(_state(inp["q_trav"], inp["q_mask"]), inp[f"{prefix}_poses"],
                              inp[f"{prefix}_n"], max_cells)
    assert _same(got["safe"], safe) and _same(got["trav"], trav)
    assert 0 < safe.sum() < len(safe)


def test_tiled_circular_paths_per_path_mode(world):
    inp, result = world
    got = result("paths_reduce")
    safe, trav = _local_paths(_state(inp["q_trav"], inp["q_mask"]), inp["reduce_poses"],
                              inp["reduce_n"], 128)
    np.testing.assert_array_equal(got["safe"], safe)
    np.testing.assert_allclose(got["trav"], trav, rtol=0, atol=3e-6)


def _local_polygonal(inp, conservative):
    window = tuple(int(v) for v in inp["poly_window_c" if conservative else "poly_window"])
    return [t.cpu().numpy() for t in footprint.check_polygonal_paths(
        _state(inp["q_trav"], inp["q_mask"]), inp["poly_pos"], inp["poly_quat"], inp["poly_n"],
        inp["poly_fp"], window, conservative)]


@pytest.mark.parametrize("case, conservative, suffix, atol",
                         [("polygonal", False, "", 2e-6), ("polygonal", True, "_c", 2e-6),
                          ("polygonal_reduce", False, "", 3e-6)])
def test_tiled_polygonal_paths_match_one_card(world, case, conservative, suffix, atol):
    inp, result = world
    got = result(case)
    safe, trav, area = _local_polygonal(inp, conservative)
    np.testing.assert_array_equal(got["safe" + suffix], safe)
    np.testing.assert_allclose(got["trav" + suffix], trav, rtol=0, atol=atol)
    np.testing.assert_allclose(got["area" + suffix], area, rtol=1e-5, atol=1e-7)


def test_sharded_tick_matches_one_card(world):
    inp, result = world
    got = result("tick")
    merged = inp["tick_elev"].copy()
    mi, mj = (int(v) for v in inp["tick_start"])
    merged[mi : mi + 24, mj : mj + 24] = inp["tick_patch"]
    assert _same(got["elevation"], merged)
    want = _whole_map(merged)
    for k, v in want.items():
        assert _same(got[k], v), k
    safe, trav = _local_paths(_state(want["traversability"], want["traversable_mask"]),
                              inp["tick_poses"], inp["tick_n"], 64)
    assert _same(got["safe"], safe) and _same(got["trav"], trav)


def test_sharded_tick_refuses_a_merge_off_the_map(world):
    _, result = world
    assert "leaves the 60x120 map" in str(result("tick_out_of_range")["raised"])
