"""The port's GridMap (traversability_estimation_tpu_torch.grid.gridmap)
against the JAX GridMap on the same arrays, on the CPU: everything exact
(index math, positions, rolled layers, the NaN pattern, the success flag of
``get_submap``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traversability_estimation_tpu.grid.gridmap import GridMap as JaxGridMap
from traversability_estimation_tpu_torch import GridMap

RES = 0.1
POSITION = (1.0, -2.0)


def planes(rows=64, cols=48, seed=7):
    rng = np.random.default_rng(seed)
    elev = rng.standard_normal((rows, cols)).astype(np.float32)
    elev[rng.random((rows, cols)) < 0.05] = np.nan
    return {"elevation": elev, "traversability": rng.random((rows, cols)).astype(np.float32)}


def both(rows=64, cols=48, res=RES, position=POSITION, with_veto_planes=True):
    data = planes(rows, cols)
    jm = JaxGridMap.create((rows, cols), res, position, data=data)
    tm = GridMap.create((rows, cols), res, position, data=data, device="cpu")
    if with_veto_planes:
        # the estimator's maps also hold bool veto planes and may hold integers
        ok = np.random.default_rng(3).random((rows, cols)) > 0.3
        count = np.random.default_rng(4).integers(0, 9, (rows, cols)).astype(np.int32)
        jm = JaxGridMap(layers={**jm.layers, "step_ok": jnp.asarray(ok), "count": jnp.asarray(count)},
                        resolution=res, position=jm.position)
        tm = GridMap(layers={**tm.layers, "step_ok": torch.from_numpy(ok),
                             "count": torch.from_numpy(count)},
                     resolution=res, position=tm.position)
    return jm, tm


def assert_maps_equal(tm, jm):
    assert set(tm.layers) == set(jm.layers)
    assert tm.size == tuple(jm.size)
    for k, v in jm.layers.items():
        got = tm[k].numpy()
        assert got.dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(tm.position.numpy(), np.asarray(jm.position))
    assert tm.resolution == jm.resolution and tm.frame_id == jm.frame_id


def test_create_properties_and_from_length():
    jm, tm = both(with_veto_planes=False)
    assert_maps_equal(tm, jm)
    assert (tm.rows, tm.cols) == (jm.rows, jm.cols) == (64, 48)
    assert tm.length == jm.length
    assert tm.exists("elevation") and not tm.exists("nope")
    assert tm.get("elevation") is tm["elevation"]
    np.testing.assert_array_equal(tm.valid_mask().numpy(), np.asarray(jm.valid_mask()))
    jl = JaxGridMap.from_length((2.5, 1.3), 0.03, (0.5, 0.5), layers=("elevation", "variance"))
    tl = GridMap.from_length((2.5, 1.3), 0.03, (0.5, 0.5), layers=("elevation", "variance"),
                             device="cpu")
    assert_maps_equal(tl, jl)
    assert bool(torch.isnan(tl["variance"]).all())
    with pytest.raises(ValueError, match="shape"):
        GridMap.create((4, 4), 0.1, data={"elevation": np.zeros((4, 5), np.float32)}, device="cpu")
    with pytest.raises(ValueError, match="no layers"):
        GridMap(layers={}, resolution=0.1, position=torch.zeros(2)).size
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if not torch.cuda.is_available():
            GridMap.create((4, 4), 0.1)
        else:
            raise RuntimeError("device='cpu'")


def test_add_erase_keep_clear_leave_the_original():
    jm, tm = both(with_veto_planes=False)
    new = np.random.default_rng(5).random((64, 48)).astype(np.float32)
    first, before = tm, {k: v.clone() for k, v in tm.layers.items()}
    steps = [
        lambda m, a: m.add("slope", a(new)),
        lambda m, a: m.add("empty"),
        lambda m, a: m.add("elevation", a(new)),  # an existing layer is replaced
        lambda m, a: m.add_all({"a": a(new), "b": a(new * 2)}),
        lambda m, a: m.clear("traversability"),
        lambda m, a: m.erase("a"),
        lambda m, a: m.keep_only(["elevation", "b", "nope"]),
        lambda m, a: m.with_position((3.0, 4.0)),
    ]
    for step in steps:
        jm2, tm2 = step(jm, jnp.asarray), step(tm, torch.from_numpy)
        assert_maps_equal(tm2, jm2)
        assert tm2 is not tm
        jm, tm = jm2, tm2
    assert set(first.layers) == set(before)  # the first map is as it was
    for k, v in before.items():
        np.testing.assert_array_equal(first[k].numpy(), v.numpy())
    assert set(tm.layers) == {"elevation", "b"}


@pytest.mark.parametrize("target", [(1.77, -2.33), (1.0, -2.0), (1.04, -2.04), (-0.9, -0.2),
                                    (30.0, 30.0), (1.05, -1.95), (0.75, -2.25)])
def test_recenter_matches_jax(target):
    """Off-grid, zero, sub-cell, large and whole-window shifts, and targets
    exactly half a cell away (round half to even): position, every layer and
    the fill per dtype (NaN, True, 0) are equal."""
    jm, tm = both()
    jm2, tm2 = jm.recenter(target), tm.recenter(target)
    assert_maps_equal(tm2, jm2)
    assert_maps_equal(tm, jm)  # the map it came from is unchanged
    shift = np.round((np.float32(target) - np.float32(POSITION)) / np.float32(RES)).astype(int)
    rows, cols = tm.size
    exposed = ~np.asarray(GridMap.roll_valid_mask(rows, cols, int(shift[0]), int(shift[1])))
    np.testing.assert_array_equal(
        exposed, ~np.asarray(JaxGridMap.roll_valid_mask(rows, cols, shift[0], shift[1])))
    if exposed.any():
        assert np.isnan(tm2["elevation"].numpy()[exposed]).all()
        assert tm2["step_ok"].numpy()[exposed].all()
        assert (tm2["count"].numpy()[exposed] == 0).all()
    else:
        assert tuple(shift) == (0, 0)


def test_recenter_keeps_world_positions():
    jm, tm = both(with_veto_planes=False)
    tm2 = tm.recenter((1.77, -2.33))
    np.testing.assert_allclose(tm2.position.numpy(), [1.8, -2.3], atol=1e-6)
    probe = np.float32([1.31, -2.52])
    i1 = tuple(tm.index_of(probe).tolist())
    i2 = tuple(tm2.index_of(probe).tolist())
    a, b = tm["traversability"][i1], tm2["traversability"][i2]
    assert i1 != i2 and float(a) == float(b)


def test_geometry_matches_jax():
    jm, tm = both(61, 47, 0.03, (0.07, -0.11), with_veto_planes=False)
    xj, yj = jm.cell_positions()
    xt, yt = tm.cell_positions()
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    rng = np.random.default_rng(9)
    half = np.array([61, 47]) * 0.03 / 2 + 0.3
    xy = (np.float32([0.07, -0.11]) + rng.uniform(-half, half, (4000, 2))).astype(np.float32)
    # and points on cell borders and on the map's own edges
    edges = np.float32([0.07, -0.11]) + np.stack(np.meshgrid(
        np.arange(-31, 32) * 0.03 + 0.015, np.arange(-24, 25) * 0.03 + 0.015), -1).reshape(-1, 2)
    xy = np.concatenate([xy, edges.astype(np.float32)])
    np.testing.assert_array_equal(tm.index_of(xy).numpy(), np.asarray(jm.index_of(jnp.asarray(xy))))
    np.testing.assert_array_equal(tm.is_inside(xy).numpy(), np.asarray(jm.is_inside(jnp.asarray(xy))))
    assert tm.is_inside(xy).any() and not tm.is_inside(xy).all()
    idx = rng.integers(-3, 64, (500, 2)).astype(np.int32)
    np.testing.assert_array_equal(
        tm.position_of(idx).numpy(), np.asarray(jm.position_of(jnp.asarray(idx))))
    one = tm.index_of((0.07, -0.11))
    assert one.shape == (2,) and one.dtype == torch.int32


@pytest.mark.parametrize("position,length,expect", [
    ((1.0, -2.0), (2.0, 1.0), True),      # on the map
    ((1.23, -1.71), (0.55, 0.95), True),  # off-grid centre and length
    ((3.9, -2.0), (2.0, 2.0), True),      # partly off the map, centre on it
    ((4.25, 0.45), (1.0, 1.0), False),    # fully off the map
    ((-9.0, -9.0), (0.5, 0.5), False),
    ((1.0, -2.0), (50.0, 50.0), True),    # larger than the map
])
def test_get_submap_matches_jax(position, length, expect):
    jm, tm = both()
    js, jok = jm.get_submap(position, length)
    ts, tok = tm.get_submap(position, length)
    assert tok == jok == expect
    assert_maps_equal(ts, js)
    assert ts.size[0] >= 1 and ts.size[1] >= 1
