"""The port's map-management services (set_traversability_map,
reset_footprint_layers, restore_default_traversability, update_parameters,
set_default_traversability, map_has_valid_traversability_at,
set_elevation_from_image) against the JAX estimator, on the CPU.

The veto planes recomputed by set_traversability_map are exact; a path
query on the adopted map agrees within 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

from traversability_estimation_tpu.models import FootprintPath as JaxPath
from traversability_estimation_tpu.models import TraversabilityEstimator as JaxEstimator
from traversability_estimation_tpu.utils.config import EstimatorConfig as JaxConfig
from traversability_estimation_tpu.utils.config import FootprintConfig as JaxFootprint
from traversability_estimation_tpu_torch import (
    EstimatorConfig,
    FootprintConfig,
    FootprintPath,
    TraversabilityEstimator,
)
from traversability_estimation_tpu_torch.utils.convert import config_from_fields

RES = 0.03
POSITION = (0.05, -0.1)
REQUIRED = ("elevation", "traversability", "traversability_slope", "traversability_step")


def smooth_terrain(rows, cols, seed):
    rng = np.random.default_rng(seed)
    x = np.arange(rows)[:, None] * RES
    y = np.arange(cols)[None, :] * RES
    z = (
        0.15 * np.sin(2.0 * x) * np.cos(1.5 * y)
        + 0.012 * rng.standard_normal((rows, cols))
        + 0.3 * ((x > x.mean()) & (y > y.mean()))
        + 0.05 * x
    )
    z[rng.random((rows, cols)) < 0.03] = np.nan
    return z.astype(np.float32)


@pytest.fixture(scope="module")
def source_layers():
    """Layers of one JAX update, the input both engines adopt."""
    jest = JaxEstimator(JaxConfig(resolution=RES, footprint=JaxFootprint(verify_roughness_footprint=True)))
    assert jest.update(smooth_terrain(64, 72, seed=71), position=POSITION)
    return {k: np.asarray(v) for k, v in jest.traversability_map.layers.items()}, jest


@pytest.fixture
def est():
    e = TraversabilityEstimator(EstimatorConfig(resolution=RES), device="cpu")
    assert e.update(smooth_terrain(64, 72, seed=71), position=POSITION)
    return e


@pytest.mark.parametrize("check_roughness", [False, True])
def test_set_traversability_map_matches_jax(source_layers, check_roughness):
    layers, _ = source_layers
    given = {k: layers[k] for k in REQUIRED + ("traversability_roughness",)}
    jcfg = JaxConfig(resolution=RES,
                     footprint=JaxFootprint(verify_roughness_footprint=check_roughness))
    jest = JaxEstimator(jcfg)
    test = TraversabilityEstimator(config_from_fields(jcfg), device="cpu")
    assert jest.set_traversability_map(given, POSITION) and test.set_traversability_map(given, POSITION)
    assert test.initialized
    ref = {k: np.asarray(v) for k, v in jest.traversability_map.layers.items()}
    out = test.traversability_map.to_numpy()
    assert set(out) == set(ref)
    assert ("roughness_ok" in out) == check_roughness
    for k in ref:
        assert out[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    # the veto planes were recomputed from the given layers, equal to the source's
    np.testing.assert_array_equal(out["step_ok"], layers["step_ok"])
    np.testing.assert_array_equal(test._position, np.float32(POSITION))
    np.testing.assert_array_equal(test._elevation.numpy(), layers["elevation"])
    rng = np.random.default_rng(2)
    paths = [
        (np.float32(POSITION) + rng.uniform(-0.6, 0.6, 2)
         + np.cumsum(rng.uniform(-0.05, 0.05, (5, 2)), 0)).astype(np.float32)
        for _ in range(8)
    ]
    res_j = jest.check_footprint_path([JaxPath(poses=p, radius=0.2) for p in paths])
    res_t = test.check_footprint_path([FootprintPath(poses=p, radius=0.2) for p in paths])
    assert [r.is_safe for r in res_t] == [r.is_safe for r in res_j]
    np.testing.assert_allclose([r.traversability for r in res_t],
                               [r.traversability for r in res_j], rtol=0, atol=1e-6)
    assert any(r.is_safe for r in res_t) and not all(r.is_safe for r in res_t)


@pytest.mark.parametrize("missing", REQUIRED)
def test_set_traversability_map_rejects_a_missing_layer(source_layers, missing):
    layers, _ = source_layers
    given = {k: layers[k] for k in REQUIRED if k != missing}
    jest = JaxEstimator(JaxConfig(resolution=RES))
    test = TraversabilityEstimator(EstimatorConfig(resolution=RES), device="cpu")
    assert test.set_traversability_map(given) is False
    assert jest.set_traversability_map(given) is False
    assert not test.initialized and test._map is None


def test_set_traversability_map_clears_the_field_cache(source_layers, est):
    layers, _ = source_layers
    est._circle_field(0.3, 0.15)
    assert est._field_cache
    assert est.set_traversability_map({k: layers[k] for k in REQUIRED}, POSITION)
    assert not est._field_cache


def test_reset_footprint_layers_matches_jax(source_layers, est):
    _, jest = source_layers
    est.traversability_footprint_circle()
    jest.traversability_footprint_circle()
    est._circle_field(0.3, 0.15)
    held = est.traversability_map
    assert est._field_cache and bool(torch.isfinite(held["traversability_footprint"]).any())
    est.reset_footprint_layers()
    jest.reset_footprint_layers()
    assert not est._field_cache
    for k in ("step_footprint", "slope_footprint", "traversability_footprint"):
        assert bool(torch.isnan(est.traversability_map[k]).all()), k
        assert np.isnan(np.asarray(jest.traversability_map[k])).all(), k
    assert set(est.traversability_map.layers) == set(jest.traversability_map.layers) - {"roughness_ok", "roughness_footprint"}
    # the map handed out before keeps its layer
    assert bool(torch.isfinite(held["traversability_footprint"]).any())
    assert bool(torch.isfinite(est.traversability_map["traversability"]).any())
    TraversabilityEstimator(EstimatorConfig(resolution=RES), device="cpu").reset_footprint_layers()


@pytest.mark.parametrize("value,want", [(0.9, 0.9), (-0.3, 0.0), (1.7, 1.0), (0.0, 0.0)])
def test_default_traversability_clamp_and_restore(value, want):
    cfg = EstimatorConfig(resolution=RES, footprint=FootprintConfig(traversability_default=0.4))
    test = TraversabilityEstimator(cfg, device="cpu")
    jest = JaxEstimator(JaxConfig(resolution=RES, footprint=JaxFootprint(traversability_default=0.4)))
    test.set_default_traversability(value)
    jest.set_default_traversability(value)
    assert test._traversability_default == jest._traversability_default == want
    # the next update's query state scores unknown cells with it
    assert test.update(np.full((40, 40), np.nan, np.float32))
    assert test.query_state.default_traversability == want
    test.restore_default_traversability()
    jest.restore_default_traversability()
    assert test._traversability_default == jest._traversability_default == 0.4


def test_update_parameters_takes_effect_on_the_next_update(est):
    before = est.traversability_map["traversability_step"].clone()
    new = dataclasses.replace(
        est.config,
        chain=dataclasses.replace(est.config.chain, step_critical_value=0.05),
        footprint=FootprintConfig(traversability_default=0.25),
    )
    assert est.update_parameters(new) is True
    assert est.config is new and est._traversability_default == 0.25
    assert torch.equal(est.traversability_map["traversability_step"].nan_to_num(-1),
                       before.nan_to_num(-1))
    assert est.update()
    after = est.traversability_map["traversability_step"]
    assert not torch.equal(after.nan_to_num(-1), before.nan_to_num(-1))
    jest = JaxEstimator(JaxConfig(resolution=RES))
    jnew = JaxConfig(resolution=RES, footprint=JaxFootprint(traversability_default=0.25))
    assert jest.update_parameters(jnew) and jest._traversability_default == 0.25


def test_map_has_valid_traversability_at_matches_jax(source_layers):
    _, jest = source_layers
    test = TraversabilityEstimator(EstimatorConfig(resolution=RES), device="cpu")
    assert test.map_has_valid_traversability_at(0.0, 0.0) is False
    assert test.update(smooth_terrain(64, 72, seed=71), position=POSITION)
    rng = np.random.default_rng(4)
    half = np.array([64, 72]) * RES / 2 + 0.2
    points = np.float32(POSITION) + rng.uniform(-half, half, (300, 2))
    got = [test.map_has_valid_traversability_at(float(x), float(y)) for x, y in points]
    want = [jest.map_has_valid_traversability_at(float(x), float(y)) for x, y in points]
    assert got == want
    assert any(got) and not all(got)
    # an unknown cell inside the map
    trav = test.traversability_map["traversability"]
    i, j = [int(v[0]) for v in torch.nonzero(torch.isnan(trav), as_tuple=True)]
    x, y = test.traversability_map.position_of(np.int32([i, j])).tolist()
    assert test.map_has_valid_traversability_at(x, y) is False


@pytest.mark.parametrize("scale", [1.0, 255.0])
def test_set_elevation_from_image_matches_jax(scale):
    img = np.random.default_rng(6).random((48, 40)).astype(np.float32) * scale
    img[3, 4] = np.nan
    jest = JaxEstimator(JaxConfig(resolution=RES))
    test = TraversabilityEstimator(EstimatorConfig(resolution=RES), device="cpu")
    assert jest.set_elevation_from_image(img, -0.2, 0.6, (1.0, 2.0))
    assert test.set_elevation_from_image(img, -0.2, 0.6, (1.0, 2.0))
    np.testing.assert_array_equal(test._elevation.numpy(), np.asarray(jest._elevation))
    np.testing.assert_array_equal(test._position, jest._position)
