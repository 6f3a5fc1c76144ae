"""The port's declarative filter chain (ops/chain.py) and generic map update
against the JAX package's, on the CPU.

Every filter type runs through both packages' ``compile_chain`` on the same
elevation (the JAX side jitted, as its estimator runs it). Bars, those of
test_torch_filters.py: step layers, thresholds, duplications, min / max in
radius and every veto plane exact; slope 5e-5; normals' z 1e-5; roughness,
fused layers and the mean in radius 2e-4 (XLA:CPU contracts ``a*b + c``
across the chain, the port does not).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traversability_estimation_tpu.models.estimator import TraversabilityEstimator as JaxEstimator
from traversability_estimation_tpu.models.estimator import _update_step_generic as jax_generic
from traversability_estimation_tpu.ops import chain as jchain
from traversability_estimation_tpu.utils import config as jconfig
from traversability_estimation_tpu_torch import TraversabilityEstimator
from traversability_estimation_tpu_torch.models.estimator import _update_step_generic
from traversability_estimation_tpu_torch.ops import chain as tchain
from traversability_estimation_tpu_torch.ops import update_kernel
from traversability_estimation_tpu_torch.utils import config as tconfig
from traversability_estimation_tpu_torch.utils.convert import config_from_fields

RES = 0.03
NORMALS = {"name": "n", "type": "gridMapFilters/NormalVectorsFilter", "params": {"radius": 0.05}}

# name -> (filter list, {output layer: atol; 0 exact})
CHAINS = {
    "NormalVectorsFilter": (
        [{"name": "n", "type": "gridMapFilters/NormalVectorsFilter",
          "params": {"radius": 0.07, "output_layers_prefix": "nrm_"}}],
        {"nrm_z": 1e-5},
    ),
    "SlopeFilter": (
        [NORMALS, {"name": "s", "type": "traversabilityFilters/SlopeFilter",
                   "params": {"critical_value": 0.8, "map_type": "my_slope"}}],
        {"my_slope": 5e-5},
    ),
    "StepFilter": (
        [{"name": "s", "type": "traversabilityFilters/StepFilter",
          "params": {"critical_value": 0.1, "first_window_radius": 0.05,
                     "second_window_radius": 0.06, "critical_cell_number": 3}}],
        {"traversability_step": 0.0},
    ),
    "RoughnessFilter": (
        [NORMALS, {"name": "r", "type": "traversabilityFilters/RoughnessFilter",
                   "params": {"critical_value": 0.06, "estimation_radius": 0.08}}],
        {"traversability_roughness": 2e-4},
    ),
    "MathExpressionFilter": (
        [{"name": "m", "type": "gridMapFilters/MathExpressionFilter",
          "params": {"expression": "min(abs(elevation), 0.5) - elevation", "output_layer": "e2"}}],
        {"e2": 0.0},
    ),
    "DeletionFilter": (
        [NORMALS, {"name": "d", "type": "gridMapFilters/DeletionFilter",
                   "params": {"layers": ["surface_normal_x", "surface_normal_y"]}}],
        {"surface_normal_z": 1e-5},
    ),
    "DuplicationFilter": (
        [{"name": "d", "type": "gridMapFilters/DuplicationFilter",
          "params": {"input_layer": "elevation", "output_layer": "copy"}}],
        {"copy": 0.0},
    ),
    "ThresholdFilter": (
        [{"name": "lo", "type": "gridMapFilters/ThresholdFilter",
          "params": {"layer": "elevation", "output_layer": "clipped", "lower_threshold": 0.05,
                     "set_to": 0.05}},
         {"name": "hi", "type": "gridMapFilters/ThresholdFilter",
          "params": {"condition_layer": "elevation", "output_layer": "clipped",
                     "upper_threshold": 0.3, "set_to": 1.0}}],
        {"clipped": 0.0},
    ),
    "MeanInRadiusFilter": (
        [{"name": "m", "type": "gridMapFilters/MeanInRadiusFilter",
          "params": {"input_layer": "elevation", "output_layer": "smooth", "radius": 0.07}}],
        {"smooth": 2e-4},
    ),
    "MinInRadiusFilter": (
        [{"name": "m", "type": "gridMapFilters/MinInRadiusFilter",
          "params": {"input_layer": "elevation", "output_layer": "lo", "radius": 0.07}}],
        {"lo": 0.0},
    ),
    "MaxInRadiusFilter": (
        [{"name": "m", "type": "gridMapFilters/MaxInRadiusFilter",
          "params": {"input_layer": "elevation", "output_layer": "hi", "radius": 0.07}}],
        {"hi": 0.0},
    ),
    "SetBasicLayersFilter": (
        [{"name": "b", "type": "gridMapFilters/SetBasicLayersFilter",
          "params": {"layers": ["elevation"]}}],
        {"elevation": 0.0},
    ),
}

# a chain the fused update cannot represent: smoothing first, custom names,
# and a fused layer that the vetoes never see under the canonical names
CUSTOM = [
    {"name": "smooth", "type": "gridMapFilters/MeanInRadiusFilter",
     "params": {"input_layer": "elevation", "output_layer": "elevation_smooth", "radius": 0.05}},
    NORMALS,
    {"name": "slope", "type": "traversabilityFilters/SlopeFilter",
     "params": {"critical_value": 1.0}},
    {"name": "step", "type": "traversabilityFilters/StepFilter",
     "params": {"critical_value": 0.12, "first_window_radius": 0.04,
                "second_window_radius": 0.04, "critical_cell_number": 4}},
    {"name": "fuse", "type": "gridMapFilters/MathExpressionFilter",
     "params": {"expression": "0.5 * (traversability_slope + traversability_step)",
                "output_layer": "traversability"}},
    {"name": "drop", "type": "gridMapFilters/DeletionFilter",
     "params": {"layers": ["surface_normal_x", "surface_normal_y", "surface_normal_z"]}},
]


@pytest.fixture(scope="module")
def elevation():
    from conftest import synthetic_terrain

    return synthetic_terrain(56, 72, RES, seed=4, nan_frac=0.06)


def _assert_layer(want, got, atol, name):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape, name
    if atol == 0.0:
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    assert (np.isfinite(want) == np.isfinite(got)).all(), name
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=atol, err_msg=name)


def test_registries_list_the_same_filters():
    assert tchain.available_filters() == jchain.available_filters()
    assert set(CHAINS) == {t.split("/")[1] for t in tchain.available_filters()}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_filter_matches_jax(elevation, name):
    filters, bars = CHAINS[name]
    jspecs = tuple(jchain.FilterSpec.from_dict(f) for f in filters)
    tspecs = tuple(tchain.FilterSpec.from_dict(f) for f in filters)
    assert [dataclasses.astuple(s) for s in tspecs] == [dataclasses.astuple(s) for s in jspecs]
    ref = jchain.run_spec_chain_jit({"elevation": jnp.asarray(elevation)}, jspecs, RES)
    out = tchain.run_spec_chain({"elevation": torch.from_numpy(elevation.copy())}, tspecs, RES)
    assert set(out) == set(ref)
    for layer, atol in bars.items():
        assert out[layer].dtype == torch.float32
        _assert_layer(ref[layer], out[layer].numpy(), atol, layer)


def test_compile_errors_match():
    for module in (tchain, jchain):
        with pytest.raises(module.ChainCompileError, match="unknown filter type"):
            module.compile_chain([{"name": "x", "type": "nope/Filter"}], RES)
        with pytest.raises(module.ChainCompileError, match="empty expression"):
            module.compile_chain([{"name": "m", "type": "gridMapFilters/MathExpressionFilter"}], RES)
        with pytest.raises(module.ChainCompileError, match="need layer"):
            module.compile_chain([{"name": "t", "type": "gridMapFilters/ThresholdFilter"}], RES)
    slope_only = tchain.compile_chain([CHAINS["SlopeFilter"][0][1]], RES)
    with pytest.raises(tchain.ChainCompileError, match="surface normals"):
        slope_only({"elevation": torch.zeros(4, 4)})


def test_register_filter_extends_the_chain():
    def factory(spec, res):
        gain = float(spec.param("gain", 1.0))
        return lambda layers: {**layers, "scaled": layers["elevation"] * gain}

    tchain.register_filter("test/ScaleFilter", factory)
    try:
        out = tchain.run_spec_chain(
            {"elevation": torch.ones(3, 3)},
            (tchain.FilterSpec.from_dict(
                {"name": "s", "type": "test/ScaleFilter", "params": {"gain": 2.5}}),),
            RES,
        )
        assert torch.equal(out["scaled"], torch.full((3, 3), 2.5))
    finally:
        del tchain._REGISTRY["test/ScaleFilter"]


CANONICAL = tconfig.reference_documents()["filters"]
ROUTES = {
    "reference": (CANONICAL, True),
    "no_deletion": (CANONICAL[:5], True),
    "custom": (CUSTOM, False),
    "reordered": ([CANONICAL[0], CANONICAL[2], CANONICAL[1], *CANONICAL[3:]], False),
    "duplicate": ([*CANONICAL[:2], CANONICAL[1], *CANONICAL[2:]], False),
    "renamed_output": (
        [*CANONICAL[:4],
         {**CANONICAL[4], "params": {**CANONICAL[4]["params"], "output_layer": "fused"}}], False),
    "deletes_a_layer": (
        [*CANONICAL[:5], {"name": "d", "type": "gridMapFilters/DeletionFilter",
                          "params": {"layers": ["traversability_step"]}}], False),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_is_canonical_routing_matches_jax(name):
    filters, canonical = ROUTES[name]
    tspecs = tuple(tchain.FilterSpec.from_dict(f) for f in filters)
    jspecs = tuple(jchain.FilterSpec.from_dict(f) for f in filters)
    assert tconfig._is_canonical(tspecs) == jconfig._is_canonical(jspecs) == canonical
    cfg = tconfig.config_from_documents(filters=filters, resolution=RES)
    assert cfg.use_generic_chain == (not canonical) and len(cfg.filter_specs) == len(filters)


def _generic_configs():
    tcfg = tconfig.config_from_documents(filters=CUSTOM, resolution=RES)
    assert tcfg.use_generic_chain
    jcfg = jconfig.EstimatorConfig(
        resolution=RES,
        chain=jconfig._chain_from_filter_list(CUSTOM, RES),
        filter_specs=tuple(jchain.FilterSpec.from_dict(f) for f in CUSTOM),
        use_generic_chain=True,
    )
    return jcfg, tcfg


FLOAT_BARS = {"traversability_slope": 5e-5, "traversability": 2e-4, "elevation_smooth": 2e-4}


def test_generic_update_matches_jax(elevation):
    """``_update_step_generic`` of both packages: step and every veto plane
    exact, float layers at the chain's bars; no roughness layer, so its NaN
    stand-in passes every veto in both."""
    jcfg, tcfg = _generic_configs()
    ref = jax_generic(jnp.asarray(elevation), jcfg.filter_specs, RES, jcfg.veto)
    out = _update_step_generic(
        torch.from_numpy(elevation.copy()), tcfg.filter_specs, RES, tcfg.veto)
    assert set(out) == set(ref) and "traversability_roughness" not in out
    for k, want in ref.items():
        want = np.asarray(want)
        assert out[k].numpy().dtype == want.dtype, k
        _assert_layer(want, out[k].numpy(), FLOAT_BARS.get(k, 0.0), k)


def test_estimator_routes_a_generic_chain_like_jax(elevation):
    """update() takes the generic chain (its extra layer appears on the map);
    the incremental refresh and the fused tick's fallback run the canonical
    chain on the crop, as the JAX package's do; config_from_fields carries
    the specs across."""
    jcfg, tcfg = _generic_configs()
    carried = config_from_fields(jcfg)
    assert carried.use_generic_chain and carried.filter_specs == tcfg.filter_specs
    jest, test = JaxEstimator(jcfg), TraversabilityEstimator(carried, device="cpu")
    assert jest.update(elevation) and test.update(elevation)
    ref, out = jest.traversability_map.layers, test.traversability_map.layers
    assert set(out) == set(ref) and "elevation_smooth" in out
    for k in ref:
        _assert_layer(np.asarray(ref[k]), out[k].numpy(), FLOAT_BARS.get(k, 0.0), k)
    patch = elevation[10:30, 20:44] + np.float32(0.01)
    poses = np.float32([[[0.0, 0.0], [0.1, 0.1]]])
    before = update_kernel.fused_update.launches
    safe_t, trav_t = test.online_tick(patch, (0.1, -0.1), poses, np.int32([2]), radius=0.1)
    safe_j, trav_j = jest.online_tick(patch, (0.1, -0.1), poses, np.int32([2]), radius=0.1)
    assert update_kernel.fused_update.launches == before  # the CPU runs the plain version
    # the unfused sequence, not the fused tick (which keeps its query crop)
    assert not any(k[0] == "tick_crop" for k in test._epoch.fields)
    assert bool(safe_t[0]) == bool(np.asarray(safe_j)[0])
    np.testing.assert_allclose(float(trav_t[0]), float(np.asarray(trav_j)[0]), atol=2e-4)
    ref, out = jest.traversability_map.layers, test.traversability_map.layers
    assert set(out) == set(ref)
    for k in ("elevation", "traversability_step", "traversable_mask", "step_ok", "slope_ok"):
        _assert_layer(np.asarray(ref[k]), out[k].numpy(), 0.0, k)
    _assert_layer(np.asarray(ref["traversability"]), out["traversability"].numpy(), 2e-4, "trav")


def test_reference_chain_generic_equals_fused(elevation):
    """The reference's filter list through the generic chain gives the fused
    update's layers exactly (the port runs the same torch ops both ways)."""
    cfg = tconfig.config_from_documents(filters=CANONICAL, resolution=RES)
    elev = torch.from_numpy(elevation.copy())
    generic = _update_step_generic(elev, cfg.filter_specs, RES, cfg.veto)
    fused = update_kernel.fused_update(elev, cfg.chain, cfg.veto)
    assert set(generic) == set(fused)
    for k in fused:
        _assert_layer(fused[k].numpy(), generic[k].numpy(), 0.0, k)
    ref = jax.jit(lambda e: jchain.compile_chain(CANONICAL, RES)({"elevation": e}))(
        jnp.asarray(elevation))
    _assert_layer(ref["traversability"], generic["traversability"].numpy(), 2e-4, "traversability")
