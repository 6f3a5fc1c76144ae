"""The port's grid_map_visualization helpers (``utils/viz.py``) against the
JAX package's on the same inputs, on the CPU: occupancy grids (inverted and
plain ranges, a zero span, NaN, clamping), point clouds (extra channels, a
map position), and the YAML runner, which the port also runs on documents
already loaded (no PyYAML needed) and which must give what the JAX runner
gives on the same document written to a file.
"""

import numpy as np
import pytest

from traversability_estimation_tpu.utils import viz as jviz
from traversability_estimation_tpu_torch.utils import viz

# the reference's visualization/traversability.yaml, as loaded
DOCUMENT = {
    "grid_map_visualizations": [
        {"name": "traversability_map", "type": "occupancy_grid",
         "params": {"layer": "traversability", "data_min": 1.0, "data_max": 0.0}},
        {"name": "slope_map", "type": "occupancy_grid",
         "params": {"layer": "traversability_slope", "data_min": 1.0, "data_max": 0.0}},
        {"name": "step_map", "type": "occupancy_grid",
         "params": {"layer": "traversability_step", "data_min": 1.0, "data_max": 0.0}},
        {"name": "roughness_map", "type": "occupancy_grid",
         "params": {"layer": "traversability_roughness", "data_min": 1.0, "data_max": 0.0}},
        {"name": "traversability_cloud", "type": "point_cloud",
         "params": {"layer": "elevation"}},
    ]
}


def _layers(rows=8, cols=9, seed=0):
    rng = np.random.default_rng(seed)
    out = {name: (1.4 * rng.random((rows, cols)) - 0.2).astype(np.float32)
           for name in ("traversability", "traversability_slope", "traversability_step",
                        "traversability_roughness", "elevation")}
    for v in out.values():
        v[rng.random((rows, cols)) < 0.1] = np.nan
    return out


@pytest.mark.parametrize("data_min, data_max", [(1.0, 0.0), (0.0, 1.0), (0.5, 0.5), (-1.0, 2.0)])
def test_occupancy_grid_equals_jax(data_min, data_max):
    layer = _layers()["traversability"]
    got = viz.occupancy_grid(layer, data_min, data_max)
    want = jviz.occupancy_grid(layer, data_min, data_max)
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert (got[np.isnan(layer)] == -1).all()


@pytest.mark.parametrize("position, extra", [
    ((0.0, 0.0), ()),
    ((1.0, -2.0), ("traversability", "traversability_step")),
])
def test_point_cloud_equals_jax(position, extra):
    layers = _layers(6, 7, seed=3)
    got = viz.point_cloud(layers, "elevation", 0.1, position, extra_layers=extra)
    want = jviz.point_cloud(layers, "elevation", 0.1, position, extra_layers=extra)
    assert got.dtype == want.dtype
    assert len(got) == int(np.isfinite(layers["elevation"]).sum())
    for name in got.dtype.names:
        np.testing.assert_array_equal(got[name], want[name])


def test_yaml_runner_on_documents_and_files(tmp_path):
    yaml = pytest.importorskip("yaml")
    path = tmp_path / "traversability.yaml"
    path.write_text(yaml.safe_dump(DOCUMENT))
    layers = _layers()
    got = viz.visualizations_from_yaml(DOCUMENT, layers, 0.03, (0.2, 0.1))
    assert set(got) == {"traversability_map", "slope_map", "step_map", "roughness_map",
                        "traversability_cloud"}
    for runs in (jviz.visualizations_from_yaml(str(path), layers, 0.03, (0.2, 0.1)),
                 viz.visualizations_from_yaml(str(path), layers, 0.03, (0.2, 0.1))):
        assert set(runs) == set(got)
        for k, v in runs.items():
            assert v.dtype == got[k].dtype
            if v.dtype.names:
                for name in v.dtype.names:
                    np.testing.assert_array_equal(v[name], got[k][name])
            else:
                np.testing.assert_array_equal(v, got[k])
    # absent layers are skipped, not an error
    only = viz.visualizations_from_yaml(DOCUMENT, {"elevation": layers["elevation"]}, 0.03)
    assert set(only) == {"traversability_cloud"}
    assert viz.visualizations_from_yaml({}, layers, 0.03) == {}
