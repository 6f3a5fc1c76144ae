"""Persistence and message ingest of the port against the JAX package's, on
the CPU: rosbag and NPZ checkpoints round-trip bit for bit (float32 planes
travel as written), a bag written by either package loads in the other, and
a grid map message is validated as the reference validates it.
"""

import numpy as np
import pytest
import torch

from traversability_estimation_tpu.models.estimator import TraversabilityEstimator as JaxEstimator
from traversability_estimation_tpu.utils import rosbag as jbag
from traversability_estimation_tpu.utils.config import EstimatorConfig as JaxConfig
from traversability_estimation_tpu_torch import EstimatorConfig, TraversabilityEstimator
from traversability_estimation_tpu_torch.utils import rosbag as tbag
from traversability_estimation_tpu_torch.utils import viz

RES = 0.03
POSITION = (0.3, -0.45)


@pytest.fixture(scope="module")
def elevation():
    from conftest import synthetic_terrain

    return synthetic_terrain(48, 60, RES, seed=9, nan_frac=0.04)


@pytest.fixture(scope="module")
def est(elevation):
    e = TraversabilityEstimator(EstimatorConfig(resolution=RES), device="cpu")
    bounds = {"upper_bound": elevation + 0.02, "lower_bound": elevation - 0.01}
    e.set_elevation_map(elevation, POSITION, extra_layers=bounds)
    assert e.update()
    return e


def _message(**overrides):
    kw = dict(frame_id="map", resolution=RES, length=(6 * RES, 5 * RES), position=(0.1, 0.2, 0.0),
              orientation=(0.0, 0.0, 0.0, 1.0), layers=[], basic_layers=[],
              data={k: np.full((6, 5), i, np.float32)
                    for i, k in enumerate(("elevation", "upper_bound", "lower_bound"))})
    kw.update(overrides)
    return tbag.GridMapMessage(**kw)


def _same(a, b):
    return np.array_equal(a, b, equal_nan=True)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("reader", ["port", "jax"])
def test_bag_modules_read_each_other(tmp_path, elevation, writer, reader):
    layers = {"elevation": elevation, "other": np.arange(48 * 60, dtype=np.float32).reshape(48, 60)}
    path = str(tmp_path / "m.bag")
    (tbag if writer == "port" else jbag).save_grid_map_bag(
        path, layers, RES, POSITION, frame_id="odom", basic_layers=("elevation",))
    msg = (tbag if reader == "port" else jbag).load_grid_map_bag(path)
    assert msg.frame_id == "odom" and msg.resolution == RES and msg.size == (48, 60)
    assert msg.position[:2] == POSITION and msg.basic_layers == ["elevation"]
    assert msg.layers == ["elevation", "other"]
    for k, v in layers.items():
        assert msg.data[k].dtype == np.float32 and _same(msg.data[k], v)


def test_bag_bytes_equal_the_jax_writer(tmp_path, elevation):
    paths = [str(tmp_path / n) for n in ("port.bag", "jax.bag")]
    for module, path in zip((tbag, jbag), paths):
        module.save_grid_map_bag(path, {"elevation": elevation}, RES, POSITION)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    with pytest.raises(ValueError, match="not a rosbag"):
        bad = tmp_path / "bad.bag"
        bad.write_bytes(b"nope")
        tbag.read_bag(str(bad))


def test_save_bag_loads_back_bit_identical(tmp_path, est):
    path = str(tmp_path / "ckpt.bag")
    est.save(path)
    msg = tbag.load_grid_map_bag(path)
    want = est.traversability_map.to_numpy()
    floats = {k for k, v in want.items() if v.dtype != np.bool_}
    assert set(msg.data) == floats and "uncertainty_range" in floats
    for k in floats:
        assert _same(msg.data[k], want[k]), k
    assert msg.frame_id == "map" and msg.basic_layers == ["traversability"]
    np.testing.assert_array_equal(np.float32(msg.position[:2]), np.float32(POSITION))

    again = TraversabilityEstimator(est.config, device="cpu")
    assert again.load_elevation_map(path)
    got = again.traversability_map.to_numpy()
    assert set(got) == set(want)  # the bounds ride along as extra layers
    for k in want:
        assert _same(got[k], want[k]), k
    np.testing.assert_array_equal(again._position, np.float32(POSITION))


def test_save_npz_round_trip(tmp_path, est):
    path = str(tmp_path / "ckpt.npz")
    est.save(path)
    with np.load(path) as blob:
        assert float(blob["resolution"]) == RES
        assert blob["layer_traversable_mask"].dtype == np.bool_
        want = est.traversability_map.to_numpy()
        assert {k[len("layer_"):] for k in blob.files if k.startswith("layer_")} == set(want)
        for k, v in want.items():
            assert _same(blob[f"layer_{k}"], v), k
    again = TraversabilityEstimator(est.config, device="cpu")
    assert again.load_elevation_map(path)
    for k in ("elevation", "traversability", "traversable_mask", "step_footprint"):
        assert _same(again.traversability_map.to_numpy()[k], want[k]), k


@pytest.mark.parametrize("suffix", [".bag", ".npz"])
def test_checkpoints_cross_the_packages(tmp_path, est, elevation, suffix):
    """A checkpoint the port saved loads in the JAX estimator, and one the JAX
    estimator saved loads in the port: the same elevation and position, and
    the recomputed step layer and veto mask equal (both exact across the
    engines)."""
    jest = JaxEstimator(JaxConfig(resolution=RES))
    ported = str(tmp_path / f"port{suffix}")
    est.save(ported)
    assert jest.load_elevation_map(ported)
    want = est.traversability_map.to_numpy()
    for k in ("elevation", "traversability_step", "traversable_mask"):
        assert _same(np.asarray(jest.traversability_map.layers[k]), want[k]), k
    np.testing.assert_array_equal(np.asarray(jest._position), np.float32(POSITION))

    from_jax = str(tmp_path / f"jax{suffix}")
    jest.save(from_jax)
    again = TraversabilityEstimator(est.config, device="cpu")
    assert again.load_elevation_map(from_jax)
    got = again.traversability_map.to_numpy()
    for k in ("elevation", "traversability_step", "traversable_mask", "traversability"):
        assert _same(got[k], want[k]), k


def test_load_failures_return_false(tmp_path, est):
    fresh = TraversabilityEstimator(est.config, device="cpu")
    assert not fresh.load_elevation_map(str(tmp_path / "missing.bag"))
    assert not fresh.load_elevation_map(str(tmp_path / "missing.npz"))
    garbage = tmp_path / "garbage.bag"
    garbage.write_bytes(b"#ROSBAG V1.2\n")
    assert not fresh.load_elevation_map(str(garbage))
    np.savez(str(tmp_path / "empty.npz"), other=np.zeros(3))
    assert not fresh.load_elevation_map(str(tmp_path / "empty.npz"))
    assert not fresh.initialized
    with pytest.raises(RuntimeError, match="nothing to save"):
        fresh.save(str(tmp_path / "x.bag"))


@pytest.mark.parametrize("case", ["accepted", "no_frame", "wrong_frame", "missing_bound",
                                  "raw_missing_variance", "raw_complete"])
def test_set_elevation_map_msg_validation(case):
    raw_layers = ("elevation", "variance", "horizontal_variance_x", "horizontal_variance_y",
                  "horizontal_variance_xy", "time")
    raw_data = {k: np.zeros((6, 5), np.float32) for k in raw_layers}
    msg, use_raw, accepted = {
        "accepted": (_message(), False, True),
        "no_frame": (_message(frame_id=""), False, True),
        "wrong_frame": (_message(frame_id="odom"), False, False),
        "missing_bound": (_message(data={"elevation": np.zeros((6, 5), np.float32),
                                         "upper_bound": np.zeros((6, 5), np.float32)}), False, False),
        "raw_missing_variance": (_message(), True, False),
        "raw_complete": (_message(data=raw_data), True, True),
    }[case]
    e = TraversabilityEstimator(EstimatorConfig(resolution=RES, use_raw_map=use_raw), device="cpu")
    j = JaxEstimator(JaxConfig(resolution=RES, use_raw_map=use_raw))
    assert e.set_elevation_map_msg(msg) == j.set_elevation_map_msg(msg) == accepted
    if accepted:
        assert torch.equal(e._elevation, torch.from_numpy(msg.data["elevation"]))
        np.testing.assert_array_equal(e._position, np.float32(msg.position[:2]))
        assert set(e._extra_layers) == set(msg.data) - {"elevation"}
        assert e.update() and set(msg.data) <= set(e.traversability_map.layers)
    else:
        assert e._elevation is None


def test_initialize_from_grid_map_msg_pads_missing_layers():
    msg = _message(data={"elevation": np.ones((6, 5), np.float32)}, frame_id="anything")
    e = TraversabilityEstimator(EstimatorConfig(resolution=RES), device="cpu")
    assert e.initialize_from_grid_map_msg(msg) and e.update()
    for k in ("upper_bound", "lower_bound", "uncertainty_range"):
        assert torch.equal(e.traversability_map[k], torch.zeros(6, 5)), k


def test_dump_layers_writes_png_and_npy(tmp_path, est):
    layers = {k: v for k, v in est.traversability_map.to_numpy().items() if v.dtype != np.bool_}
    written = viz.dump_layers(layers, str(tmp_path / "png"))
    assert len(written) == len(layers)
    for path in written:
        assert open(path, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    back = np.load(str(tmp_path / "png" / "map_traversability.npy"))
    assert _same(back, layers["traversability"])
    rgb = viz.layer_to_rgb(layers["traversability"])
    assert rgb.shape == (48, 60, 3) and rgb.dtype == np.uint8
    assert (rgb[np.isnan(layers["traversability"])] == 128).all()
