"""Untraversable polygons and the inclination check of the port against the
JAX package's, on the CPU (mirrors tests/test_untraversable.py on a synthetic
map: a smooth field with a wall, a pit and holes, so checks fail in places).

Both estimators adopt ONE set of traversability layers
(``set_traversability_map``), so they query identical map state. Bars:
``is_safe`` equal; polygons equal to 1e-12 (both extract them on the host in
float64 from equal veto planes, with their own copies of the geometry);
traversability within 2e-5; inclination verdicts equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traversability_estimation_tpu.models import untraversable as junt
from traversability_estimation_tpu.models.estimator import FootprintPath as JaxPath
from traversability_estimation_tpu.models.estimator import TraversabilityEstimator as JaxEstimator
from traversability_estimation_tpu.ops import footprint as jfp
from traversability_estimation_tpu.utils.config import EstimatorConfig as JaxConfig
from traversability_estimation_tpu.utils.config import FootprintConfig as JaxFootprint
from traversability_estimation_tpu_torch import FootprintPath, TraversabilityEstimator
from traversability_estimation_tpu_torch.grid import geometry as tgeo
from traversability_estimation_tpu_torch.models import untraversable as tunt
from traversability_estimation_tpu_torch.node import TraversabilityNode
from traversability_estimation_tpu_torch.ops import footprint as tfp
from traversability_estimation_tpu_torch.utils.convert import config_from_fields

RES = 0.03
POSITION = (0.2, -0.1)
RADIUS, OFFSET, DEFAULT = 0.2, 0.15, 0.5
RECT = np.float32([[0.2, 0.12], [0.2, -0.12], [-0.2, -0.12], [-0.2, 0.12]])


def _terrain(rows=110, cols=130, seed=2):
    rng = np.random.default_rng(seed)
    x = np.arange(rows)[:, None] * RES
    y = np.arange(cols)[None, :] * RES
    z = 0.05 * np.sin(1.5 * x) * np.cos(1.2 * y) + 0.004 * rng.standard_normal((rows, cols))
    z[:, 60:64] += 0.4  # a wall
    z[70:78, 20:30] -= 0.5  # a pit
    z[rng.random((rows, cols)) < 0.01] = np.nan
    return z.astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """(JAX estimator, port estimator) holding the same layers."""
    jcfg = JaxConfig(resolution=RES)
    source = JaxEstimator(jcfg)
    assert source.update(_terrain(), position=POSITION)
    layers = {k: np.asarray(v) for k, v in source.traversability_map.layers.items()
              if np.asarray(v).dtype != np.bool_}
    jest = JaxEstimator(jcfg)
    test = TraversabilityEstimator(config_from_fields(jcfg), device="cpu")
    assert jest.set_traversability_map(layers, POSITION)
    assert test.set_traversability_map(layers, POSITION)
    fail = ~np.asarray(jest.query_state.traversable_mask)
    np.testing.assert_array_equal(test._fail_mask_host(), fail)
    assert 0.02 < fail.mean() < 0.6
    return jest, test, fail


def _paths(rng, n_paths, n_max, step):
    starts = np.float64(POSITION) + rng.uniform(-1.3, 1.3, (n_paths, 2))
    steps = rng.uniform(-step, step, (n_paths, n_max - 1, 2))
    poses = np.concatenate([starts[:, None], starts[:, None] + np.cumsum(steps, 1)], 1)
    return poses, rng.integers(1, n_max + 1, n_paths)


def _assert_polygons(got, want, label):
    if want is None:
        assert got is None, label
        return
    assert got is not None, label
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-12,
                               err_msg=label)


def test_host_geometry_copies_match():
    from traversability_estimation_tpu.grid import geometry as jgeo

    rng = np.random.default_rng(0)
    for _ in range(50):
        a, b = rng.integers(-40, 40, 2), rng.integers(-40, 40, 2)
        np.testing.assert_array_equal(tgeo.line_cells_np(a, b), jgeo.line_cells_np(a, b))
        pts = np.round(rng.uniform(-1, 1, (rng.integers(1, 30), 2)), 1)  # collinear runs
        np.testing.assert_array_equal(tgeo.convex_hull_np(pts), jgeo.convex_hull_np(pts))
    np.testing.assert_array_equal(
        tgeo.polygon_from_circle(np.float64([0.3, -0.2]), 0.35),
        jgeo.polygon_from_circle(np.float64([0.3, -0.2]), 0.35))


def test_circular_module_matches_jax(pair):
    _, _, fail = pair
    poses, n_poses = _paths(np.random.default_rng(1), 40, 3, 0.35)
    n_polygons = 0
    for p in range(len(poses)):
        args = (fail, RES, POSITION, poses[p, : n_poses[p]], RADIUS, OFFSET, DEFAULT)
        want = junt.circular_path_untraversable_polygon(*args)
        _assert_polygons(tunt.circular_path_untraversable_polygon(*args), want, f"path {p}")
        n_polygons += want is not None
        got_streams, want_streams = tunt.circular_path_polygons(*args), junt.circular_path_polygons(*args)
        assert got_streams[2] == want_streams[2]
        for g, w in zip(got_streams[:2], want_streams[:2]):
            assert len(g) == len(w)
            for gi, wi in zip(g, w):
                _assert_polygons(gi, wi, f"stream {p}")
    assert n_polygons >= 5
    off_map = tunt.circular_path_untraversable_polygon(
        fail, RES, POSITION, np.float64([[50.0, 50.0]]), RADIUS, OFFSET, 0.0)
    assert off_map is not None and len(off_map) == 20  # the 20-gon circle outline


@pytest.mark.parametrize("conservative", [False, True])
def test_polygonal_module_matches_jax(pair, conservative):
    _, _, fail = pair
    rng = np.random.default_rng(3)
    poses, n_poses = _paths(rng, 32, 3, 0.3)
    pos3 = np.concatenate([poses, np.full(poses.shape[:2] + (1,), 0.4)], -1)
    yaw = rng.uniform(0, 2 * np.pi, poses.shape[:2])
    quats = np.zeros(poses.shape[:2] + (4,))
    quats[..., 2], quats[..., 3] = np.sin(yaw / 2), np.cos(yaw / 2)
    n_polygons = 0
    for p in range(len(poses)):
        n = n_poses[p]
        args = (fail, RES, POSITION, pos3[p, :n], quats[p, :n], RECT.astype(np.float64),
                conservative, DEFAULT)
        want = junt.polygonal_path_untraversable_polygon(*args)
        _assert_polygons(tunt.polygonal_path_untraversable_polygon(*args), want, f"path {p}")
        n_polygons += want is not None
        fps, ups, z = tunt.polygonal_path_polygons(*args)
        assert z == pytest.approx(0.4) and len(fps) >= 1 and len(ups) <= 1
    assert n_polygons >= 5


def test_estimator_results_carry_jax_polygons(pair):
    """check_footprint_path with compute_untraversable_polygon, circular and
    polygonal paths mixed in one request."""
    jest, test, _ = pair
    rng = np.random.default_rng(4)
    poses, n_poses = _paths(rng, 36, 4, 0.25)
    jpaths, tpaths = [], []
    for p in range(len(poses)):
        pp = poses[p, : n_poses[p]].astype(np.float32)
        kw = dict(compute_untraversable_polygon=p % 5 != 0)
        if p % 3 == 0:
            kw.update(footprint=RECT, conservative=p % 2 == 0)
        else:
            kw.update(radius=RADIUS)
        jpaths.append(JaxPath(poses=pp, **kw))
        tpaths.append(FootprintPath(poses=pp, **kw))
    want, got = jest.check_footprint_path(jpaths), test.check_footprint_path(tpaths)
    n_polygons = 0
    for p, (g, w) in enumerate(zip(got, want)):
        assert g.is_safe == w.is_safe, p
        assert abs(g.traversability - w.traversability) <= 2e-5, p
        _assert_polygons(g.untraversable_polygon, w.untraversable_polygon, f"path {p}")
        if g.is_safe or not tpaths[p].compute_untraversable_polygon:
            assert g.untraversable_polygon is None
        n_polygons += g.untraversable_polygon is not None
    assert n_polygons >= 5 and any(r.is_safe for r in got)


def test_path_polygons_match_jax(pair):
    jest, test, _ = pair
    poses, n_poses = _paths(np.random.default_rng(6), 12, 4, 0.3)
    for p in range(len(poses)):
        pp = poses[p, : n_poses[p]]
        for kw in (dict(radius=RADIUS), dict(footprint=RECT, conservative=bool(p % 2))):
            want = jest.path_polygons(JaxPath(poses=pp, **kw))
            got = test.path_polygons(FootprintPath(poses=pp, **kw))
            assert got[2] == want[2]
            for g, w in zip(got[:2], want[:2]):
                assert len(g) == len(w)
                for gi, wi in zip(g, w):
                    _assert_polygons(gi, wi, f"path {p}")
    assert test.path_polygons(FootprintPath(poses=np.zeros((0, 2)))) == ([], [], 0.0)
    fresh = TraversabilityEstimator(test.config, device="cpu")
    assert fresh.path_polygons(FootprintPath(poses=np.zeros((1, 2)), radius=0.1)) == ([], [], 0.0)


def test_inclination_verdicts_match_jax(pair):
    """check_inclination_paths of both packages, and the estimators' gate
    with a robot_slope layer that is 0 in a band."""
    jest, test, _ = pair
    rng = np.random.default_rng(8)
    rows, cols = test.query_state.shape
    robot_slope = rng.uniform(0.1, 1.0, (rows, cols)).astype(np.float32)
    robot_slope[40:44, :] = 0.0
    robot_slope[rng.random((rows, cols)) < 0.05] = np.nan
    poses, n_poses = _paths(rng, 64, 4, 0.3)
    poses = poses.astype(np.float32)
    n_poses = n_poses.astype(np.int32)
    for p in range(len(poses)):
        poses[p, n_poses[p]:] = poses[p, n_poses[p] - 1]
    max_cells = test._max_segment_cells(poses, n_poses)
    want = np.asarray(jfp.check_inclination_paths(
        jest.query_state, jnp.asarray(robot_slope), jnp.asarray(poses), jnp.asarray(n_poses),
        max_cells))
    got = tfp.check_inclination_paths(
        test.query_state, torch.from_numpy(robot_slope), poses, n_poses, max_cells).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < len(want)
    one = tfp.check_inclination_paths(
        test.query_state, torch.from_numpy(robot_slope), poses[:, :1], np.ones(64, np.int32), 4)
    np.testing.assert_array_equal(one.numpy(), np.asarray(jfp.check_inclination_paths(
        jest.query_state, jnp.asarray(robot_slope), jnp.asarray(poses[:, :1]),
        jnp.ones(64, jnp.int32), 4)))

    # the estimators' gate: configured and the layer present
    jcfg = dataclasses.replace(
        jest.config, footprint=JaxFootprint(check_robot_inclination=True))
    layers = {k: np.asarray(v) for k, v in jest.traversability_map.layers.items()
              if np.asarray(v).dtype != np.bool_}
    layers["robot_slope"] = robot_slope
    jgate = JaxEstimator(jcfg)
    tgate = TraversabilityEstimator(config_from_fields(jcfg), device="cpu")
    assert jgate.set_traversability_map(layers, POSITION)
    assert tgate.set_traversability_map(layers, POSITION)
    kinds = [dict(radius=0.1), dict(footprint=RECT * 0.5)]
    jpaths = [JaxPath(poses=poses[p, : n_poses[p]], **kinds[p % 2]) for p in range(64)]
    tpaths = [FootprintPath(poses=poses[p, : n_poses[p]], **kinds[p % 2]) for p in range(64)]
    gated = tgate.check_footprint_path(tpaths)
    for g, w in zip(gated, jgate.check_footprint_path(jpaths)):
        assert g.is_safe == w.is_safe and abs(g.traversability - w.traversability) <= 2e-5
        assert abs(g.area - w.area) <= 1e-5 * abs(w.area) + 1e-6
    ungated = test.check_footprint_path(tpaths)
    flipped = [u.is_safe and not g.is_safe for u, g in zip(ungated, gated)]
    assert any(flipped)  # the gate alone fails some paths
    assert all(g.traversability == 0.0 for g, f in zip(gated, flipped) if f)


def test_node_polygon_topics(pair):
    """footprint_polygon / untraversable_polygon: latched, published per
    checked path when subscribers exist."""
    _, test, fail = pair
    node = TraversabilityNode(test.config, device="cpu")
    layers = {k: v for k, v in test.traversability_map.to_numpy().items() if v.dtype != np.bool_}
    assert node.estimator.set_traversability_map(layers, POSITION)
    got_fp, got_up = [], []
    node.subscribe_footprint_polygon(got_fp.append)
    node.subscribe_untraversable_polygon(got_up.append)
    ii, jj = np.nonzero(fail)
    rows, cols = fail.shape
    p0 = np.float64(POSITION) + np.array([rows, cols]) * RES / 2.0
    bad = p0 - (np.array([ii[len(ii) // 2], jj[len(jj) // 2]]) + 0.5) * RES
    results = node.check_footprint_path(
        FootprintPath(poses=np.array([bad]), radius=0.2, compute_untraversable_polygon=True))
    assert not results[0].is_safe and results[0].untraversable_polygon is not None
    assert len(got_fp) == 1 and len(got_fp[0].vertices) == 20
    assert got_fp[0].z == 0.0 and got_fp[0].frame_id == "map"
    assert len(got_up) == 1
    late = []
    node.subscribe_untraversable_polygon(late.append)  # latched
    assert len(late) == 1
    np.testing.assert_array_equal(late[0].vertices, got_up[0].vertices)
    # without the flag: a footprint, no untraversable publication
    node.check_footprint_path(FootprintPath(poses=np.array([bad]), radius=0.2))
    assert len(got_up) == 1 and len(got_fp) == 2
    # a polygonal multi-pose path publishes its hulls at the robot's height
    poses3 = np.array([[*(bad + [0.5, 0.0]), 0.4], [*bad, 0.4]])
    node.check_footprint_path(FootprintPath(poses=poses3, footprint=RECT))
    assert got_fp[-1].z == pytest.approx(0.4)
