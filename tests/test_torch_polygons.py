"""The port's polygonal footprint evaluators, window planners and dense
footprint services against jitted JAX, on the CPU.

Both engines query one map state: the port's update of a 96 x 120 map,
handed to the JAX functions as their query state, so the comparison isolates
the polygonal machinery. Verdicts, cell counts, hull vertices and window
sizes are exact; traversability within 2e-5 and areas within rtol 1e-5 (the
window sums and shoelace terms are added in another order); dense layer
scores within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traversability_estimation_tpu.models import estimator as jest_mod
from traversability_estimation_tpu.ops import footprint as jfp
from traversability_estimation_tpu.utils.config import EstimatorConfig as JaxConfig
from traversability_estimation_tpu.utils.config import FootprintConfig as JaxFootprint
from traversability_estimation_tpu_torch import TraversabilityEstimator
from traversability_estimation_tpu_torch.ops import footprint as tfp
from traversability_estimation_tpu_torch.utils.convert import config_from_fields

RES = 0.03
POSITION = np.float32([0.05, -0.1])
RECT = np.float32([[0.45, 0.3], [0.45, -0.3], [-0.45, -0.3], [-0.45, 0.3]])
HEXAGON = np.float32(
    [[0.4, 0.0], [0.2, 0.3], [-0.2, 0.3], [-0.4, 0.0], [-0.2, -0.3], [0.2, -0.3]]
)
L_SHAPE = np.float32(
    [[0.4, 0.3], [0.4, -0.3], [-0.4, -0.3], [-0.4, 0.0], [0.0, 0.0], [0.0, 0.3]]
)


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
    z[rng.random((rows, cols)) < 0.02] = np.nan
    return z.astype(np.float32)


@pytest.fixture(scope="module")
def engines():
    """(JAX estimator, port estimator) on the port's map state."""
    # a small configured footprint: the dense polygonal service unrolls one
    # shifted reduction per covered cell, which JAX compiles slowly
    small = tuple(map(tuple, (0.5 * RECT).tolist()))
    jcfg = JaxConfig(resolution=RES, footprint=JaxFootprint(footprint_polygon=small))
    test = TraversabilityEstimator(config_from_fields(jcfg), device="cpu")
    assert test.update(smooth_terrain(96, 120, seed=7), position=POSITION)
    qs = test.query_state
    jest = jest_mod.TraversabilityEstimator(jcfg)
    jest._query_state = jfp.QueryState(
        traversability=jnp.asarray(qs.traversability.numpy()),
        traversable_mask=jnp.asarray(qs.traversable_mask.numpy()),
        position=jnp.asarray(POSITION), resolution=RES,
        default_traversability=qs.default_traversability,
    )
    jest._map = jest_mod.GridMap(
        layers={k: jnp.asarray(v) for k, v in test.traversability_map.to_numpy().items()},
        resolution=RES, position=jnp.asarray(POSITION),
    )
    jest._position = POSITION.copy()
    jest.initialized = True
    return jest, test


def _path_batch(seed, P=16, N=8, rotated=False):
    """Random-walk paths inside the map (a few leaving it), ragged pose
    counts including 1, padded poses repeating the last valid one."""
    rng = np.random.default_rng(seed)
    ext = 96 * RES / 2 * 0.7
    starts = POSITION + rng.uniform(-ext, ext, (P, 2))
    starts[-1] = POSITION + [96 * RES / 2 + 0.2, 0.0]  # across the map's edge
    steps = rng.uniform(-0.06, 0.06, (P, N - 1, 2))
    xy = np.concatenate([starts[:, None], starts[:, None] + np.cumsum(steps, 1)], 1)
    pos3 = np.concatenate([xy, np.zeros((P, N, 1))], -1).astype(np.float32)
    quats = np.zeros((P, N, 4), np.float32)
    quats[..., 3] = 1.0
    if rotated:
        yaw = rng.uniform(-np.pi, np.pi, (P, N))
        quats[..., 2] = np.sin(yaw / 2)
        quats[..., 3] = np.cos(yaw / 2)
    n_poses = rng.integers(1, N + 1, P).astype(np.int32)
    n_poses[:3] = [1, 2, N]
    for p in range(P):
        pos3[p, n_poses[p]:] = pos3[p, n_poses[p] - 1]
        quats[p, n_poses[p]:] = quats[p, n_poses[p] - 1]
    return pos3, quats, n_poses


def _assert_paths_equal(out_t, out_j):
    safe_t, trav_t, area_t = (o.numpy() for o in out_t)
    safe_j, trav_j, area_j = (np.asarray(o) for o in out_j)
    np.testing.assert_array_equal(safe_t, safe_j)
    np.testing.assert_allclose(trav_t, trav_j, rtol=0, atol=2e-5)
    np.testing.assert_allclose(area_t, area_j, rtol=1e-5, atol=1e-6)


def test_transform_footprint_matches_jax():
    """Bit-equal, for identity, yaw and general quaternions: the port repeats
    the FMAs XLA:CPU contracts this function's multiply-adds into."""
    pos3, quats, _ = _path_batch(seed=21)
    fn = jax.jit(jfp.transform_footprint)
    out_j = fn(jnp.asarray(RECT), jnp.asarray(pos3), jnp.asarray(quats))
    out_t = tfp.transform_footprint(
        torch.from_numpy(RECT), torch.from_numpy(pos3), torch.from_numpy(quats)
    )
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    rng = np.random.default_rng(22)
    quats = rng.standard_normal(quats.shape).astype(np.float32)
    quats[0, 0] = 0.0  # the zero quaternion: no rotation scale
    out_j = fn(jnp.asarray(HEXAGON), jnp.asarray(pos3), jnp.asarray(quats))
    out_t = tfp.transform_footprint(
        torch.from_numpy(HEXAGON), torch.from_numpy(pos3), torch.from_numpy(quats)
    )
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    pos3, quats, _ = _path_batch(seed=21, rotated=True)
    out_j = fn(jnp.asarray(HEXAGON), jnp.asarray(pos3), jnp.asarray(quats))
    out_t = tfp.transform_footprint(
        torch.from_numpy(HEXAGON), torch.from_numpy(pos3), torch.from_numpy(quats)
    )
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


@pytest.mark.parametrize("window", [40, (36, 44)])
def test_check_polygons_matches_jax(engines, window):
    """Convex and non-convex polygons, rotated and placed anywhere, some off
    the map: ok and n_cells exact."""
    jest, test = engines
    rng = np.random.default_rng(23)
    B = 60
    centers = POSITION + rng.uniform(-1.6, 1.6, (B, 2))
    yaw = rng.uniform(-np.pi, np.pi, B)
    rot = np.stack([np.cos(yaw), -np.sin(yaw), np.sin(yaw), np.cos(yaw)], -1).reshape(B, 2, 2)
    verts = np.zeros((B, 8, 2), np.float32)
    n_vertices = np.zeros((B,), np.int32)
    for b in range(B):
        shape = (RECT, HEXAGON, L_SHAPE)[b % 3]
        placed = shape @ rot[b].T + centers[b]
        verts[b, : len(shape)] = placed
        verts[b, len(shape):] = placed[0]
        n_vertices[b] = len(shape)
    anchors = centers.astype(np.float32)
    ok_j, trav_j, n_j = jax.jit(jfp.check_polygons, static_argnums=4)(
        jest.query_state, jnp.asarray(verts), jnp.asarray(n_vertices), jnp.asarray(anchors), window
    )
    ok_t, trav_t, n_t = tfp.check_polygons(test.query_state, verts, n_vertices, anchors, window)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_allclose(trav_t.numpy(), np.asarray(trav_j), rtol=0, atol=2e-5)
    assert ok_t.any() and not ok_t.all() and n_t.max() > 400


def test_check_polygons_chunks(engines, monkeypatch):
    _, test = engines
    pos3, quats, _ = _path_batch(seed=24, rotated=True)
    polys = tfp.transform_footprint(
        torch.from_numpy(RECT), torch.from_numpy(pos3), torch.from_numpy(quats)
    ).reshape(-1, 4, 2)
    anchors = pos3[..., :2].reshape(-1, 2)
    whole = tfp.check_polygons(test.query_state, polys, 4, anchors, 40)
    monkeypatch.setattr(tfp, "_WINDOW_CHUNK_ELEMS", 9 * 40 * 40)
    parts = tfp.check_polygons(test.query_state, polys, 4, anchors, 40)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


@pytest.mark.parametrize("footprint", [RECT, RECT[::-1].copy(), HEXAGON], ids=["ccw", "cw", "hex"])
def test_swept_hull_translates_bit_equal(footprint):
    pos3, quats, _ = _path_batch(seed=25)
    fpj = jnp.asarray(footprint)

    def swept_j(pos):
        polys = jfp.transform_footprint(fpj, pos, jnp.asarray(quats))
        return jfp.swept_hull_translates(
            polys[:, :-1], polys[:, 1:], fpj, pos[:, 1:, :2] - pos[:, :-1, :2]
        )

    hull_j, n_j = jax.jit(swept_j)(jnp.asarray(pos3))
    pos_t = torch.from_numpy(pos3)
    fpt = torch.from_numpy(footprint)
    polys = tfp.transform_footprint(fpt, pos_t, torch.from_numpy(quats))
    hull_t, n_t = tfp.swept_hull_translates(
        polys[:, :-1], polys[:, 1:], fpt, pos_t[:, 1:, :2] - pos_t[:, :-1, :2]
    )
    np.testing.assert_array_equal(hull_t.numpy(), np.asarray(hull_j))
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))


@pytest.mark.parametrize("conservative", [False, True], ids=["plain", "conservative"])
@pytest.mark.parametrize("rotated", [False, True], ids=["identity", "rotated"])
@pytest.mark.parametrize("evaluator", ["per_segment", "grouped", "block_window"])
def test_polygonal_paths_match_jax(engines, evaluator, rotated, conservative):
    jest, test = engines
    pos3, quats, n_poses = _path_batch(seed=26, rotated=rotated)
    translate_only = not rotated and not conservative
    args_j = (jest.query_state, jnp.asarray(pos3), jnp.asarray(quats), jnp.asarray(n_poses),
              jnp.asarray(RECT))
    args_t = (test.query_state, pos3, quats, n_poses, RECT)
    if evaluator == "per_segment":
        seg_max = float(np.linalg.norm(np.diff(pos3[..., :2], axis=1), axis=-1).max())
        window = tfp.polygon_window_cells(RECT, seg_max, RES, conservative, not rotated)
        out_j = jest_mod._polygonal_paths_jit(*args_j, window, conservative, translate_only)
        out_t = tfp.check_polygonal_paths(*args_t, window, conservative, translate_only)
    else:
        ext = pos3[..., :2].max(axis=1) - pos3[..., :2].min(axis=1)
        if rotated:
            gw = tfp.path_group_window_exact(RECT, pos3, quats, RES)
        else:
            gw = tfp.path_group_window(RECT, ext, RES, True)
        bw = tfp.path_block_window(RECT, pos3, RES, not rotated) if evaluator == "block_window" \
            else None
        out_j = jest_mod._polygonal_paths_grouped_jit(
            *args_j, gw, conservative, translate_only, bw)
        out_t = tfp.check_polygonal_paths_grouped(
            *args_t, gw, conservative, translate_only, bw)
    _assert_paths_equal(out_t, out_j)
    safe = out_t[0].numpy()
    assert safe.any() and not safe.all()
    if not conservative:  # the conservative sweep's polygon1 is two rings in one
        assert (out_t[2].numpy()[safe] > 0.5).all()


def test_per_segment_non_convex_and_single_pose_batch(engines):
    """The per-segment evaluator takes a non-convex footprint (the raw L at a
    single pose, the hull of two Ls along a segment), and an N == 1 batch."""
    jest, test = engines
    pos3, quats, n_poses = _path_batch(seed=27, rotated=True)
    window = tfp.polygon_window_cells(L_SHAPE, 0.09, RES, False, False)
    out_j = jest_mod._polygonal_paths_jit(
        jest.query_state, jnp.asarray(pos3), jnp.asarray(quats), jnp.asarray(n_poses),
        jnp.asarray(L_SHAPE), window, False, False)
    out_t = tfp.check_polygonal_paths(
        test.query_state, pos3, quats, n_poses, L_SHAPE, window, False, False)
    _assert_paths_equal(out_t, out_j)
    ones = np.ones_like(n_poses)
    for fn_j, fn_t, win in (
        (jest_mod._polygonal_paths_jit, tfp.check_polygonal_paths, window),
        (jest_mod._polygonal_paths_grouped_jit, tfp.check_polygonal_paths_grouped, (44, 44)),
    ):
        fp = L_SHAPE if win is window else RECT
        out_j = fn_j(jest.query_state, jnp.asarray(pos3[:, :1]), jnp.asarray(quats[:, :1]),
                     jnp.asarray(ones), jnp.asarray(fp), win, False, False)
        out_t = fn_t(test.query_state, pos3[:, :1], quats[:, :1], ones, fp, win, False, False)
        _assert_paths_equal(out_t, out_j)


@pytest.mark.parametrize("rotated", [False, True], ids=["identity", "rotated"])
def test_window_planners_equal_ints(rotated):
    for seed, footprint in ((28, RECT), (29, HEXAGON), (30, L_SHAPE)):
        pos3, quats, _ = _path_batch(seed=seed, P=12, N=21, rotated=rotated)
        ext = pos3[..., :2].max(axis=1) - pos3[..., :2].min(axis=1)
        assert tfp.path_group_window(footprint, ext, RES, not rotated) == \
            jfp.path_group_window(footprint, ext, RES, not rotated)
        assert tfp.path_group_window_exact(footprint, pos3, quats, RES) == \
            jfp.path_group_window_exact(footprint, pos3, quats, RES)
        assert tfp.path_block_window(footprint, pos3, RES, not rotated) == \
            jfp.path_block_window(footprint, pos3, RES, not rotated)
        for conservative in (False, True):
            assert tfp.polygon_window_cells(footprint, 0.084, RES, conservative, not rotated) == \
                jfp.polygon_window_cells(footprint, 0.084, RES, conservative, not rotated)
        assert tfp.is_convex_polygon(footprint) == jfp.is_convex_polygon(footprint)
    assert tfp.path_group_window(RECT, np.zeros((0, 2)), RES) == \
        jfp.path_group_window(RECT, np.zeros((0, 2)), RES)
    assert not tfp.is_convex_polygon(L_SHAPE) and tfp.is_convex_polygon(RECT[::-1])
    assert tfp.SEG_BLOCK == jfp._SEG_BLOCK


@pytest.mark.parametrize("shape", ["rect", "rect_yaw", "l_shape"])
def test_dense_polygon_field_matches_jax(engines, shape):
    jest, test = engines
    c, s = np.cos(0.7), np.sin(0.7)
    verts = {
        "rect": 0.4 * RECT.astype(np.float64),
        "rect_yaw": 0.6 * RECT.astype(np.float64) @ np.array([[c, -s], [s, c]]).T,
        "l_shape": 0.6 * L_SHAPE.astype(np.float64),
    }[shape]
    ok_j, trav_j = jax.jit(lambda st: jfp.dense_polygon_field(st, verts))(jest.query_state)
    ok_t, trav_t = tfp.dense_polygon_field(test.query_state, verts)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(trav_t.numpy(), np.asarray(trav_j), rtol=0, atol=1e-5)
    assert ok_t.any() and not ok_t.all()


def test_dense_footprint_services_match_jax(engines):
    jest, test = engines
    before = set(test.traversability_map.layers)
    map_j = jest.traversability_footprint()
    map_t = test.traversability_footprint()
    map_j = jest.traversability_footprint_circle()
    map_t = test.traversability_footprint_circle()
    added = {"traversability_x", "traversability_rot", "traversability_footprint"}
    assert set(map_t.layers) == before | added
    assert test.traversability_map is map_t and test.last_footprint_seconds > 0
    for name in sorted(added):
        got, want = map_t[name].numpy(), np.asarray(map_j[name])
        assert got.dtype == np.float32 and got.shape == (96, 120)
        np.testing.assert_array_equal(got > 0, want > 0, err_msg=name)  # 0.0 where not ok
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
        assert (got > 0).any() and not (got > 0).all()
    # other radii than the configured ones
    got = test.traversability_footprint_circle(radius=0.2, offset=0.1)["traversability_footprint"]
    want = jest.traversability_footprint_circle(radius=0.2, offset=0.1)["traversability_footprint"]
    np.testing.assert_array_equal(got.numpy() > 0, np.asarray(want) > 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("rotated", [False, True], ids=["identity", "rotated"])
def test_window_buckets_match_jax(rotated):
    """per_path_window_cells and plan_window_buckets: the JAX host plan,
    equal in every integer."""
    for seed, footprint in ((31, RECT), (32, HEXAGON)):
        pos3, quats, _ = _path_batch(seed=seed, P=24, N=9, rotated=rotated)
        np.testing.assert_array_equal(
            tfp.per_path_window_cells(footprint, pos3, quats, RES),
            jfp.per_path_window_cells(footprint, pos3, quats, RES))
        for n_buckets in (1, 2, 3):
            assert tfp.plan_window_buckets(footprint, pos3, quats, RES, n_buckets) == \
                jfp.plan_window_buckets(footprint, pos3, quats, RES, n_buckets)


@pytest.mark.parametrize("conservative", [False, True])
def test_bucketed_paths_match_jax_and_the_single_window(engines, conservative):
    """check_polygonal_paths_bucketed: against the port's single-window
    grouped call as tests/test_footprint.py holds JAX's (verdicts and areas
    identical, traversability within 1e-6), and for the translating sweep
    against the JAX bucketed evaluator (the port's polygonal tolerances;
    JAX compiles one grouped program per bucket, and the conservative sweep
    of the grouped evaluator is held to JAX's by
    test_polygonal_paths_match_jax)."""
    jest, test = engines
    pos3, quats, n_poses = _path_batch(seed=33, P=20, N=5, rotated=True)
    window = tfp.path_group_window_exact(RECT, pos3, quats, RES)
    ref = tfp.check_polygonal_paths_grouped(
        test.query_state, pos3, quats, n_poses, RECT, window, conservative)
    for n_buckets in (2, 3):
        plan = tfp.plan_window_buckets(RECT, pos3, quats, RES, n_buckets)
        assert len(set(plan[1])) > 1  # the buckets' windows differ
        got = tfp.check_polygonal_paths_bucketed(
            test.query_state, pos3, quats, n_poses, RECT, plan, conservative)
        np.testing.assert_array_equal(got[0].numpy(), ref[0].numpy())
        np.testing.assert_allclose(got[1].numpy(), ref[1].numpy(), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got[2].numpy(), ref[2].numpy())
    if conservative:
        return
    plan = tfp.plan_window_buckets(RECT, pos3, quats, RES, 2)
    out_j = jfp.check_polygonal_paths_bucketed(
        jest._query_state, jnp.asarray(pos3), jnp.asarray(quats), jnp.asarray(n_poses),
        jnp.asarray(RECT), plan, conservative)
    _assert_paths_equal(tfp.check_polygonal_paths_bucketed(
        test.query_state, pos3, quats, n_poses, RECT, plan, conservative), out_j)


def test_polygon_prefix_planes_match_jax(engines):
    """The packed count prefix exact; the float prefix within float32
    rounding of the running sums (the two scans add in other orders); with
    an in-map plane the cells outside count as neither pass nor fail."""
    jest, test = engines
    counts_j, tv_j = jax.jit(jfp.polygon_prefix_planes)(jest._query_state)
    counts_t, tv_t = tfp.polygon_prefix_planes(test.query_state)
    np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_j))
    np.testing.assert_allclose(tv_t.numpy(), np.asarray(tv_j), rtol=1e-6, atol=1e-5)
    qs = test.query_state
    in_map = torch.from_numpy(np.random.default_rng(3).random(qs.shape) > 0.2)
    counts_m, tv_m = tfp.polygon_prefix_planes(qs, in_map)
    ok = qs.traversable_mask & in_map
    cells = torch.diff(counts_m, dim=1)
    np.testing.assert_array_equal((cells % 65536).numpy(), ok.numpy())
    np.testing.assert_array_equal((cells // 65536).numpy(), (~qs.traversable_mask & in_map).numpy())
    masked = tfp.QueryState(qs.traversability, ok, qs.position, RES, qs.default_traversability)
    np.testing.assert_array_equal(tv_m.numpy(), tfp.polygon_prefix_planes(masked)[1].numpy())

