"""The port's online path (merge_submap, recenter, update_with_submap,
online_tick) against the jitted JAX estimator, on the CPU.

Both engines get the same maps, patches and path batches, made from numpy
seeds. Bars against JAX: elevation, position, the step layer and every veto
plane exact; slope 5e-5, roughness and traversability 2e-4 (the chain bars of
test_torch_filters.py: XLA:CPU contracts FMAs in the float layers); path
verdicts equal; path traversability within 1e-6 for circular and identity
polygonal ticks and 2e-5 for rotated and conservative ones when both engines
start the tick from one carried-over map state and query cells outside the
refreshed region, else the fused layer's 2e-4.

Bars inside the port: the fused tick equals the unfused sequence exactly, in
every layer; the incremental refresh equals a full update of the merged map
exactly (each layer is computed per cell from the same neighbourhood by the
same whole-plane ops, whatever the plane's shape).
"""

import numpy as np
import pytest
import torch

from traversability_estimation_tpu.models import TraversabilityEstimator as JaxEstimator
from traversability_estimation_tpu.models import estimator as jmod
from traversability_estimation_tpu.utils.config import EstimatorConfig as JaxConfig
from traversability_estimation_tpu_torch import (
    ArraySource,
    EstimatorConfig,
    SyntheticTerrainSource,
    TraversabilityEstimator,
)
from traversability_estimation_tpu_torch.models import estimator as tmod
from traversability_estimation_tpu_torch.ops.veto import required_halo
from traversability_estimation_tpu_torch.utils.convert import config_from_fields, estimator_from_state

RES = 0.05
RECT = np.float32([[0.12, 0.08], [0.12, -0.08], [-0.12, -0.08], [-0.12, 0.08]])
CLOSE = {"traversability_slope": 5e-5, "traversability_roughness": 2e-4, "traversability": 2e-4}


def terrain(rows, cols, res, seed, nan_frac=0.02):
    rng = np.random.default_rng(seed)
    x = np.arange(rows)[:, None] * res
    y = np.arange(cols)[None, :] * res
    z = (
        0.15 * np.sin(2.0 * x) * np.cos(1.5 * y)
        + 0.02 * rng.standard_normal((rows, cols))
        + 0.3 * ((x > x.mean()) & (y > y.mean()))
        + 0.1 * x
    )
    return np.where(rng.random((rows, cols)) < nan_frac, np.nan, z).astype(np.float32)


def workload(seed, spread=0.6, P=8, N=4):
    """A 40 x 40 patch with holes and P paths of N poses around the origin."""
    rng = np.random.default_rng(seed)
    patch = (0.03 * rng.standard_normal((40, 40))).astype(np.float32)
    patch[rng.random((40, 40)) < 0.02] = np.nan
    starts = np.stack([rng.uniform(-spread, spread, P), rng.uniform(-spread, spread, P)], -1)
    steps = rng.uniform(-0.08, 0.08, (P, N - 1, 2))
    poses = np.concatenate(
        [starts[:, None], starts[:, None] + np.cumsum(steps, 1)], 1
    ).astype(np.float32)
    return patch, poses, np.full((P,), N, np.int32)


def quats_for(poses, seed, rotate):
    P, N = poses.shape[:2]
    quats = np.zeros((P, N, 4), np.float32)
    quats[..., 3] = 1.0
    if rotate:
        yaw = np.random.default_rng(seed).uniform(0, 2 * np.pi, (P, N))
        quats[..., 2] = np.sin(yaw / 2).astype(np.float32)
        quats[..., 3] = np.cos(yaw / 2).astype(np.float32)
    return quats


def jax_state(jest):
    """A JAX estimator's state as host arrays, as estimator_from_state takes it."""
    return dict(
        elevation=np.asarray(jest._elevation),
        position=np.asarray(jest._position),
        map_layers={k: np.asarray(v) for k, v in jest._map.layers.items()},
        extra_layers={k: np.asarray(v) for k, v in jest._extra_layers.items()},
        traversability_default=jest._traversability_default,
        initialized=jest.initialized,
    )


def pair(base, position=(0.0, 0.0), extra=None):
    """A JAX estimator after its own update of `base`, and the port's
    estimator carrying that state (so both start a tick from one map)."""
    jest = JaxEstimator(JaxConfig(resolution=RES))
    jest.set_elevation_map(base, position, extra_layers=extra)
    assert jest.update()
    test = estimator_from_state(config_from_fields(jest.config), device="cpu", **jax_state(jest))
    return jest, test


def assert_layers_match_jax(test, jest, exact_everywhere=False):
    ref = {k: np.asarray(v) for k, v in jest.traversability_map.layers.items()}
    out = test.traversability_map.to_numpy()
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].dtype == ref[k].dtype, k
        if k in CLOSE and not exact_everywhere:
            assert (np.isfinite(out[k]) == np.isfinite(ref[k])).all(), k
            fin = np.isfinite(ref[k])
            np.testing.assert_allclose(out[k][fin], ref[k][fin], rtol=0, atol=CLOSE[k], err_msg=k)
        else:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(test._elevation.numpy(), np.asarray(jest._elevation))
    np.testing.assert_array_equal(test._position, np.asarray(jest._position))
    np.testing.assert_array_equal(
        test.traversability_map.position.numpy(), np.asarray(jest.traversability_map.position))
    np.testing.assert_array_equal(
        test.query_state.traversable_mask.numpy(), np.asarray(jest.query_state.traversable_mask))
    np.testing.assert_array_equal(
        test.query_state.position.numpy(), np.asarray(jest.query_state.position))


def assert_same_port_state(a, b):
    """Two estimators of the port hold bit-identical state."""
    la, lb = a.traversability_map.to_numpy(), b.traversability_map.to_numpy()
    assert set(la) == set(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
    np.testing.assert_array_equal(a._elevation.numpy(), b._elevation.numpy())
    np.testing.assert_array_equal(a._position, b._position)
    np.testing.assert_array_equal(
        a.query_state.traversability.numpy(), b.query_state.traversability.numpy())
    np.testing.assert_array_equal(a.query_state.position.numpy(), b.query_state.position.numpy())
    assert set(a._extra_layers) == set(b._extra_layers)
    for k in a._extra_layers:
        np.testing.assert_array_equal(a._extra_layers[k].numpy(), b._extra_layers[k].numpy())


@pytest.fixture(scope="module")
def base():
    return terrain(160, 160, RES, seed=91)


# ---------------------------------------------------------------------------
# merge, recenter, incremental update
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("center", [(0.3, -0.2), (3.6, 0.0), (-3.9, 3.95), (9.0, 0.0)])
def test_merge_submap_and_bounds_match_jax(base, center):
    """Interior, edge, corner and off-map patches: bounds, success flag and
    the merged elevation are equal."""
    jest = JaxEstimator(JaxConfig(resolution=RES))
    test = TraversabilityEstimator(EstimatorConfig(resolution=RES), device="cpu")
    patch, _, _ = workload(3)
    assert not test.merge_submap(patch, center) and not jest.merge_submap(patch, center)
    jest.set_elevation_map(base, (0.05, -0.1))
    test.set_elevation_map(base, (0.05, -0.1))
    assert test._merge_bounds(patch, center) == jest._merge_bounds(patch, center)
    before = test._elevation
    assert test.merge_submap(patch, center) == jest.merge_submap(patch, center)
    np.testing.assert_array_equal(test._elevation.numpy(), np.asarray(jest._elevation))
    # the plane held before the merge keeps its values
    np.testing.assert_array_equal(before.numpy(), base)


@pytest.mark.parametrize("target", [(0.4, 0.25), (-1.03, 2.62), (0.06, -0.09), (20.0, 0.0)])
def test_recenter_matches_jax(base, target):
    """Positions, elevation, every map layer and the extra layers are equal
    after a recenter (a shift of a few cells, a zero shift, a shift past the
    whole window); freshly exposed cells are NaN and pass the vetoes."""
    extra = {"upper_bound": base + 0.05, "lower_bound": base - 0.05}
    jest, test = pair(base, (0.05, -0.1), extra)
    cached = test._circle_field(0.2, 0.15)
    assert cached is not None and test._field_cache
    assert test.recenter(target) == jest.recenter(target)
    assert_layers_match_jax(test, jest, exact_everywhere=True)
    for k in extra:
        np.testing.assert_array_equal(test._extra_layers[k].numpy(), np.asarray(jest._extra_layers[k]))
    moved = not np.array_equal(test._position, np.float32([0.05, -0.1]))
    assert moved == (target != (0.06, -0.09))
    if moved:
        assert not test._field_cache
        # the strip the window moved onto is unknown and passes the vetoes
        layers = test.traversability_map
        for k, v in layers.layers.items():
            strip = v[0] if target[0] > 0 else v[-1]
            if v.dtype == torch.bool:
                assert bool(strip.all()), k
            else:
                assert bool(torch.isnan(strip).all()), k


@pytest.mark.parametrize("center,position", [((0.3, -0.4), (0.0, 0.0)), ((3.9, 3.9), (0.0, 0.0)),
                                             ((0.35, 0.1), (0.05, -0.1))])
def test_update_with_submap_incremental_matches_jax_and_full(base, center, position):
    """An interior patch, one hanging over the map corner and one on a map
    off the origin: the incremental refresh against JAX at the chain bars,
    and against the port's own full update of the merged map, exactly."""
    jest, test = pair(base, position)
    held = test.traversability_map
    held_np = {k: v.copy() for k, v in held.to_numpy().items()}  # to_numpy shares memory
    patch = terrain(40, 40, RES, seed=93) + 0.1
    assert test.update_with_submap(patch, center) and jest.update_with_submap(patch, center)
    assert_layers_match_jax(test, jest)
    # a map taken before the refresh keeps its values
    for k, v in held_np.items():
        np.testing.assert_array_equal(held[k].numpy(), v, err_msg=k)

    full = TraversabilityEstimator(test.config, device="cpu")
    full.set_elevation_map(base, position)
    assert full.update() and full.update_with_submap(patch, center, incremental=False)
    own = TraversabilityEstimator(test.config, device="cpu")
    own.set_elevation_map(base, position)
    assert own.update() and own.update_with_submap(patch, center, incremental=True)
    assert_same_port_state(own, full)


def test_update_with_submap_before_first_update_and_off_map(base):
    jest = JaxEstimator(JaxConfig(resolution=RES))
    test = TraversabilityEstimator(EstimatorConfig(resolution=RES), device="cpu")
    patch, _, _ = workload(4)
    assert test.update_with_submap(patch, (0, 0)) is False
    nan_map = np.full((96, 96), np.nan, np.float32)
    jest.set_elevation_map(nan_map)
    test.set_elevation_map(nan_map)
    assert not test.update_with_submap(patch, (50.0, 0.0))
    assert not test.initialized
    assert test.update_with_submap(patch, (0.2, 0.1)) and jest.update_with_submap(patch, (0.2, 0.1))
    assert test.initialized
    assert_layers_match_jax(test, jest)
    assert not test.update_with_submap(patch, (50.0, 0.0))


def test_update_with_submap_sync_false_equals_sync_true(base):
    a = TraversabilityEstimator(EstimatorConfig(resolution=RES), device="cpu")
    b = TraversabilityEstimator(EstimatorConfig(resolution=RES), device="cpu")
    assert a.update(base) and b.update(base)
    patch, _, _ = workload(3)
    assert a.update_with_submap(patch, (0.4, -0.3), sync=True)
    assert b.update_with_submap(patch, (0.4, -0.3), sync=False)
    assert_same_port_state(a, b)
    assert a.last_update_seconds > 0 and b.last_update_seconds > 0


# ---------------------------------------------------------------------------
# the online tick
# ---------------------------------------------------------------------------

# name -> (workload seed, submap centre, tick keywords, rotate, path trav bar)
TICKS = {
    "circular_persistent": (5, (0.3, -0.2), dict(radius=0.2), False, 1e-6),
    "circular_roaming": (6, (0.4, 0.25), dict(radius=0.2, recenter_to=(0.4, 0.25)), False, 1e-6),
    "polygonal_identity": (8, (0.25, -0.15), dict(footprint=RECT), False, 1e-6),
    "polygonal_yaw": (9, (0.25, -0.15), dict(footprint=RECT), True, 2e-5),
    "polygonal_conservative": (10, (0.25, -0.15), dict(footprint=RECT, conservative=True), False,
                               2e-5),
    "edge_fallback": (7, (3.6, 0.0), dict(radius=0.2), False, 1e-6),
}


def run_tick(est, name, poses_shift=(0.0, 0.0)):
    seed, center, kw, rotate, _ = TICKS[name]
    patch, poses, n = workload(seed)
    poses = poses + np.float32(poses_shift)
    kw = dict(kw)
    if "footprint" in kw:
        kw["quaternions"] = quats_for(poses, seed, rotate)
    return est.online_tick(patch, center, poses, n, **kw)


@pytest.mark.parametrize("name", list(TICKS))
def test_online_tick_matches_jax(base, name):
    """One tick through both engines from one carried-over map state: the
    map state at the chain bars; verdicts equal; path traversability at the
    fused layer's 2e-4 where the paths cross the refreshed region."""
    jest, test = pair(base)
    out_j = run_tick(jest, name)
    out_t = run_tick(test, name)
    assert out_j is not None and out_t is not None
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]), rtol=0, atol=2e-4)
    assert_layers_match_jax(test, jest)
    assert test._max_cells_hwm == jest._max_cells_hwm
    assert test._pwindow_hwm == jest._pwindow_hwm
    assert (name == "edge_fallback") == (test._max_cells_hwm == 0 and not test._pwindow_hwm)
    if name.startswith("polygonal"):
        assert test._pwindow_hwm and test.last_polygonal_dispatch == {}


@pytest.mark.parametrize("name", [n for n in TICKS if n != "edge_fallback"])
def test_online_tick_paths_outside_refresh_match_jax_tightly(base, name):
    """The same ticks with the paths moved off the refreshed region, onto
    cells both engines hold bit-identically: the tick's query path alone, at
    1e-6 (circular, identity) and 2e-5 (rotated, conservative)."""
    jest, test = pair(base)
    shift = (-2.6, 0.0)  # along the terrain's step edge
    out_j = run_tick(jest, name, shift)
    out_t = run_tick(test, name, shift)
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    np.testing.assert_allclose(
        out_t[1].numpy(), np.asarray(out_j[1]), rtol=0, atol=TICKS[name][4])
    assert out_t[0].any() and float(out_t[1].max()) > 0.0
    if name.startswith("circular"):
        assert not out_t[0].all()


@pytest.mark.parametrize("name", list(TICKS))
def test_online_tick_equals_unfused_sequence(base, name):
    """The port's tick against the port's own recenter + update_with_submap
    + path batch: every layer, position and result bit-identical."""
    seed, center, kw, rotate, _ = TICKS[name]
    a = TraversabilityEstimator(EstimatorConfig(resolution=RES), device="cpu")
    b = TraversabilityEstimator(EstimatorConfig(resolution=RES), device="cpu")
    extra = {"upper_bound": base + 0.05, "lower_bound": base - 0.05}
    for e in (a, b):
        e.set_elevation_map(base, extra_layers=extra)
        assert e.update()
    patch, poses, n = workload(seed)
    quats = quats_for(poses, seed, rotate)
    out_a = run_tick(a, name)
    if "recenter_to" in kw:
        assert b.recenter(kw["recenter_to"])
    assert b.update_with_submap(patch, center)
    if "footprint" in kw:
        pos3 = np.concatenate([poses, np.zeros(poses.shape[:2] + (1,), np.float32)], -1)
        safe_b, trav_b, _ = b.check_polygonal_paths_batch(
            pos3, quats, n, RECT, kw.get("conservative", False))
    else:
        safe_b, trav_b = b.check_circular_paths_batch(poses, n, kw["radius"])
    assert torch.equal(out_a[0], safe_b)
    if name in ("polygonal_identity", "polygonal_yaw", "polygonal_conservative"):
        # the tick's window is the high-water one (1.5x, buckets of 16), the
        # batch's the exact one: other cells in the window, the same inside
        # the rings, sums in another order
        np.testing.assert_allclose(out_a[1].numpy(), trav_b.numpy(), rtol=0, atol=1e-6)
    else:
        assert torch.equal(out_a[1], trav_b)
    assert_same_port_state(a, b)


def test_online_tick_leaves_earlier_state_unchanged(base):
    """A map and a query state taken before a tick keep their values (a
    planner thread may still read the previous epoch)."""
    test = TraversabilityEstimator(EstimatorConfig(resolution=RES), device="cpu")
    assert test.update(base)
    for name in ("circular_persistent", "circular_roaming", "polygonal_identity"):
        held_map, held_qs, held_elev = test.traversability_map, test.query_state, test._elevation
        snap = {k: v.clone() for k, v in held_map.layers.items()}
        snap_qs = (held_qs.traversability.clone(), held_qs.traversable_mask.clone(),
                   held_qs.position.clone(), held_elev.clone(), held_map.position.clone())
        assert run_tick(test, name) is not None
        assert test.traversability_map is not held_map
        for k, v in snap.items():
            np.testing.assert_array_equal(held_map[k].numpy(), v.numpy(), err_msg=k)
        now = (held_qs.traversability, held_qs.traversable_mask, held_qs.position, held_elev,
               held_map.position)
        for got, want in zip(now, snap_qs):
            np.testing.assert_array_equal(got.numpy(), want.numpy())
        # and the tick did change the map
        assert not np.array_equal(
            test.traversability_map["elevation"].numpy(), snap["elevation"].numpy(), equal_nan=True)


def test_online_tick_argument_check_and_uninitialised(base):
    test = TraversabilityEstimator(EstimatorConfig(resolution=RES), device="cpu")
    patch, poses, n = workload(5)
    with pytest.raises(ValueError, match="exactly one"):
        test.online_tick(patch, (0, 0), poses, n)
    with pytest.raises(ValueError, match="exactly one"):
        test.online_tick(patch, (0, 0), poses, n, radius=0.2, footprint=RECT)
    assert test.online_tick(patch, (0, 0), poses, n, radius=0.2) is None  # no map at all
    # before the first update the tick is the unfused sequence (a full update)
    jest = JaxEstimator(JaxConfig(resolution=RES))
    nan_map = np.full((120, 120), np.nan, np.float32)
    jest.set_elevation_map(nan_map)
    test.set_elevation_map(nan_map)
    out_j = jest.online_tick(patch, (0.1, 0.1), poses, n, radius=0.2)
    out_t = test.online_tick(patch, (0.1, 0.1), poses, n, radius=0.2)
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    assert test.initialized and test._max_cells_hwm == 0
    assert_layers_match_jax(test, jest)


def test_non_convex_footprint_falls_back(base):
    chevron = np.float32([[0.12, 0.0], [0.0, 0.08], [-0.12, 0.0], [0.0, 0.02]])
    jest, test = pair(base)
    patch, poses, n = workload(11)
    out_j = jest.online_tick(patch, (0.2, 0.2), poses, n, footprint=chevron)
    out_t = test.online_tick(patch, (0.2, 0.2), poses, n, footprint=chevron)
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    assert not test._pwindow_hwm and not jest._pwindow_hwm
    assert test.last_polygonal_dispatch == jest.last_polygonal_dispatch
    assert test.last_polygonal_dispatch["reason"] == "non_convex_footprint"


def test_roaming_over_four_centres_matches_rebuild():
    """A bounded 96 x 96 window roams over a larger world through the tick:
    the final window equals a fresh update of its elevation on the merged
    region's interior (the port's own rebuild, exactly; the JAX estimator
    run through the same ticks, at the chain bars)."""
    res = 0.03
    world = ArraySource(terrain(320, 192, res, seed=17, nan_frac=0.03), res)
    cfg = EstimatorConfig(resolution=res)
    test = TraversabilityEstimator(cfg, device="cpu")
    jest = JaxEstimator(JaxConfig(resolution=res))
    rows = cols = 96
    blank = np.full((rows, cols), np.nan, np.float32)
    _, poses, n = workload(12, spread=0.3)
    for e in (test, jest):
        e.set_elevation_map(blank, (0.0, 0.0))
        assert e.update()
    for c in [(0.0, 0.0), (0.9, 0.3), (1.8, 0.6), (2.7, 0.9)]:
        patch, _ = world.sample(c, (48 * res, 48 * res))
        assert patch.shape == (48, 48)
        out_t = test.online_tick(patch, c, poses + np.float32(c), n, radius=0.2, recenter_to=c)
        out_j = jest.online_tick(patch, c, poses + np.float32(c), n, radius=0.2, recenter_to=c)
        np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
        np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]), rtol=0, atol=2e-4)
    assert_layers_match_jax(test, jest)
    assert tuple(test._elevation.shape) == (rows, cols)

    ref = TraversabilityEstimator(cfg, device="cpu")
    assert ref.update(test._elevation.numpy(), test._position)
    halo = required_halo(cfg.chain, cfg.veto)
    i0 = rows // 2 - 24 + halo
    sl = (slice(i0, i0 + 48 - 2 * halo), slice(i0, i0 + 48 - 2 * halo))
    for k in ("traversability", "traversability_step", "traversable_mask", "slope_ok"):
        np.testing.assert_array_equal(
            test.traversability_map[k][sl].numpy(), ref.traversability_map[k][sl].numpy(), err_msg=k)
    assert np.isfinite(test.traversability_map["traversability"][sl].numpy()).any()


def random_tick_batch(rng, P=16, N=6):
    patch = (0.05 * rng.standard_normal((40, 40))).astype(np.float32)
    starts = np.stack([rng.uniform(-0.8, 0.8, P), rng.uniform(-0.8, 0.8, P)], -1)
    steps = rng.uniform(-0.1, 0.1, (P, N - 1, 2))
    poses = np.concatenate(
        [starts[:, None], starts[:, None] + np.cumsum(steps, 1)], 1).astype(np.float32)
    return patch, poses, np.full((P,), N, np.int32)


def test_window_mark_stabilises_and_matches_jax():
    """Eight random polygonal ticks: the window mark grows at most once after
    the first tick, and is the JAX estimator's mark at every tick."""
    world = terrain(200, 200, RES, seed=31)
    test = TraversabilityEstimator(EstimatorConfig(resolution=RES), device="cpu")
    jest = JaxEstimator(JaxConfig(resolution=RES))
    assert test.update(world) and jest.update(world)
    rng = np.random.default_rng(7)
    marks = []
    for _ in range(8):
        patch, poses, n = random_tick_batch(rng)
        assert test.online_tick(patch, (0.0, 0.0), poses, n, footprint=RECT) is not None
        marks.append(dict(test._pwindow_hwm))
    growths = sum(1 for i in range(1, len(marks)) if marks[i] != marks[i - 1])
    assert growths <= 1, marks
    # the first two ticks through JAX as well (each new window is a compile)
    rng = np.random.default_rng(7)
    for tick in range(2):
        patch, poses, n = random_tick_batch(rng)
        assert jest.online_tick(patch, (0.0, 0.0), poses, n, footprint=RECT) is not None
        assert dict(jest._pwindow_hwm) == marks[tick]
    (mark,) = marks[-1].values()
    assert mark[0] % 16 == 0 and mark[1] % 16 == 0


def test_circular_sample_count_mark_is_monotone(base):
    test = TraversabilityEstimator(EstimatorConfig(resolution=RES), device="cpu")
    assert test.update(base)
    patch, poses, n = workload(5)
    long_poses = poses.copy()
    long_poses[:, 1:] += np.float32([0.9, 0.0])
    seen = []
    for p in (poses, long_poses, poses):
        assert test.online_tick(patch, (0.3, -0.2), p, n, radius=0.2) is not None
        seen.append(test._max_cells_hwm)
    assert seen[0] < seen[1] == seen[2]
    assert seen[0] == test._max_segment_cells(poses, n)


def test_over_cap_batch_leaves_the_window_mark(monkeypatch):
    """One outlier batch whose window exceeds the grouped cap falls back for
    that tick only and must not move the mark."""
    world = terrain(200, 200, RES, seed=32)
    test = TraversabilityEstimator(EstimatorConfig(resolution=RES), device="cpu")
    assert test.update(world)
    patch = np.zeros((40, 40), np.float32)
    P, N = 8, 4

    def batch(span):
        starts = np.linspace(-span, span, P)[:, None].repeat(2, 1)
        return (starts[:, None] + np.linspace(0, span / 4, N)[None, :, None]).astype(np.float32)

    n = np.full((P,), N, np.int32)
    assert test.online_tick(patch, (0.0, 0.0), batch(0.1), n, footprint=RECT) is not None
    mark_before = dict(test._pwindow_hwm)
    (hwm,) = mark_before.values()
    monkeypatch.setattr(tmod, "_GROUPED_ELEMS_CAP", hwm[0] * hwm[1] * P)
    assert tmod._GROUPED_ELEMS_CAP < jmod._GROUPED_ELEMS_CAP
    assert test.online_tick(patch, (0.0, 0.0), batch(2.0), n, footprint=RECT) is not None
    assert test._pwindow_hwm == mark_before
    assert test.last_polygonal_dispatch["evaluator"] in ("grouped", "per_segment")
    assert test.online_tick(patch, (0.0, 0.0), batch(0.1), n, footprint=RECT) is not None
    assert test._pwindow_hwm == mark_before


def test_state_carried_across_mid_loop():
    """Three ticks in JAX, the state carried into the port, tick four in
    both: the port continues the loop where JAX stood."""
    res = 0.03
    src_j = SyntheticTerrainSource(res)
    jest = JaxEstimator(JaxConfig(resolution=res))
    jest.set_elevation_map(np.full((200, 200), np.nan, np.float32))
    rng = np.random.default_rng(0)

    def tick_inputs(k):
        c = (0.5 * np.cos(0.3 * k), 0.5 * np.sin(0.3 * k))
        patch, _ = src_j.sample(c, (1.92, 1.92))
        starts = np.float32(c) + rng.uniform(-0.6, 0.6, (12, 2))
        steps = rng.uniform(-0.08, 0.08, (12, 4, 2))
        poses = np.concatenate(
            [starts[:, None], starts[:, None] + np.cumsum(steps, 1)], 1).astype(np.float32)
        return patch, c, poses, np.full((12,), 5, np.int32)

    for k in range(3):
        assert jest.online_tick(*tick_inputs(k), radius=0.3) is not None
    test = estimator_from_state(config_from_fields(jest.config), device="cpu", **jax_state(jest))
    test._max_cells_hwm = jest._max_cells_hwm
    assert_layers_match_jax(test, jest, exact_everywhere=True)
    args = tick_inputs(3)
    out_j = jest.online_tick(*args, radius=0.3)
    out_t = test.online_tick(*args, radius=0.3)
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]), rtol=0, atol=2e-4)
    assert_layers_match_jax(test, jest)
    assert out_t[0].any() and not out_t[0].all()


def test_sources_match_the_jax_package():
    from traversability_estimation_tpu.utils import sources as jsrc

    for center, length in (((0.0, 0.0), (1.2, 1.2)), ((3.3, -7.1), (1.5, 0.9))):
        a, ca = SyntheticTerrainSource(0.03, seed=2).sample(center, length)
        b, cb = jsrc.SyntheticTerrainSource(0.03, seed=2).sample(center, length)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ca, cb)
    world = terrain(64, 48, 0.1, seed=3)
    for center in ((0.0, 0.0), (2.9, -2.0), (40.0, 0.0)):
        a, _ = ArraySource(world, 0.1, (0.5, 0.5)).sample(center, (1.0, 2.0))
        b, _ = jsrc.ArraySource(world, 0.1, (0.5, 0.5)).sample(center, (1.0, 2.0))
        np.testing.assert_array_equal(a, b)
