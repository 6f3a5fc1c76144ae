"""The port's circular footprint queries (traversability_estimation_tpu_torch.
ops.footprint) against the JAX ones, on the CPU.

The dense circle field is bit-exact against both the jitted JAX XLA form
(the one the JAX estimator runs) and the JAX Pallas kernel (interpret
mode). Un-jitted, JAX divides by the constant radius span instead of
multiplying by its reciprocal and rounds 1 ulp apart from its own jitted
form on some inflated cells, so the reference here is always jitted.
check_circles and check_circular_paths give equal verdicts and
traversability within 1e-6 (the path aggregation sums in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from traversability_estimation_tpu.grid import geometry as jgeo
from traversability_estimation_tpu.ops import footprint as jfp
from traversability_estimation_tpu_torch.grid import geometry as tgeo
from traversability_estimation_tpu_torch.ops import field_kernel
from traversability_estimation_tpu_torch.ops import footprint as tfp
from traversability_estimation_tpu_torch.ops.update_kernel import fused_update_plain
from traversability_estimation_tpu_torch.utils.config import EstimatorConfig
from traversability_estimation_tpu_torch.utils.convert import query_state_from_numpy

RES = 0.03
jax_field = jax.jit(jfp.dense_circle_field, static_argnums=(1, 2))
POSITION = np.float32([0.07, -0.11])


def smooth_terrain(rows, cols, seed):
    """Mostly traversable terrain (bench.py's): verdicts of both kinds."""
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
def states():
    """The same query state for both engines (made by the port's update:
    the footprint functions only need identical inputs)."""
    elev = smooth_terrain(64, 80, seed=5)
    cfg = EstimatorConfig(resolution=RES)
    layers = fused_update_plain(torch.from_numpy(elev), cfg.chain, cfg.veto)
    trav = layers["traversability"].numpy()
    mask = layers["traversable_mask"].numpy()
    jstate = jfp.QueryState(
        traversability=jnp.asarray(trav), traversable_mask=jnp.asarray(mask),
        position=jnp.asarray(POSITION), resolution=RES, default_traversability=0.5,
    )
    tstate = query_state_from_numpy(trav, mask, POSITION, RES, 0.5, device="cpu")
    assert 0.2 < mask.mean() < 0.995
    return jstate, tstate


@pytest.mark.parametrize("radius_min", [0.3, 0.0])
def test_dense_circle_field_matches_jax(states, radius_min):
    jstate, tstate = states
    ok_j, tv_j = jax_field(jstate, 0.45, radius_min)
    ok_t, tv_t = tfp.dense_circle_field(tstate, 0.45, radius_min)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(tv_t.numpy(), np.asarray(tv_j))
    assert ok_t.any() and not ok_t.all()


def test_dense_circle_field_with_in_map_matches_jax(states):
    jstate, tstate = states
    in_map = np.random.default_rng(8).random(tstate.shape) > 0.1
    ok_j, tv_j = jax_field(jstate, 0.24, 0.12, jnp.asarray(in_map))
    ok_t, tv_t = tfp.dense_circle_field(tstate, 0.24, 0.12, torch.from_numpy(in_map))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(tv_t.numpy(), np.asarray(tv_j))


def test_dense_circle_field_matches_pallas_interpret(states, monkeypatch):
    """The TPU kernel itself, run in interpret mode, against the port."""
    from traversability_estimation_tpu.ops import pallas_field as pf

    jstate, tstate = states
    monkeypatch.setattr(
        pf.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    ok_p, tv_p = pf.dense_circle_field_pallas.__wrapped__(jstate, 0.3, 0.15)
    ok_t, tv_t = tfp.dense_circle_field(tstate, 0.3, 0.15)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_p))
    np.testing.assert_array_equal(tv_t.numpy(), np.asarray(tv_p))


def test_field_wrapper_uses_plain_version_on_cpu(states):
    _, tstate = states
    before = field_kernel.dense_circle_field.launches
    ok_w, tv_w = field_kernel.dense_circle_field(tstate, 0.3, 0.1)
    ok_p, tv_p = tfp.dense_circle_field(tstate, 0.3, 0.1)
    assert torch.equal(ok_w, ok_p) and torch.equal(tv_w, tv_p)
    assert field_kernel.dense_circle_field.launches == before


@pytest.mark.parametrize("radius_min", [0.3, 0.0])
def test_check_circles_matches_jax(states, radius_min):
    jstate, tstate = states
    rng = np.random.default_rng(11)
    # sub-cell centers over the map and a margin beyond it
    half = np.array(tstate.shape) * RES / 2 + 0.2
    centers = (POSITION + rng.uniform(-half, half, (1500, 2))).astype(np.float32)
    ok_j, tv_j = jax.jit(lambda s, c: jfp.check_circles(s, c, 0.45, radius_min))(
        jstate, jnp.asarray(centers)
    )
    ok_t, tv_t = tfp.check_circles(tstate, torch.from_numpy(centers), 0.45, radius_min)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(tv_t.numpy(), np.asarray(tv_j), rtol=0, atol=1e-6)
    assert ok_t.any() and not ok_t.all()


def test_prefix_sum_matches_associative_scan():
    x = np.random.default_rng(2).random((7, 709)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jax.lax.associative_scan(jnp.add, v, axis=-1))(x))
    np.testing.assert_array_equal(tfp._prefix_sum(torch.from_numpy(x)).numpy(), want)


def test_line_cells_batch_matches_jax():
    rng = np.random.default_rng(6)
    start = rng.integers(-40, 40, (200, 2)).astype(np.int32)
    end = start + rng.integers(-20, 21, (200, 2)).astype(np.int32)
    cj, vj, nj = jax.jit(jgeo.line_cells_batch, static_argnums=(2,))(start, end, 24)
    ct, vt, nt = tgeo.line_cells_batch(torch.from_numpy(start), torch.from_numpy(end), 24)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))


def test_check_circular_paths_matches_jax(states):
    jstate, tstate = states
    rng = np.random.default_rng(12)
    P, N = 40, 10
    ext = np.array(tstate.shape) * RES / 2 * 0.8
    starts = POSITION + rng.uniform(-ext, ext, (P, 2))
    steps = rng.uniform(-0.07, 0.07, (P, N - 1, 2))
    poses = np.concatenate(
        [starts[:, None], starts[:, None] + np.cumsum(steps, 1)], 1
    ).astype(np.float32)
    n_poses = rng.integers(0, N + 1, P).astype(np.int32)
    n_poses[:4] = [1, 1, 0, N]
    field_j = jax_field(jstate, 0.45, 0.3)
    field_t = tfp.dense_circle_field(tstate, 0.45, 0.3)
    safe_j, tv_j = jax.jit(
        lambda s, p, n, f: jfp.check_circular_paths(s, p, n, 0.3, 0.15, 24, f, True)
    )(jstate, jnp.asarray(poses), jnp.asarray(n_poses), field_j)
    safe_t, tv_t = tfp.check_circular_paths(tstate, poses, n_poses, 0.3, 0.15, 24, field_t, True)
    np.testing.assert_array_equal(safe_t.numpy(), np.asarray(safe_j))
    np.testing.assert_allclose(tv_t.numpy(), np.asarray(tv_j), rtol=0, atol=1e-6)
    assert safe_t.any() and not safe_t.all()


# radii sqrt(a^2 + b^2) * res: the rim passes through the centres of the
# cells (a, b) off the query's own cell
RIM_CELLS = [(1, 0), (2, 1), (3, 4), (6, 3), (8, 6), (12, 5)]


@pytest.mark.parametrize("res,position,shape", [
    (0.03, (0.0, 0.0), (64, 80)), (0.05, (1.5, -2.25), (61, 77)), (0.03, (0.07, -0.11), (64, 80)),
])
def test_rim_on_cell_centres_matches_jax(res, position, shape):
    """Circles whose rim passes within an ulp of cell centres: query centres
    at k * res / 2 (cell centres, edges and corners) with radii sqrt(a^2 +
    b^2) * res, so the outer-ring distance check decides cells by the last
    bit of the cell-centre coordinate and of the squared distance.

    The plain forms ``p0 - (g + 0.5) * res`` and ``dx*dx + dy*dy`` are an
    ulp off jitted JAX in a third to a half of the cell coordinates and put
    rim cells on the other side of the check; the fused multiply-adds
    XLA:CPU compiles (``fma(-(g + 0.5), res, p0)`` and ``fma(dy, dy,
    dx*dx)``) agree everywhere. A random traversability plane makes one cell
    more or less in a circle show in its mean."""
    rng = np.random.default_rng(1)
    trav = rng.random(shape).astype(np.float32)
    trav[rng.random(shape) < 0.03] = np.nan
    mask = rng.random(shape) > 0.02
    pos = np.float32(position)
    jstate = jfp.QueryState(jnp.asarray(trav), jnp.asarray(mask), jnp.asarray(pos), res, 0.5)
    tstate = query_state_from_numpy(trav, mask, pos, res, 0.5, device="cpu")
    k = np.stack([rng.integers(-shape[0], shape[0], 1500), rng.integers(-shape[1], shape[1], 1500)], -1)
    centers = (pos.astype(np.float64) + k * res / 2).astype(np.float32)

    idx = rng.integers(-5, 90, (2000, 2)).astype(np.int32)
    want = np.asarray(jax.jit(jfp._position_of)(jstate, jnp.asarray(idx)))
    np.testing.assert_array_equal(tfp._position_of(tstate, torch.from_numpy(idx)).numpy(), want)

    n_ok = n_all = 0
    for a, b in RIM_CELLS:
        rmax = float(np.hypot(a, b)) * res
        for rmin in (0.0, 0.6 * rmax):
            ok_j, tv_j = jax.jit(lambda s, c: jfp.check_circles(s, c, rmax, rmin))(
                jstate, jnp.asarray(centers))
            ok_t, tv_t = tfp.check_circles(tstate, torch.from_numpy(centers), rmax, rmin)
            np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j), err_msg=f"{a},{b},{rmin}")
            np.testing.assert_allclose(tv_t.numpy(), np.asarray(tv_j), rtol=0, atol=1e-6,
                                       err_msg=f"{a},{b},{rmin}")
            n_ok += int(ok_t.sum())
            n_all += len(centers)
    assert 0 < n_ok < n_all
