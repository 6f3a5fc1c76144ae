"""The port's polygon geometry and batched convex hull against jitted JAX,
on the CPU.

Both engines get the same point sets, made from numpy seeds. Hull vertices
are selects of input points in both, so vertex values and vertex counts must
be equal, duplicates, collinear points and degenerate sets included; areas
within rtol 1e-5 (the shoelace terms are summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traversability_estimation_tpu.grid import geometry as jgeo
from traversability_estimation_tpu.ops import hull as jhull
from traversability_estimation_tpu_torch.grid import geometry as tgeo
from traversability_estimation_tpu_torch.ops import hull as thull


def _random_sets(seed, B=64, M=8):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.0, 1.0, (B, M, 2)).astype(np.float32)
    n_valid = rng.integers(3, M + 1, B).astype(np.int32)
    return pts, n_valid


def _with_duplicates(seed):
    pts, n_valid = _random_sets(seed)
    rng = np.random.default_rng(seed + 100)
    for b in range(len(pts)):
        src, dst = rng.integers(0, n_valid[b], 2)
        pts[b, dst] = pts[b, src]
    return pts, n_valid


def _with_collinear(seed):
    """Points placed on the segment between two others, at dyadic fractions
    of integer-valued coordinates so the collinearity is exact."""
    rng = np.random.default_rng(seed)
    B, M = 64, 8
    pts = rng.integers(-8, 9, (B, M, 2)).astype(np.float32)
    for b in range(B):
        pts[b, 2] = 0.5 * (pts[b, 0] + pts[b, 1])
        pts[b, 5] = 0.25 * pts[b, 3] + 0.75 * pts[b, 4]
    return pts, np.full((B,), M, np.int32)


def _degenerate(seed):
    """All points identical; all points on one line; a single valid point."""
    rng = np.random.default_rng(seed)
    M = 8
    same = np.repeat(rng.uniform(-1, 1, (8, 1, 2)), M, axis=1)
    t = rng.integers(-6, 7, (8, M, 1)).astype(np.float64)
    line = t * np.array([1.0, 2.0]) + np.array([0.5, -0.25])
    one = rng.uniform(-1, 1, (8, M, 2))
    pts = np.concatenate([same, line, one]).astype(np.float32)
    n_valid = np.concatenate([np.full(16, M), np.ones(8)]).astype(np.int32)
    return pts, n_valid


def _swept(seed):
    """The conservative sweep's point set: a footprint at two poses plus the
    unrotated copies, where cur - d repeats prev exactly."""
    rng = np.random.default_rng(seed)
    fp = np.float32([[0.45, 0.3], [0.45, -0.3], [-0.45, -0.3], [-0.45, 0.3]])
    B = 64
    a = rng.uniform(-2, 2, (B, 1, 2)).astype(np.float32)
    d = rng.uniform(-0.06, 0.06, (B, 1, 2)).astype(np.float32)
    prev = fp[None] + a
    cur = prev + d
    pts = np.concatenate([prev, cur - d, cur, prev + d], axis=1).astype(np.float32)
    return pts, np.full((B,), pts.shape[1], np.int32)


CASES = {
    "random": _random_sets,
    "duplicates": _with_duplicates,
    "collinear": _with_collinear,
    "degenerate": _degenerate,
    "conservative_sweep": _swept,
}


@pytest.mark.parametrize("case", CASES)
def test_convex_hull_batch_matches_jax(case):
    pts, n_valid = CASES[case](seed=11)
    hull_j, n_j = jax.jit(jhull.convex_hull_batch)(jnp.asarray(pts), jnp.asarray(n_valid))
    hull_t, n_t = thull.convex_hull_batch(torch.from_numpy(pts), torch.from_numpy(n_valid))
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(hull_t.numpy(), np.asarray(hull_j))
    if case == "random":
        assert 3 <= n_t.min() and n_t.max() > 4
    if case == "degenerate":
        assert n_t.max() <= 2


@pytest.mark.parametrize("case", ["random", "duplicates", "collinear", "conservative_sweep"])
def test_hull_edge_matrix_matches_jax(case):
    pts, n_valid = CASES[case](seed=12)
    valid = np.arange(pts.shape[1])[None, :] < n_valid[:, None]
    edges_j = jax.jit(jhull.hull_edge_matrix)(jnp.asarray(pts), jnp.asarray(valid))
    edges_t = thull.hull_edge_matrix(torch.from_numpy(pts), torch.from_numpy(valid))
    np.testing.assert_array_equal(edges_t.numpy(), np.asarray(edges_j))


def test_convex_hull_chunks_and_single(monkeypatch):
    """A batch split into chunks gives what one chunk gives, and the
    one-set form is the batch's row."""
    pts, n_valid = _random_sets(seed=13, B=50)
    whole = thull.convex_hull_batch(torch.from_numpy(pts), torch.from_numpy(n_valid))
    monkeypatch.setattr(thull, "_CHUNK_ELEMS", 7 * 8**3)
    parts = thull.convex_hull_batch(torch.from_numpy(pts), torch.from_numpy(n_valid))
    assert torch.equal(whole[0], parts[0]) and torch.equal(whole[1], parts[1])
    hull0, n0 = thull.convex_hull(torch.from_numpy(pts[0]), int(n_valid[0]))
    assert torch.equal(hull0, whole[0][0]) and int(n0) == int(whole[1][0])


def test_polygon_contains_and_area_match_jax():
    pts, n_valid = _random_sets(seed=14, B=32)
    hull, n_hull = thull.convex_hull_batch(torch.from_numpy(pts), torch.from_numpy(n_valid))
    rng = np.random.default_rng(15)
    query = rng.uniform(-1.0, 1.0, (32, 200, 2)).astype(np.float32)
    # raw (non-convex) rings and their hulls
    for verts, nv in ((pts, n_valid), (hull.numpy(), n_hull.numpy())):
        inside_j = jax.jit(jax.vmap(jgeo.polygon_contains))(
            jnp.asarray(verts), jnp.asarray(nv), jnp.asarray(query)
        )
        inside_t = tgeo.polygon_contains(
            torch.from_numpy(verts), torch.from_numpy(nv), torch.from_numpy(query)
        )
        np.testing.assert_array_equal(inside_t.numpy(), np.asarray(inside_j))
        assert 0.05 < inside_t.float().mean() < 0.95
        area_j = jax.jit(jax.vmap(jgeo.polygon_area))(jnp.asarray(verts), jnp.asarray(nv))
        area_t = tgeo.polygon_area(torch.from_numpy(verts), torch.from_numpy(nv))
        np.testing.assert_allclose(area_t.numpy(), np.asarray(area_j), rtol=1e-5, atol=1e-7)
    # a static vertex count, as the path evaluators pass it
    area_t = tgeo.polygon_area(torch.from_numpy(pts), 8)
    area_j = jax.vmap(jgeo.polygon_area, in_axes=(0, None))(jnp.asarray(pts), 8)
    np.testing.assert_allclose(area_t.numpy(), np.asarray(area_j), rtol=1e-5, atol=1e-7)
