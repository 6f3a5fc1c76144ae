"""The port's circular path queries against the JAX estimator's, on the CPU.

Both estimators query the same map state: the port's update, handed to the
JAX estimator as its query state, so the comparison isolates the path
machinery (dense field, stride-4 line samples, aggregation). Verdicts
exact; path traversability within 1e-6 (the aggregation sums in another
order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traversability_estimation_tpu.models.estimator import FootprintPath as JaxPath
from traversability_estimation_tpu.models.estimator import TraversabilityEstimator as JaxEstimator
from traversability_estimation_tpu.ops.footprint import QueryState as JaxQueryState
from traversability_estimation_tpu.utils.config import EstimatorConfig as JaxConfig
from traversability_estimation_tpu_torch import FootprintPath, TraversabilityEstimator
from traversability_estimation_tpu_torch.utils.convert import config_from_fields

RES = 0.03
POSITION = np.float32([0.05, -0.1])


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
def estimators():
    jcfg = JaxConfig(resolution=RES)
    test = TraversabilityEstimator(config_from_fields(jcfg), device="cpu")
    assert test.update(smooth_terrain(96, 120, seed=7), position=POSITION)
    qs = test.query_state
    jest = JaxEstimator(jcfg)
    jest._query_state = JaxQueryState(
        traversability=jnp.asarray(qs.traversability.numpy()),
        traversable_mask=jnp.asarray(qs.traversable_mask.numpy()),
        position=jnp.asarray(POSITION), resolution=RES,
        default_traversability=qs.default_traversability,
    )
    jest._position = POSITION.copy()
    jest.initialized = True
    return jest, test


def _paths():
    rng = np.random.default_rng(3)
    P, N = 32, 12
    ext = 96 * RES / 2 * 0.8
    starts = POSITION + rng.uniform(-ext, ext, (P, 2))
    steps = rng.uniform(-0.06, 0.06, (P, N - 1, 2))
    poses = np.concatenate(
        [starts[:, None], starts[:, None] + np.cumsum(steps, 1)], 1
    ).astype(np.float32)
    n_poses = rng.integers(1, N + 1, P).astype(np.int32)
    n_poses[:3] = [1, 1, N]
    return poses, n_poses


def test_circular_paths_batch_matches_jax(estimators):
    jest, test = estimators
    poses, n_poses = _paths()
    safe_j, trav_j = jest.check_circular_paths_batch(poses, n_poses, 0.3)
    safe_t, trav_t = test.check_circular_paths_batch(poses, n_poses, 0.3)
    np.testing.assert_array_equal(safe_t.numpy(), np.asarray(safe_j))
    np.testing.assert_allclose(trav_t.numpy(), np.asarray(trav_j), rtol=0, atol=1e-6)
    assert safe_t.any() and not safe_t.all()
    # the field of this epoch is cached and reused
    assert (0.3, 0.15) in test._field_cache


def test_crop_path_matches_full_map(estimators):
    """The query-crop path of large maps gives what the full map gives."""
    _, test = estimators
    poses, n_poses = _paths()
    poses = poses * 0.4 + POSITION * 0.6  # a compact batch: a crop smaller than the map
    full = test.check_circular_paths_batch(poses, n_poses, 0.3, crop=False)
    crop = test.check_circular_paths_batch(poses, n_poses, 0.3, crop=True)
    assert torch.equal(full[0], crop[0]) and torch.equal(full[1], crop[1])
    assert any(k[0] == "crop" for k in test._field_cache if isinstance(k[0], str))


def test_check_footprint_path_matches_jax(estimators):
    jest, test = estimators
    poses, _ = _paths()
    specs = [
        (poses[0, :1], 0.3),  # single pose: the exact sub-cell spiral
        (poses[1], 0.3),  # multi-pose
        (poses[2, :5], 0.2),  # another radius group
        (np.zeros((0, 2), np.float32), 0.3),  # empty
        (poses[4, :6], 0.3),
        (poses[5, :1] + 50.0, 0.3),  # off the map: the default verdict
    ]
    res_j = jest.check_footprint_path([JaxPath(poses=p, radius=r) for p, r in specs])
    res_t = test.check_footprint_path([FootprintPath(poses=p, radius=r) for p, r in specs])
    assert [r.is_safe for r in res_t] == [r.is_safe for r in res_j]
    np.testing.assert_allclose(
        [r.traversability for r in res_t], [r.traversability for r in res_j], rtol=0, atol=1e-6
    )
    assert res_t[3].is_safe is False and res_t[3].traversability == 0.0
    assert res_t[5].is_safe is True and res_t[5].traversability == 0.5
