"""The port's estimator against the JAX estimator, on the CPU: the update.

Both get the same configuration (carried over by config_from_fields) and the
same 96x120 map. Update layers at the chain bars of test_torch_filters.py:
step, masks and footprint layers exact; slope 5e-5; roughness and
traversability 2e-4. Path queries on each engine's own update: verdicts
exact, path traversability within the fused layer's 2e-4. The path
machinery on one shared map state is in test_torch_paths.py.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from traversability_estimation_tpu.models.estimator import FootprintPath as JaxPath
from traversability_estimation_tpu.models.estimator import TraversabilityEstimator as JaxEstimator
from traversability_estimation_tpu.utils.config import EstimatorConfig as JaxConfig
from traversability_estimation_tpu.utils.config import FootprintConfig as JaxFootprint
from traversability_estimation_tpu_torch import (
    EstimatorConfig,
    FootprintPath,
    TraversabilityEstimator,
    resolve_device,
)
from traversability_estimation_tpu_torch.ops.update_kernel import fused_update_plain
from traversability_estimation_tpu_torch.utils.convert import config_from_fields

RES = 0.03
POSITION = (0.05, -0.1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    jcfg = JaxConfig(resolution=RES, footprint=JaxFootprint(verify_roughness_footprint=True))
    elev = smooth_terrain(96, 120, seed=7)
    jest = JaxEstimator(jcfg)
    test = TraversabilityEstimator(config_from_fields(jcfg), device="cpu")
    assert jest.update(elev, position=POSITION) and test.update(elev, position=POSITION)
    return jest, test, elev


def test_config_from_fields_carries_every_field():
    jcfg = JaxConfig(resolution=0.05, max_gap_width=0.25,
                     footprint=JaxFootprint(traversability_default=0.3))
    for src in (jcfg, dataclasses.asdict(jcfg)):
        cfg = config_from_fields(src)
        assert cfg.chain.resolution == 0.05 and cfg.max_gap_width == 0.25
        assert cfg.footprint.traversability_default == 0.3
        assert dataclasses.asdict(cfg.veto) == dataclasses.asdict(jcfg.veto)
        assert cfg.chain.fusion_weights == jcfg.chain.fusion_weights


def test_update_layers_match_jax(estimators):
    jest, test, _ = estimators
    ref = {k: np.asarray(v) for k, v in jest.traversability_map.layers.items()}
    out = test.traversability_map.to_numpy()
    assert set(out) == set(ref)
    assert test.traversability_map.size == (96, 120)
    close = {"traversability_slope": 5e-5, "traversability_roughness": 2e-4,
             "traversability": 2e-4}
    for k in ref:
        assert out[k].dtype == ref[k].dtype, k
        if k in close:
            assert (np.isfinite(out[k]) == np.isfinite(ref[k])).all(), k
            fin = np.isfinite(ref[k])
            np.testing.assert_allclose(out[k][fin], ref[k][fin], rtol=0, atol=close[k], err_msg=k)
        else:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    mask = out["traversable_mask"]
    assert 0.2 < mask.mean() < 0.995


def test_paths_on_own_updates_match_jax(estimators):
    """The slice end to end: update -> circle field -> circular paths, each
    engine from its own update of the same map."""
    jest, test, _ = estimators
    rng = np.random.default_rng(5)
    P, N = 32, 12
    ext = 96 * RES / 2 * 0.8
    starts = np.float32(POSITION) + rng.uniform(-ext, ext, (P, 2))
    steps = rng.uniform(-0.06, 0.06, (P, N - 1, 2))
    poses = np.concatenate(
        [starts[:, None], starts[:, None] + np.cumsum(steps, 1)], 1
    ).astype(np.float32)
    n_poses = rng.integers(1, N + 1, P).astype(np.int32)
    n_poses[:3] = [1, 1, N]
    safe_j, trav_j = jest.check_circular_paths_batch(poses, n_poses, 0.3)
    safe_t, trav_t = test.check_circular_paths_batch(poses, n_poses, 0.3)
    np.testing.assert_array_equal(safe_t.numpy(), np.asarray(safe_j))
    np.testing.assert_allclose(trav_t.numpy(), np.asarray(trav_j), rtol=0, atol=2e-4)
    assert safe_t.any() and not safe_t.all()

    specs = [(poses[0, :1], 0.3), (poses[3, :6], 0.2), (np.zeros((0, 2), np.float32), 0.3)]
    res_j = jest.check_footprint_path([JaxPath(poses=p, radius=r) for p, r in specs])
    res_t = test.check_footprint_path([FootprintPath(poses=p, radius=r) for p, r in specs])
    assert [r.is_safe for r in res_t] == [r.is_safe for r in res_j]
    np.testing.assert_allclose(
        [r.traversability for r in res_t], [r.traversability for r in res_j], rtol=0, atol=2e-4
    )


def test_update_is_fused_update_plain_on_cpu(estimators):
    _, test, elev = estimators
    cfg = test.config
    want = fused_update_plain(torch.from_numpy(elev), cfg.chain, cfg.veto)
    for k, v in want.items():
        got = test.traversability_map[k]
        np.testing.assert_array_equal(got.numpy(), v.numpy(), err_msg=k)


def test_unported_paths_raise(estimators):
    _, test, _ = estimators
    square = np.float32([[0.2, 0.2], [0.2, -0.2], [-0.2, -0.2], [-0.2, 0.2]])
    with pytest.raises(NotImplementedError, match="A9"):
        test.check_footprint_path(FootprintPath(poses=np.zeros((2, 2)), footprint=square))
    with pytest.raises(NotImplementedError, match="A16"):
        test.check_footprint_path(
            FootprintPath(poses=np.zeros((2, 2)), radius=0.3, compute_untraversable_polygon=True)
        )
    incl = TraversabilityEstimator(
        dataclasses.replace(
            test.config,
            footprint=dataclasses.replace(test.config.footprint, check_robot_inclination=True),
        ),
        device="cpu",
    )
    incl.update(np.zeros((40, 40), np.float32))
    with pytest.raises(NotImplementedError, match="A16"):
        incl.check_circular_paths_batch(np.zeros((1, 2, 2), np.float32), np.int32([2]), 0.3)
    with pytest.raises(NotImplementedError, match="A11"):
        EstimatorConfig(use_generic_chain=True)


def test_cuda_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TraversabilityEstimator(EstimatorConfig())
    with pytest.raises(RuntimeError):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_port_imports_nothing_of_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import traversability_estimation_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.split('.')[0] == 'traversability_estimation_tpu')\n"
        "assert not bad, bad\n"
        "print('modules', len([m for m in sys.modules if m.startswith(pkg.__name__)]))\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15
