"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present (a CUDA kernel
has no CPU mode; the CPU tests reach the plain versions instead). On the
machine with the card, which has no JAX (tests/conftest.py imports it):
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
``chip_smoke.py`` holds the same bars at the main path's shapes. The edge
shapes (1x1, 5x400, 337x335, 100x133 with 4% holes) test the kernels'
ragged tiles: every layer must stay bit-identical to the plain version.
"""

import numpy as np
import pytest
import torch

from traversability_estimation_tpu_torch import EstimatorConfig, FootprintConfig
from traversability_estimation_tpu_torch.ops import field_kernel, footprint, update_kernel

pytestmark = pytest.mark.cuda

RES = 0.03
# (rows, cols, seed, NaN fraction)
EDGE_SHAPES = [(1, 1, 6, 0.0), (5, 400, 7, 0.02), (337, 335, 8, 0.01), (100, 133, 5, 0.04)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _terrain(rows, cols, seed, nan_frac):
    """Rough terrain with slopes, a step edge and NaN holes."""
    rng = np.random.default_rng(seed)
    x = np.arange(rows)[:, None] * RES
    y = np.arange(cols)[None, :] * RES
    z = (
        0.15 * np.sin(2.0 * x) * np.cos(1.5 * y)
        + 0.05 * rng.standard_normal((rows, cols))
        + 0.3 * ((x > x.mean()) & (y > y.mean()))
        + 0.1 * x
    )
    z[rng.random((rows, cols)) < nan_frac] = np.nan
    return z.astype(np.float32)


def _same(a, b):
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return bool(torch.equal(a, b))


def _check_update(elev, check_roughness):
    cfg = EstimatorConfig(
        resolution=RES, footprint=FootprintConfig(verify_roughness_footprint=check_roughness)
    )
    before = update_kernel.fused_update.launches
    got = update_kernel.fused_update(elev, cfg.chain, cfg.veto)
    want = update_kernel.fused_update_plain(elev, cfg.chain, cfg.veto)
    assert update_kernel.fused_update.launches == before + 1
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and _same(got[k], want[k]), k


def _check_field(elev, radius_min, cuda):
    cfg = EstimatorConfig(resolution=RES)
    layers = update_kernel.fused_update_plain(elev, cfg.chain, cfg.veto)
    state = footprint.QueryState(
        traversability=layers["traversability"], traversable_mask=layers["traversable_mask"],
        position=torch.zeros(2, device=cuda), resolution=RES,
    )
    in_map = torch.as_tensor(np.random.default_rng(1).random(elev.shape) > 0.1, device=cuda)
    for im in (None, in_map):
        before = field_kernel.dense_circle_field.launches
        ok_k, tv_k = field_kernel.dense_circle_field(state, 0.45, radius_min, im)
        ok_p, tv_p = footprint.dense_circle_field(state, 0.45, radius_min, im)
        assert field_kernel.dense_circle_field.launches == before + 1
        assert torch.equal(ok_k, ok_p) and _same(tv_k, tv_p)


@pytest.mark.parametrize("check_roughness", [False, True])
def test_fused_update_kernel_matches_plain(cuda, check_roughness):
    elev = torch.as_tensor(_terrain(77, 101, seed=9, nan_frac=0.05), device=cuda)
    _check_update(elev, check_roughness)


@pytest.mark.parametrize("check_roughness", [False, True])
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_fused_update_kernel_edge_shapes(cuda, shape, check_roughness):
    rows, cols, seed, nan_frac = shape
    _check_update(torch.as_tensor(_terrain(rows, cols, seed, nan_frac), device=cuda),
                  check_roughness)


@pytest.mark.parametrize("radius_min", [0.3, 0.0])
def test_circle_field_kernel_matches_plain(cuda, radius_min):
    _check_field(torch.as_tensor(_terrain(90, 70, seed=4, nan_frac=0.03), device=cuda),
                 radius_min, cuda)


@pytest.mark.parametrize("radius_min", [0.3, 0.0])
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_circle_field_kernel_edge_shapes(cuda, shape, radius_min):
    rows, cols, seed, nan_frac = shape
    _check_field(torch.as_tensor(_terrain(rows, cols, seed, nan_frac), device=cuda),
                 radius_min, cuda)
