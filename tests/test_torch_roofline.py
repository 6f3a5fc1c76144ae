"""The port's roofline (``utils/roofline.py``) on the CPU: its work counts
and its verdict arithmetic equal the JAX package's exactly (the default
chain, the reference expression's chain, other radii, the roughness veto on
and off), the spec-sheet bound that ``chip_smoke.py`` now reads from it,
and the measured peaks refusing to run anywhere but the card. The peaks
themselves are measured on the card (``chip_smoke.py`` phase 10 and the
``cuda`` case of tests/test_torch_kernels.py).
"""

from pathlib import Path

import pytest
import torch

from traversability_estimation_tpu.ops.filters import ChainConfig as JChain
from traversability_estimation_tpu.ops.veto import VetoConfig as JVeto
from traversability_estimation_tpu.utils import roofline as jroof
from traversability_estimation_tpu_torch.ops.filters import ChainConfig
from traversability_estimation_tpu_torch.ops.veto import VetoConfig
from traversability_estimation_tpu_torch.utils import roofline

REFERENCE_EXPRESSION = ("(1.0 / 3.0) * (traversability_slope + traversability_step + "
                        "traversability_roughness)")
CHAINS = {
    "default": {"resolution": 0.03},
    "reference expression": {"resolution": 0.03, "fusion_expression": REFERENCE_EXPRESSION},
    "unshared roughness radius": {"resolution": 0.03, "normals_radius": 0.08,
                                  "roughness_estimation_radius": 0.1,
                                  "step_second_window_radius": 0.09},
    "no roughness, 0.06 m": {"resolution": 0.06, "compute_roughness": False},
}


@pytest.mark.parametrize("chain", list(CHAINS))
@pytest.mark.parametrize("check_roughness", [False, True])
def test_update_op_estimate_equals_jax(chain, check_roughness):
    kw = CHAINS[chain]
    veto = {"resolution": kw["resolution"], "check_roughness": check_roughness}
    got = roofline.update_op_estimate(ChainConfig(**kw), VetoConfig(**veto))
    want = jroof.update_op_estimate(JChain(**kw), JVeto(**veto))
    assert got == want
    assert got["ops_per_cell"] == got["f32_ops_per_cell"] + got["bool_ops_per_cell"] > 0


@pytest.mark.parametrize("radius, resolution", [(0.45, 0.03), (0.3, 0.03), (0.6, 0.06)])
def test_circle_field_op_estimate_equals_jax(radius, resolution):
    assert roofline.circle_field_op_estimate(radius, resolution) == \
        jroof.circle_field_op_estimate(radius, resolution)
    assert roofline._n_offsets(radius, resolution) == jroof._n_offsets(radius, resolution)


@pytest.mark.parametrize("chain", ["default", "reference expression"])
@pytest.mark.parametrize("rates", [
    {},
    {"bool_ops_per_s": 16.7e12},
    {"bool_ops_per_s": 16.7e12, "shift_cost_s": 6e-8},
])
def test_sol_report_equals_jax(chain, rates):
    cfg = CHAINS[chain]
    counts = roofline.update_op_estimate(ChainConfig(**cfg), VetoConfig(resolution=0.03))
    for cells, t in ((336 * 336, 3.25e-5), (189 * 189, 2.6e-5), (1667 * 1667, 5.1e-4)):
        got = roofline.sol_report(cells, t, counts, 66e12, 2.9e12, **rates)
        want = jroof.sol_report(cells, t, counts, 66e12, 2.9e12, **rates)
        assert got == want
    field = roofline.circle_field_op_estimate(0.45, 0.03)
    assert roofline.sol_report(65536, 2e-5, field, 66e12, 2.9e12, **rates) == \
        jroof.sol_report(65536, 2e-5, field, 66e12, 2.9e12, **rates)


def test_spec_sheet_bound():
    assert roofline.bound(3.35e12, 0) == (1e3, "bytes")
    assert roofline.bound(0, 67e12) == (1e3, "operations")
    ms, by = roofline.bound(1e9, 1e12)
    assert by == "operations" and ms == pytest.approx(1e3 / 67)


def test_chip_smoke_reads_its_bounds_from_the_roofline():
    src = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    for own in ("PEAK_F32_FLOPS =", "PEAK_BYTES =", "SM_CLOCK_MAX_HZ =", "67e12", "3.35e12",
                "1.98e9", "def bound("):
        assert own not in src, own
    assert "roofline.bound(" in src and "roofline.sol_report(" in src


@pytest.mark.parametrize("measure", ["measure_vpu_f32_flops", "measure_vpu_bool_ops",
                                     "measure_hbm_bw", "measure_peaks", "spec_peaks"])
def test_peaks_are_the_cards(measure):
    with pytest.raises(ValueError, match="card"):
        getattr(roofline, measure)(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            getattr(roofline, measure)()


def test_shift_measurements_are_the_cards():
    with pytest.raises(ValueError, match="card"):
        roofline.measure_static_shift_cost((64, 64), device="cpu")
    with pytest.raises(ValueError, match="card"):
        roofline.measure_shift_floor((64, 64), 16, 4, device="cpu")

