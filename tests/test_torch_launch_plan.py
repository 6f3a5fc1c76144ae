"""The launch plans of the port's CUDA kernels, on the CPU.

The kernels run only on the card, but their geometry is computed on the
host (``field_kernel.launch_plan`` / ``delta_table``,
``update_kernel.launch_plan``) and the kernels launch the plan they are
given, so these tests check it here: the grid covers the map, a block's
shared memory fits an H100 SM, every launch at 336^2 gives each of the
card's SMs at least 24 warps to switch between, and kernel 2's linear
offset deltas address the same window cells as the spiral table's (oi, oj).
"""

import numpy as np
import pytest

from traversability_estimation_tpu_torch import EstimatorConfig
from traversability_estimation_tpu_torch.ops import field_kernel, footprint, update_kernel
from traversability_estimation_tpu_torch.ops.filters import ChainConfig
from traversability_estimation_tpu_torch.ops.veto import VetoConfig

RES = 0.03
H100_SMS = 132
MIN_WARPS_PER_SM = 24  # 6 per scheduler: enough to hide a dependent chain's latency
SMEM_LIMIT = 232_448
# the last four are the online tick's: the update crop of a 133- and a
# 261-cell submap, a query crop, and the whole 50 m map of the first tick
SHAPES = [(1, 1), (5, 400), (337, 335), (336, 336), (100, 133), (2048, 2048),
          (189, 189), (317, 317), (256, 256), (1667, 1667)]


def _field_plan(H, W, radius_max=0.45):
    offs, _ = footprint.field_tables(radius_max, RES)
    return field_kernel.launch_plan(H, W, int(np.abs(offs).max()), len(offs))


def _update_plan(H, W, cfg=None):
    cfg = cfg or EstimatorConfig(resolution=RES)
    return update_kernel.launch_plan(update_kernel.kernel_params(cfg.chain, cfg.veto), H, W)


def _covers(grid, block_tile, H, W):
    (gx, gy), (tw, th) = grid, block_tile
    return gx * tw >= W > (gx - 1) * tw and gy * th >= H > (gy - 1) * th


@pytest.mark.parametrize("shape", SHAPES)
def test_plans_cover_the_map(shape):
    H, W = shape
    fp = _field_plan(H, W)
    assert _covers(fp.grid, (field_kernel.TILE_W, field_kernel.TILE_H), H, W)
    assert fp.block == (field_kernel.TILE_W, field_kernel.TILE_H)
    up = _update_plan(H, W)
    th_layers, th_veto = update_kernel.TILE_H
    assert _covers(up.grid_layers, (update_kernel.TILE_W, th_layers), H, W)
    assert _covers(up.grid_veto, (update_kernel.TILE_W, th_veto), H, W)
    assert up.block_layers == (update_kernel.TILE_W, th_layers)
    assert up.block_veto == (update_kernel.TILE_W, th_veto)
    # the C entry point reads the plan in this order
    assert list(up.as_c_ints()) == [
        *up.grid_layers, *up.block_layers, up.smem_layers,
        *up.grid_veto, *up.block_veto, up.smem_veto,
    ]


def test_plans_fill_the_card_at_336():
    # every launch, kernel 1's veto kernel included; one thread per cell
    # gives 112,896 / 32 / 132 = 26.7 warps per SM before ragged tiles
    for warps in (_field_plan(336, 336).warps, *_update_plan(336, 336).warps):
        assert warps / H100_SMS >= MIN_WARPS_PER_SM


def test_online_tick_crop_is_one_thin_wave():
    """The 189 x 189 update crop of a 133-cell submap: 6 x 24 blocks of 8
    warps for the layers kernel, 6 x 12 of 16 for the vetoes, under 9 warps
    per SM (the map-sized launches give 28 or more)."""
    from traversability_estimation_tpu_torch.ops.veto import required_halo

    cfg = EstimatorConfig(resolution=RES)
    side = 133 + 4 * required_halo(cfg.chain, cfg.veto)
    assert side == 189
    plan = _update_plan(side, side)
    assert plan.grid_layers == (6, 24) and plan.grid_veto == (6, 12)
    assert plan.warps == (6 * 24 * 8, 6 * 12 * 16)
    assert all(8 < w / H100_SMS < 9 for w in plan.warps)
    assert _field_plan(256, 256).warps / H100_SMS > 15


def test_field_plan_shared_memory_fits():
    # default radius, and the widest spiral the kernel takes
    plans = [_field_plan(336, 336)]
    radius = 0.45
    while len(footprint.field_tables(radius + RES, RES)[0]) <= field_kernel.FIELD_MAX_OFFS:
        radius += RES
    offs, _ = footprint.field_tables(radius, RES)
    assert len(offs) > field_kernel.FIELD_MAX_OFFS // 2
    plans.append(_field_plan(336, 336, radius))
    for plan in plans:
        assert plan.smem_bytes <= SMEM_LIMIT
        assert field_kernel.TILE_W + 2 * plan.reach <= plan.stride
    with pytest.raises(ValueError):
        field_kernel.launch_plan(336, 336, 40, field_kernel.FIELD_MAX_OFFS + 1)


def test_update_plan_shared_memory_fits():
    default = _update_plan(336, 336)
    # stencil tables at their caps: every window radius as wide as MAX_WIN
    # offsets allow, separate roughness moments, a 1 m gap walk
    widest = 0.03
    while len(update_kernel.circle_offsets(widest + RES, RES)) <= update_kernel.MAX_WIN:
        widest += RES
    chain = ChainConfig(
        resolution=RES, normals_radius=widest, step_first_window_radius=widest,
        step_second_window_radius=widest, roughness_estimation_radius=widest - RES,
    )
    veto = VetoConfig(resolution=RES, max_gap_width=1.0, check_roughness=True)
    params = update_kernel.kernel_params(chain, veto)
    assert params.n_mom_n <= update_kernel.MAX_WIN and not params.rough_shared
    capped = update_kernel.launch_plan(params, 336, 336)
    for plan in (default, capped):
        assert plan.smem_layers + plan.static_layers <= SMEM_LIMIT
        assert plan.smem_veto + plan.static_veto <= SMEM_LIMIT
    assert capped.smem_layers > default.smem_layers
    # a walk too long for one block's window is refused on the host
    huge = update_kernel.kernel_params(chain, VetoConfig(resolution=RES, max_gap_width=8.0))
    with pytest.raises(ValueError):
        update_kernel.launch_plan(huge, 336, 336)


@pytest.mark.parametrize("radius_max", [0.45, 0.35, 0.03])
def test_delta_table_addresses_spiral_cells(radius_max):
    offs, _ = footprint.field_tables(radius_max, RES)
    plan = _field_plan(336, 336, radius_max)
    R, stride = plan.reach, plan.stride
    deltas = field_kernel.delta_table(offs, R, stride)
    rows = field_kernel.TILE_H + 2 * R
    window = np.random.default_rng(3).random((rows, stride)).astype(np.float32)
    li, lj = np.meshgrid(
        np.arange(field_kernel.TILE_H), np.arange(field_kernel.TILE_W), indexing="ij"
    )
    base = (li * stride + lj).ravel()
    got = window.ravel()[base[:, None] + deltas[None, :]]
    want = window[
        li.ravel()[:, None] + R + offs[None, :, 0], lj.ravel()[:, None] + R + offs[None, :, 1]
    ]
    np.testing.assert_array_equal(got, want)
    assert deltas.dtype == np.int32 and deltas.min() >= 0
    assert (base.max() + deltas.max()) < rows * stride
