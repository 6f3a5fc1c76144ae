"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present (a CUDA kernel
has no CPU mode; the CPU tests reach the plain versions instead). On the
machine with the card, which has no JAX (tests/conftest.py imports it):
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
``chip_smoke.py`` holds the same bars at the main path's shapes. The edge
shapes (1x1, 5x400, 337x335, 100x133 with 4% holes) test the kernels'
ragged tiles: every layer must stay bit-identical to the plain version.

The polygonal evaluators are torch ops without a kernel of their own; their
card cases hold the CUDA estimator to the same estimator on the CPU
(is_safe and dispatch equal, traversability within 2e-5, area within rtol
1e-5: only the sums run in another order), and the dense circular service
must launch kernel 2.
"""

import numpy as np
import pytest
import torch

from traversability_estimation_tpu_torch import (
    EstimatorConfig,
    FootprintConfig,
    TraversabilityEstimator,
)
from traversability_estimation_tpu_torch.ops import field_kernel, footprint, update_kernel
from traversability_estimation_tpu_torch.ops.filters import ChainConfig

pytestmark = pytest.mark.cuda

RES = 0.03
# (rows, cols, seed, NaN fraction)
EDGE_SHAPES = [(1, 1, 6, 0.0), (5, 400, 7, 0.02), (337, 335, 8, 0.01), (100, 133, 5, 0.04)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _terrain(rows, cols, seed, nan_frac, noise=0.05, tilt=0.1):
    """Terrain with slopes, a step edge and NaN holes; rough by default (most
    cells vetoed), smooth enough to drive over with a small `noise`."""
    rng = np.random.default_rng(seed)
    x = np.arange(rows)[:, None] * RES
    y = np.arange(cols)[None, :] * RES
    z = (
        0.15 * np.sin(2.0 * x) * np.cos(1.5 * y)
        + noise * rng.standard_normal((rows, cols))
        + 0.3 * ((x > x.mean()) & (y > y.mean()))
        + tilt * x
    )
    z[rng.random((rows, cols)) < nan_frac] = np.nan
    return z.astype(np.float32)


def _same(a, b):
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return bool(torch.equal(a, b))


def _check_update(elev, check_roughness, ulps=0, frame=(), **chain_kw):
    """Kernel 1 against the plain version: one launch, every layer
    bit-identical; with `ulps`, the fused layer within that many float32
    steps instead. `frame`: (origin, global shape) of the array in a larger
    map, given to both."""
    cfg = EstimatorConfig(
        resolution=RES, chain=ChainConfig(resolution=RES, **chain_kw),
        footprint=FootprintConfig(verify_roughness_footprint=check_roughness),
    )
    before = update_kernel.fused_update.launches
    got = update_kernel.fused_update(elev, cfg.chain, cfg.veto, *frame)
    want = update_kernel.fused_update_plain(elev, cfg.chain, cfg.veto, *frame)
    assert update_kernel.fused_update.launches == before + 1
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if ulps and k == "traversability":
            assert torch.equal(torch.isnan(got[k]), torch.isnan(want[k]))
            fin = torch.isfinite(want[k])
            steps = (got[k][fin].view(torch.int32) - want[k][fin].view(torch.int32)).abs()
            assert int(steps.max()) <= ulps, int(steps.max())
        else:
            assert _same(got[k], want[k]), k


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


# (origin, global shape) of a 90 x 120 array: a tile's padded block whose
# halo leaves the map at the top left; an interior block; a block past the
# map's bottom right (the padding that makes a map divide the process grid);
# a frame that cuts the array on every side
FRAMES = [((-11, -11), (300, 300)), ((40, 57), (400, 400)), ((250, 310), (330, 415)),
          ((-5, 9), (70, 100))]


@pytest.mark.parametrize("check_roughness", [False, True])
@pytest.mark.parametrize("frame", FRAMES, ids=lambda f: f"{f[0][0]}_{f[0][1]}_in_{f[1][0]}x{f[1][1]}")
def test_fused_update_kernel_with_a_map_origin(cuda, frame, check_roughness):
    """Kernel 1 placed in a larger map (the tile body of the tiled update):
    cells beyond the map hold no elevation and end no walk; every layer
    bit-identical to the plain version given the same frame."""
    elev = torch.as_tensor(_terrain(90, 120, seed=13, nan_frac=0.04), device=cuda)
    _check_update(elev, check_roughness, frame=frame)


# name -> (expression, compute_roughness, float32 steps allowed in the fused layer)
EXPRESSIONS = {
    "reference": ("(1.0 / 3.0) * (traversability_slope + traversability_step + "
                  "traversability_roughness)", True, 0),
    "two_layers": ("0.5*(traversability_slope + traversability_step)", False, 0),
    "min_max_sqrt_pow": ("max(min(traversability_slope, traversability_step), "
                         "-sqrt(traversability_roughness) + traversability_step ^ 2)", True, 0),
    "exp_sin": ("exp(-traversability_roughness) * sin(traversability_slope) + "
                "traversability_step ^ 1.5", True, 2),
}


@pytest.mark.parametrize("name", sorted(EXPRESSIONS))
@pytest.mark.parametrize("shape", [(77, 101, 9, 0.05), (337, 335, 8, 0.01)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_fused_update_kernel_fusion_expression(cuda, shape, name):
    """The fusion expression runs inside kernel 1 (its launch count rises, no
    torch op fuses on the card): arithmetic, min, max, sqrt and ^ 2 are
    bit-identical to the plain version, exp, sin and a general power within
    2 float32 steps."""
    rows, cols, seed, nan_frac = shape
    expression, rough, ulps = EXPRESSIONS[name]
    _check_update(torch.as_tensor(_terrain(rows, cols, seed, nan_frac), device=cuda), False,
                  ulps=ulps, fusion_expression=expression, compute_roughness=rough)


def test_fusion_expression_over_the_kernel_caps_raises(cuda):
    elev = torch.as_tensor(_terrain(40, 40, 1, 0.0), device=cuda)
    cfg = EstimatorConfig(resolution=RES)
    deep = "traversability_slope+(1+(2+(3+(4+(5+(6+(7+(8+9))))))))"
    for expression, what in (("+".join(["traversability_slope"] * 40), "program entries"),
                             (deep, "stack")):
        chain = ChainConfig(resolution=RES, fusion_expression=expression)
        with pytest.raises(ValueError, match=what):
            update_kernel.fused_update(elev, chain, cfg.veto)


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


RECT = np.float32([[0.45, 0.3], [0.45, -0.3], [-0.45, -0.3], [-0.45, 0.3]])
L_SHAPE = np.float32(
    [[0.45, 0.3], [0.45, -0.3], [-0.45, -0.3], [-0.45, 0.0], [0.0, 0.0], [0.0, 0.3]]
)


def _estimator_pair(cuda):
    """The estimator on the card and on the CPU, after the same update."""
    elev = _terrain(160, 144, seed=3, nan_frac=0.02, noise=0.012, tilt=0.05)
    pair = []
    for device in (cuda, "cpu"):
        est = TraversabilityEstimator(EstimatorConfig(resolution=RES), device=device)
        assert est.update(elev, position=(0.4, -0.2))
        pair.append(est)
    return pair


@pytest.mark.parametrize("mode", ["identity", "conservative", "rotated", "non_convex"])
def test_polygonal_batch_card_matches_cpu(cuda, mode):
    on_card, on_cpu = _estimator_pair(cuda)
    rng = np.random.default_rng(12)
    P, N = 96, 20
    starts = np.float32([0.4, -0.2]) + rng.uniform(-1.6, 1.6, (P, 2))
    xy = np.concatenate(
        [starts[:, None], starts[:, None] + np.cumsum(rng.uniform(-0.06, 0.06, (P, N - 1, 2)), 1)],
        axis=1,
    )
    pos3 = np.concatenate([xy, np.zeros((P, N, 1))], -1).astype(np.float32)
    quats = np.zeros((P, N, 4), np.float32)
    quats[..., 3] = 1.0
    if mode in ("rotated", "non_convex"):
        yaw = rng.uniform(0, 2 * np.pi, (P, N))
        quats[..., 2] = np.sin(yaw / 2)
        quats[..., 3] = np.cos(yaw / 2)
    n_poses = rng.integers(1, N + 1, P).astype(np.int32)
    for p in range(P):
        pos3[p, n_poses[p]:] = pos3[p, n_poses[p] - 1]
        quats[p, n_poses[p]:] = quats[p, n_poses[p] - 1]
    footprint_xy = L_SHAPE if mode == "non_convex" else RECT
    args = (pos3, quats, n_poses, footprint_xy, mode == "conservative")
    safe_g, trav_g, area_g = on_card.check_polygonal_paths_batch(*args)
    safe_c, trav_c, area_c = on_cpu.check_polygonal_paths_batch(*args)
    assert safe_g.is_cuda and on_card.last_polygonal_dispatch == on_cpu.last_polygonal_dispatch
    want = "per_segment" if mode == "non_convex" else "grouped"
    assert on_card.last_polygonal_dispatch["evaluator"] == want
    assert torch.equal(safe_g.cpu(), safe_c) and safe_c.any() and not safe_c.all()
    torch.testing.assert_close(trav_g.cpu(), trav_c, rtol=0, atol=2e-5)
    torch.testing.assert_close(area_g.cpu(), area_c, rtol=1e-5, atol=1e-6)


def test_footprint_services_card_matches_cpu(cuda):
    """Both dense services against the CPU run; the circular one launches
    kernel 2 (no plain field on a CUDA map)."""
    on_card, on_cpu = _estimator_pair(cuda)
    before = field_kernel.dense_circle_field.launches
    on_card.traversability_footprint_circle()
    assert field_kernel.dense_circle_field.launches == before + 1
    on_card.traversability_footprint_circle(radius=0.2, offset=0.1)
    assert field_kernel.dense_circle_field.launches == before + 2
    on_cpu.traversability_footprint_circle(radius=0.2, offset=0.1)
    got_map, want_map = on_card.traversability_footprint(), on_cpu.traversability_footprint()
    for name in ("traversability_footprint", "traversability_x", "traversability_rot"):
        got, want = got_map[name].cpu(), want_map[name]
        assert torch.equal(got != 0, want != 0), name
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        assert (want != 0).any() and not (want != 0).all()


@pytest.mark.parametrize("side", [189, 317])
def test_fused_update_kernel_on_a_view_of_a_larger_plane(cuda, side):
    """The online tick's shapes: the (patch + 4 halo)^2 crop (189 for a 133
    cell submap, 317 for 261) cut as a strided view out of a larger plane."""
    plane = torch.as_tensor(_terrain(700, 640, seed=21, nan_frac=0.02, noise=0.012), device=cuda)
    for i0, j0 in ((0, 0), (133, 71), (700 - side, 640 - side)):
        view = plane[i0 : i0 + side, j0 : j0 + side]
        assert not view.is_contiguous()
        _check_update(view, check_roughness=False)
    _check_update(plane[11 : 11 + side, 300 : 300 + side], check_roughness=True)


@pytest.mark.parametrize("side", [256, 512])
def test_circle_field_kernel_on_query_crops(cuda, side):
    """The online tick's query crops (256- and 512-bucketed), cut as views
    out of a larger map's planes."""
    cfg = EstimatorConfig(resolution=RES)
    elev = torch.as_tensor(_terrain(800, 720, seed=22, nan_frac=0.02, noise=0.012), device=cuda)
    layers = update_kernel.fused_update_plain(elev, cfg.chain, cfg.veto)
    n_ok = n_cells = 0
    # the last crop straddles the terrain's step edge (row 400, column 360)
    for i0, j0 in ((0, 0), (800 - side, 720 - side), (400 - side // 2, 360 - side // 2)):
        state = footprint.QueryState(
            traversability=layers["traversability"][i0 : i0 + side, j0 : j0 + side],
            traversable_mask=layers["traversable_mask"][i0 : i0 + side, j0 : j0 + side],
            position=torch.zeros(2, device=cuda), resolution=RES,
        )
        before = field_kernel.dense_circle_field.launches
        ok_k, tv_k = field_kernel.dense_circle_field(state, 0.45, 0.3)
        ok_p, tv_p = footprint.dense_circle_field(state, 0.45, 0.3)
        assert field_kernel.dense_circle_field.launches == before + 1
        assert torch.equal(ok_k, ok_p) and _same(tv_k, tv_p)
        n_ok += int(ok_k.sum())
        n_cells += ok_k.numel()
    assert 0 < n_ok < n_cells


@pytest.mark.parametrize("mode", ["circular", "roaming", "polygonal"])
def test_online_tick_card_matches_cpu(cuda, mode):
    """Four ticks on the card and on the CPU: each fused tick launches
    kernel 1 once and (circular) kernel 2 once; verdicts equal, path
    traversability within 1e-6, every map layer bit-identical except the
    float chain layers, which agree within 1e-6."""
    from traversability_estimation_tpu_torch import SyntheticTerrainSource

    src = SyntheticTerrainSource(RES)
    pair = []
    for device in (cuda, "cpu"):
        est = TraversabilityEstimator(EstimatorConfig(resolution=RES), device=device)
        est.set_elevation_map(np.full((400, 400), np.nan, np.float32))
        pair.append(est)
    rng = np.random.default_rng(0)
    for k in range(4):
        c = (1.5 * np.cos(0.3 * k), 1.5 * np.sin(0.3 * k))
        patch, _ = src.sample(c, (3.0, 3.0))
        starts = np.float32(c) + rng.uniform(-1.0, 1.0, (32, 2))
        poses = np.concatenate(
            [starts[:, None], starts[:, None] + np.cumsum(rng.uniform(-0.1, 0.1, (32, 7, 2)), 1)],
            axis=1).astype(np.float32)
        n = np.full((32,), 8, np.int32)
        kw = dict(footprint=RECT) if mode == "polygonal" else dict(radius=0.3)
        if mode == "roaming":
            kw["recenter_to"] = c
        k1, k2 = update_kernel.fused_update.launches, field_kernel.dense_circle_field.launches
        safe_g, trav_g = pair[0].online_tick(patch, c, poses, n, **kw)
        assert update_kernel.fused_update.launches == k1 + 1
        fused = k > 0
        if fused and mode != "polygonal":
            assert field_kernel.dense_circle_field.launches == k2 + 1
        safe_c, trav_c = pair[1].online_tick(patch, c, poses, n, **kw)
        assert safe_g.is_cuda and torch.equal(safe_g.cpu(), safe_c)
        torch.testing.assert_close(trav_g.cpu(), trav_c, rtol=0, atol=1e-6)
    assert safe_c.any()
    for name, want in pair[1].traversability_map.layers.items():
        got = pair[0].traversability_map[name].cpu()
        if name in ("traversability", "traversability_slope", "traversability_roughness"):
            assert torch.equal(torch.isnan(got), torch.isnan(want)), name
            torch.testing.assert_close(got.nan_to_num(0), want.nan_to_num(0), rtol=0, atol=1e-6)
        else:
            assert _same(got, want), name
    np.testing.assert_array_equal(pair[0]._position, pair[1]._position)


def test_node_round_trip_card_matches_cpu(cuda, tmp_path):
    """A node on the card behind the TCP service, under the reference-format
    configuration (its fusion expression runs inside kernel 1): an update
    request launches kernel 1 once, a circular path request kernel 2 once per
    map epoch; verdicts and polygons equal a CPU node's, traversability
    within 1e-6, and the saved bag loads back bit-identical."""
    from traversability_estimation_tpu_torch import (
        SyntheticTerrainSource,
        TraversabilityClient,
        TraversabilityNode,
        TraversabilityServer,
        config_from_documents,
        reference_documents,
    )
    from traversability_estimation_tpu_torch.utils.rosbag import load_grid_map_bag

    import dataclasses

    cfg = dataclasses.replace(
        config_from_documents(**reference_documents(), resolution=RES), min_update_rate=0.0)
    assert cfg.chain.fusion_expression and not cfg.use_generic_chain
    rng = np.random.default_rng(2)
    # the source's plateau ends at x = 5.36: the paths straddle its edge
    starts = np.float32([5.0, 0.0]) + rng.uniform(-1.5, 1.5, (24, 2))
    poses = starts[:, None] + np.cumsum(rng.uniform(-0.1, 0.1, (24, 6, 2)), 1)
    paths = [{"poses": p.tolist(), "radius": 0.3, "compute_untraversable_polygon": True}
             for p in poses[:16]]
    paths += [{"poses": p.tolist(), "footprint": RECT.tolist(),
               "compute_untraversable_polygon": True} for p in poses[16:]]
    answers = {}
    for device in ("cuda", "cpu"):
        node = TraversabilityNode(
            cfg, source=SyntheticTerrainSource(RES), robot_pose=lambda: (5.0, 0.0),
            persistent_map_length=(12.0, 12.0), device=device)
        with TraversabilityServer(node) as srv, \
                TraversabilityClient(*srv.address, timeout=120.0) as cli:
            k1, k2 = update_kernel.fused_update.launches, field_kernel.dense_circle_field.launches
            assert cli.update_traversability()["ok"]
            first = cli.check_footprint_path(paths)
            again = cli.check_footprint_path(paths)
            if device == "cuda":
                assert update_kernel.fused_update.launches == k1 + 1
                assert field_kernel.dense_circle_field.launches == k2 + 1  # cached for the epoch
            assert first == again and first["ok"]
            sub = cli.get_traversability(
                layers=["traversability", "traversability_step", "traversable_mask"],
                position=(5.0, 0.0), length=(4.0, 4.0))
            bag = str(tmp_path / f"{device}.bag")
            assert cli.save_traversability_map_to_bag(bag)["ok"]
            want = node.get_traversability_map()
            msg = load_grid_map_bag(bag)
            for k, v in msg.data.items():
                assert np.array_equal(v, want[k].cpu().numpy(), equal_nan=True), k
            answers[device] = (first["results"], sub)
    (got, got_sub), (want, want_sub) = answers["cuda"], answers["cpu"]
    assert any(not r["is_safe"] for r in want) and any(r["is_safe"] for r in want)
    for g, w in zip(got, want):
        assert g["is_safe"] == w["is_safe"]
        assert abs(g["traversability"] - w["traversability"]) <= 1e-6
        assert g.get("untraversable_polygon") == w.get("untraversable_polygon")
    assert got_sub["map_info"] == want_sub["map_info"]
    for k in ("traversability_step", "traversable_mask"):
        assert np.array_equal(got_sub["data"][k], want_sub["data"][k], equal_nan=True), k
    g, w = got_sub["data"]["traversability"], want_sub["data"]["traversability"]
    assert np.array_equal(np.isnan(g), np.isnan(w))
    assert float(np.nanmax(np.abs(g - w))) <= 1e-6
