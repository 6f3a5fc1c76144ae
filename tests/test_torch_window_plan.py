"""The polygonal dispatch's window plan on the device
(``ops/footprint.path_window_plan``) against the NumPy window planners, on
the CPU.

The plan, turned into windows on the host (``planned_windows``), must give
the NumPy planners' integers exactly, and the identity flag of the host test
``|q - (0, 0, 0, 1)| < 1e-12``: a window one cell wider or narrower reorders
the grouped evaluator's sums. Its integers and pose extents are held to the
port's NumPy planners and to the JAX package's (``per_path_window_cells``,
``path_group_window_exact``, ``path_group_window``, ``path_block_window``),
and the estimator's dispatch record to the one those planners give, in all
three tiers.
"""

import numpy as np
import pytest
import torch

from traversability_estimation_tpu.ops import footprint as jfp
from traversability_estimation_tpu_torch import EstimatorConfig, TraversabilityEstimator
from traversability_estimation_tpu_torch.models import estimator as tmod
from traversability_estimation_tpu_torch.ops import footprint as tfp

RES = 0.03
POSITION = np.float32([0.05, -0.1])
RECT = np.float32([[0.45, 0.3], [0.45, -0.3], [-0.45, -0.3], [-0.45, 0.3]])
_ANGLES = np.arange(16) * (2 * np.pi / 16)
GON16 = np.stack([0.4 * np.cos(_ANGLES), 0.3 * np.sin(_ANGLES)], -1).astype(np.float32)
# no mirror symmetry: a rotation's sign shows in its vertex bbox
KITE = np.float32([[0.5, 0.1], [-0.2, 0.35], [-0.3, -0.25]])
FOOTPRINTS = {"rect": RECT, "16gon": GON16, "kite": KITE}
IDENTITY = np.asarray([0, 0, 0, 1])


def _batch(kind, seed, P=48, N=21, drift=False):
    """A pose batch of `kind`: random-walk paths around the map's centre
    (with `drift`, steps of one sign: long paths whose blocks are much
    smaller than the path), quaternions per kind, padded poses repeating the
    last valid one."""
    rng = np.random.default_rng(seed)
    if kind == "single_pose":
        N = 1
    starts = POSITION + rng.uniform(-1.0, 1.0, (P, 2))
    if kind == "wide_steps":  # few poses far apart: the neighbours' vertices count
        N = 3
    step = 0.5 if kind == "wide_steps" else 0.06
    steps = rng.uniform(0.0 if drift else -step, step, (P, N - 1, 2))
    xy = np.concatenate([starts[:, None], starts[:, None] + np.cumsum(steps, 1)], 1)
    pos3 = np.concatenate([xy, rng.uniform(-0.1, 0.1, (P, N, 1))], -1).astype(np.float32)
    quats = np.zeros((P, N, 4), np.float32)
    quats[..., 3] = 1.0
    if kind in ("random_yaw", "padded", "single_pose", "long", "float64_quats", "wide_steps"):
        yaw = rng.uniform(-np.pi, np.pi, (P, N))
        quats[..., 2] = np.sin(yaw / 2)
        quats[..., 3] = np.cos(yaw / 2)
    if kind == "general":  # unnormalised, a zero quaternion among them
        quats = rng.standard_normal((P, N, 4)).astype(np.float32)
        quats[0, 0] = 0.0
    n_poses = np.full((P,), N, np.int32)
    if kind in ("padded", "identity_padded"):
        n_poses = rng.integers(1, N + 1, P).astype(np.int32)
        n_poses[:3] = [1, 2, N]
        for p in range(P):
            pos3[p, n_poses[p]:] = pos3[p, n_poses[p] - 1]
            quats[p, n_poses[p]:] = quats[p, n_poses[p] - 1]
    if kind == "float64_quats":
        quats = quats.astype(np.float64)
        quats[1, 2] += 1e-10  # below float32's resolution, seen in float64
    if kind == "near_identity":
        quats = quats.astype(np.float64)
        quats[..., 2] = 5e-13  # within the identity test's 1e-12
    if kind == "roll_only":  # w exactly 1, one pose rolled past 1e-12
        quats[P // 2, N // 2, 0] = -1e-9
    if kind == "w_below":  # one w short of 1 by more than 1e-12, in float64
        quats = quats.astype(np.float64)
        quats[P // 3, 0, 3] = 1.0 - 1e-9
    return pos3, quats, n_poses


BATCHES = ["random_yaw", "identity", "padded", "identity_padded", "single_pose", "long",
           "wide_steps", "general", "float64_quats", "near_identity", "roll_only", "w_below"]


@pytest.mark.parametrize("fp_name", list(FOOTPRINTS))
@pytest.mark.parametrize("kind", BATCHES)
def test_window_plan_equals_numpy_planners(kind, fp_name):
    fp = FOOTPRINTS[fp_name]
    seed = 40 + BATCHES.index(kind)
    pos3, quats, _ = _batch(kind, seed, N=38 if kind == "long" else 21)
    plan = tfp.path_window_plan(torch.from_numpy(pos3), torch.from_numpy(quats),
                                torch.from_numpy(fp))
    assert plan.dtype == torch.float64 and plan.shape == (14,)
    plan = plan.tolist()
    reach_x, reach_y, ext_x, ext_y, block_x, block_y = plan[8:]
    assert plan[:8] == quats.min(axis=(0, 1)).tolist() + quats.max(axis=(0, 1)).tolist()

    identity = bool(np.all(np.abs(quats - IDENTITY) < 1e-12))
    assert identity == (kind in ("identity", "identity_padded", "near_identity"))
    ext = pos3[..., :2].max(axis=1) - pos3[..., :2].min(axis=1)
    assert (ext_x, ext_y) == tuple(ext.max(axis=0).astype(np.float64))
    exact = tfp.path_group_window_exact(fp, pos3, quats, RES)
    assert exact == jfp.path_group_window_exact(fp, pos3, quats, RES) == \
        tuple(jfp.per_path_window_cells(fp, pos3, quats, RES).max(axis=0))
    assert (tfp._window_cells(reach_x, RES), tfp._window_cells(reach_y, RES)) == exact
    want_group = jfp.path_group_window(fp, ext, RES, True) if identity else exact
    assert tfp.planned_windows(plan, fp, RES) == (
        identity, want_group, jfp.path_block_window(fp, pos3, RES, identity))
    for orient in (True, False):
        assert tfp.path_group_window(fp, np.float64([[ext_x, ext_y]]), RES, orient) == \
            tfp.path_group_window(fp, ext, RES, orient) == \
            jfp.path_group_window(fp, ext, RES, orient)
        assert tfp.path_group_window(fp, np.float64([[block_x, block_y]]), RES, orient) == \
            tfp.path_block_window(fp, pos3, RES, orient) == \
            jfp.path_block_window(fp, pos3, RES, orient)
    if kind == "long":  # several blocks, the last one partial
        assert block_x < ext.max() and (pos3.shape[1] - 1) % tfp.SEG_BLOCK


def _numpy_dispatch(pos3, quats, fp, conservative, cap):
    """The dispatch record of the NumPy planners, by the rules of
    ``_dispatch_polygonal``."""
    identity = bool(np.all(np.abs(quats - IDENTITY) < 1e-12))
    convex = jfp.is_convex_polygon(fp)
    if identity:
        ext = pos3[..., :2].max(axis=1) - pos3[..., :2].min(axis=1)
        gw = jfp.path_group_window(fp, ext, RES, True)
    else:
        gw = jfp.path_group_window_exact(fp, pos3, quats, RES)
    bw = jfp.path_block_window(fp, pos3, RES, identity)
    B = pos3.shape[0]
    use_blocks = pos3.shape[1] > 2 and gw[0] * gw[1] * B > cap and bw[0] * bw[1] * B <= cap
    eff = bw if use_blocks else gw
    grouped = convex and eff[0] * eff[1] * B <= cap
    return {
        "evaluator": "grouped" if grouped else "per_segment",
        "reason": "ok" if grouped else ("non_convex_footprint" if not convex else "window_cap"),
        "paths": B,
        "translate_only": identity and not conservative and convex,
        "group_window": gw,
        "block_window": bw if use_blocks else None,
        "group_window_elems": eff[0] * eff[1] * B,
    }


@pytest.fixture(scope="module")
def estimator():
    rng = np.random.default_rng(5)
    est = TraversabilityEstimator(EstimatorConfig(resolution=RES), device="cpu")
    assert est.update((0.01 * rng.standard_normal((128, 128))).astype(np.float32),
                      position=POSITION)
    return est


@pytest.mark.parametrize("tier", ["grouped", "block_window", "window_cap"])
@pytest.mark.parametrize("kind", ["random_yaw", "identity", "conservative"])
def test_dispatch_record_unchanged(estimator, monkeypatch, kind, tier):
    """The estimator's ``last_polygonal_dispatch`` is the NumPy planners'
    for long drifting paths, in each tier; a small ``_GROUPED_ELEMS_CAP``
    stands in for a batch past the window cap."""
    pos3, quats, n_poses = _batch(
        "padded" if kind != "identity" else "identity_padded", 60, P=12, N=33, drift=True)
    conservative = kind == "conservative"
    full = _numpy_dispatch(pos3, quats, RECT, conservative, tmod._GROUPED_ELEMS_CAP)
    gw_elems = full["group_window_elems"]
    block = _numpy_dispatch(pos3, quats, RECT, conservative, gw_elems - 1)
    cap = {"grouped": tmod._GROUPED_ELEMS_CAP, "block_window": gw_elems - 1,
           "window_cap": block["group_window_elems"] - 1}[tier]
    want = _numpy_dispatch(pos3, quats, RECT, conservative, cap)
    assert (want["evaluator"], want["block_window"] is not None) == {
        "grouped": ("grouped", False), "block_window": ("grouped", True),
        "window_cap": ("per_segment", False)}[tier]
    monkeypatch.setattr(tmod, "_GROUPED_ELEMS_CAP", cap)
    safe, trav, area = estimator.check_polygonal_paths_batch(
        pos3, quats, n_poses, RECT, conservative)
    assert estimator.last_polygonal_dispatch == want
    assert safe.shape == (12,) and bool(torch.isfinite(trav).all())
    assert bool(torch.isfinite(area).all()) and bool((area > 0).any())
