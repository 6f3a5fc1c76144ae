"""NumPy oracle for the reference filter chain — the bit-level referee.

Faithful re-statement (in vectorized NumPy, float64 accumulation, float32
storage, matching the C++ double-compute/float-store convention) of:

- grid_map_filters NormalVectorsFilter ("area"/PCA method; configured at
  the reference's traversability_estimation/config/robot_filter_parameter.yaml:2-8),
- SlopeFilter (the reference's traversability_estimation_filters/src/SlopeFilter.cpp:59-89),
- StepFilter (…/src/StepFilter.cpp:102-182, two windowed passes),
- RoughnessFilter (…/src/RoughnessFilter.cpp:73-132, plane-residual std),
- MathExpressionFilter weighted fusion + DeletionFilter
  (robot_filter_parameter.yaml:24-32).

NaN semantics: every layer output is NaN ("unknown") wherever the reference
leaves the cell untouched.

This module is NOT the compute path (see
``traversability_estimation_tpu_torch.ops``): it is deliberately simple and is
used by tests as ground truth. It imports numpy and the port's host geometry
only.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from traversability_estimation_tpu_torch.grid.geometry import circle_offsets


def cell_positions(shape: Tuple[int, int], resolution: float, position=(0.0, 0.0)):
    """Cell-center map-frame coordinates, float64, grid_map convention."""
    rows, cols = shape
    half_x, half_y = rows * resolution / 2.0, cols * resolution / 2.0
    x = position[0] + half_x - 0.5 * resolution - np.arange(rows) * resolution
    y = position[1] + half_y - 0.5 * resolution - np.arange(cols) * resolution
    return np.broadcast_to(x[:, None], shape).copy(), np.broadcast_to(y[None, :], shape).copy()


def _shift(arr: np.ndarray, di: int, dj: int, fill=np.nan) -> np.ndarray:
    """Value of arr at index (i+di, j+dj), `fill` outside the map."""
    rows, cols = arr.shape
    out = np.full_like(arr, fill)
    src_i = slice(max(di, 0), rows + min(di, 0))
    src_j = slice(max(dj, 0), cols + min(dj, 0))
    dst_i = slice(max(-di, 0), rows + min(-di, 0))
    dst_j = slice(max(-dj, 0), cols + min(-dj, 0))
    out[dst_i, dst_j] = arr[src_i, src_j]
    return out


def surface_normals(
    elevation: np.ndarray,
    resolution: float,
    radius: float,
    position=(0.0, 0.0),
) -> Dict[str, np.ndarray]:
    """PCA surface normals (NormalVectorsFilter 'area' method).

    Per valid cell: gather 3D points (cell position, elevation) of valid cells
    within `radius`; covariance = E[ppT] - E[p]E[p]T; normal = eigenvector of
    the smallest eigenvalue, flipped towards +z. Degenerate neighborhoods
    (second eigenvalue <= 1e-8) take the +z axis directly.
    """
    elev = np.asarray(elevation, dtype=np.float64)
    rows, cols = elev.shape
    x, y = cell_positions((rows, cols), resolution, position)
    valid = np.isfinite(elev)
    offs = circle_offsets(radius, resolution)

    n = np.zeros((rows, cols))
    s = np.zeros((rows, cols, 3))
    ss = np.zeros((rows, cols, 3, 3))
    for di, dj in offs:
        v = _shift(valid.astype(np.float64), di, dj, 0.0)
        ze = np.nan_to_num(_shift(elev, di, dj), nan=0.0) * v
        xn = (x - di * resolution) * v
        yn = (y - dj * resolution) * v
        n += v
        p = np.stack([xn, yn, ze], axis=-1)
        s += p
        # sum of p p^T with the validity weight folded into p once:
        # (v*px)(v*py)/v double counts; instead accumulate outer of unweighted
        # p with mask.
        pu = np.stack(
            [x - di * resolution, y - dj * resolution, np.nan_to_num(_shift(elev, di, dj), nan=0.0)],
            axis=-1,
        )
        ss += v[..., None, None] * (pu[..., :, None] * pu[..., None, :])

    n_safe = np.maximum(n, 1.0)
    mean = s / n_safe[..., None]
    cov = ss / n_safe[..., None, None] - mean[..., :, None] * mean[..., None, :]

    w, vec = np.linalg.eigh(cov)  # ascending eigenvalues
    normal = vec[..., :, 0]
    degenerate = w[..., 1] <= 1e-8
    unit_z = np.array([0.0, 0.0, 1.0])
    normal = np.where(degenerate[..., None], unit_z, normal)
    flip = normal[..., 2] < 0.0
    normal = np.where(flip[..., None], -normal, normal)

    out = {}
    for k, name in enumerate(("surface_normal_x", "surface_normal_y", "surface_normal_z")):
        layer = np.where(valid, normal[..., k], np.nan)
        out[name] = layer.astype(np.float32)
    return out


def slope_filter(normal_z: np.ndarray, critical_value: float) -> np.ndarray:
    """SlopeFilter.cpp:59-89: slope = acos(nz); 1 - slope/critical, clamp 0."""
    nz = np.asarray(normal_z, dtype=np.float64)
    valid = np.isfinite(nz)
    slope = np.arccos(np.clip(nz, -1.0, 1.0))
    out = np.where(slope < critical_value, 1.0 - slope / critical_value, 0.0)
    return np.where(valid, out, np.nan).astype(np.float32)


def step_filter(
    elevation: np.ndarray,
    resolution: float,
    critical_value: float,
    first_window_radius: float,
    second_window_radius: float,
    critical_cell_number: int,
) -> np.ndarray:
    """StepFilter.cpp:102-182, two circular-window passes."""
    elev = np.asarray(elevation, dtype=np.float64)
    valid = np.isfinite(elev)

    # Pass 1: step_height = windowed (max - min) of valid elevation, only for
    # cells whose own elevation is valid (StepFilter.cpp:113-114).
    offs1 = circle_offsets(first_window_radius, resolution)
    hmax = np.full_like(elev, -np.inf)
    hmin = np.full_like(elev, np.inf)
    any1 = np.zeros(elev.shape, dtype=bool)
    for di, dj in offs1:
        zn = _shift(elev, di, dj)
        vn = np.isfinite(zn)
        hmax = np.where(vn & (zn > hmax), zn, hmax)
        hmin = np.where(vn & (zn < hmin), zn, hmin)
        any1 |= vn
    step_height = np.where(valid & any1, hmax - hmin, np.nan)
    # cast to layer precision: the C++ stores step_height in a float32 layer
    step_height = step_height.astype(np.float32).astype(np.float64)

    # Pass 2: over all cells (no center-validity gate, StepFilter.cpp:147).
    offs2 = circle_offsets(second_window_radius, resolution)
    smax = np.zeros_like(elev)
    ncrit = np.zeros_like(elev)
    any2 = np.zeros(elev.shape, dtype=bool)
    for di, dj in offs2:
        sn = _shift(step_height, di, dj)
        vn = np.isfinite(sn)
        any2 |= vn
        smax = np.where(vn & (sn > smax), sn, smax)
        ncrit += np.where(vn & (sn > critical_value), 1.0, 0.0)
    step = np.minimum(smax, ncrit / float(critical_cell_number) * smax)
    out = np.where(step < critical_value, 1.0 - step / critical_value, 0.0)
    return np.where(any2, out, np.nan).astype(np.float32)


def roughness_filter(
    elevation: np.ndarray,
    normals: Dict[str, np.ndarray],
    resolution: float,
    critical_value: float,
    estimation_radius: float,
    position=(0.0, 0.0),
) -> np.ndarray:
    """RoughnessFilter.cpp:73-132: std of plane residuals in a window."""
    elev = np.asarray(elevation, dtype=np.float64)
    rows, cols = elev.shape
    x, y = cell_positions((rows, cols), resolution, position)
    nx = np.asarray(normals["surface_normal_x"], dtype=np.float64)
    ny = np.asarray(normals["surface_normal_y"], dtype=np.float64)
    nz = np.asarray(normals["surface_normal_z"], dtype=np.float64)
    has_normal = np.isfinite(nx)

    offs = circle_offsets(estimation_radius, resolution)
    n = np.zeros_like(elev)
    s = np.zeros((rows, cols, 3))
    # accumulate sum of (p . n) and (p . n)^2 incrementally? p.n depends on the
    # center cell's normal -> accumulate moments of p instead.
    ss = np.zeros((rows, cols, 3, 3))
    for di, dj in offs:
        zn = _shift(elev, di, dj)
        vn = np.isfinite(zn)
        v = vn.astype(np.float64)
        pu = np.stack([x - di * resolution, y - dj * resolution, np.nan_to_num(zn, nan=0.0)], axis=-1)
        n += v
        s += v[..., None] * pu
        ss += v[..., None, None] * (pu[..., :, None] * pu[..., None, :])

    with np.errstate(invalid="ignore", divide="ignore"):
        mean = s / n[..., None]
        nvec = np.stack([nx, ny, nz], axis=-1)
        # sum over points of (p.n - mean.n)^2 = n^T (ss - n*mean mean^T) n
        smat = ss - n[..., None, None] * (mean[..., :, None] * mean[..., None, :])
        quad = np.einsum("...i,...ij,...j->...", nvec, smat, nvec)
        # guard tiny negative values from cancellation
        quad = np.maximum(quad, 0.0)
        roughness = np.sqrt(quad / (n - 1.0))
    out = np.where(roughness < critical_value, 1.0 - roughness / critical_value, 0.0)
    return np.where(has_normal, out, np.nan).astype(np.float32)


def run_chain(
    elevation: np.ndarray,
    resolution: float,
    config: dict,
    position=(0.0, 0.0),
) -> Dict[str, np.ndarray]:
    """Run the full default chain (robot_filter_parameter.yaml order):
    normals -> slope -> step -> roughness -> weighted fusion (-> deletion).

    `config` uses the reference parameter names, e.g. the dict returned by
    ``utils.config.load_filter_chain_params``.
    """
    normals_cfg = config["surfaceNormalsFilter"]
    slope_cfg = config["slopeFilter"]
    step_cfg = config["stepFilter"]
    rough_cfg = config["roughnessFilter"]

    normals = surface_normals(elevation, resolution, normals_cfg["radius"], position)
    out: Dict[str, np.ndarray] = dict(normals)
    out["traversability_slope"] = slope_filter(
        normals["surface_normal_z"], slope_cfg["critical_value"]
    )
    out["traversability_step"] = step_filter(
        elevation,
        resolution,
        step_cfg["critical_value"],
        step_cfg["first_window_radius"],
        step_cfg["second_window_radius"],
        step_cfg["critical_cell_number"],
    )
    out["traversability_roughness"] = roughness_filter(
        elevation,
        normals,
        resolution,
        rough_cfg["critical_value"],
        rough_cfg["estimation_radius"],
        position,
    )
    out["traversability"] = (
        (1.0 / 3.0)
        * (
            out["traversability_slope"].astype(np.float64)
            + out["traversability_step"]
            + out["traversability_roughness"]
        )
    ).astype(np.float32)
    for k in ("surface_normal_x", "surface_normal_y", "surface_normal_z"):
        out.pop(k)  # DeletionFilter
    return out


DEFAULT_CHAIN_CONFIG = {
    "surfaceNormalsFilter": {"radius": 0.05},
    "slopeFilter": {"critical_value": 1.0},
    "stepFilter": {
        "critical_value": 0.12,
        "first_window_radius": 0.04,
        "second_window_radius": 0.04,
        "critical_cell_number": 4,
    },
    "roughnessFilter": {"critical_value": 0.05, "estimation_radius": 0.05},
}
