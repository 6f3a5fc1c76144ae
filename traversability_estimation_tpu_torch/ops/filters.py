"""The filter chain as whole-plane torch ops: the plain version of kernel 1's
chain half, and the CPU path.

Every window operation is a static-offset shifted reduction over whole
(rows, cols) planes; the 3x3 eigenproblem is a fixed-schedule Jacobi over
six coefficient planes. Moments are accumulated in float32 over LOCAL
coordinates (offsets from the center cell), which keeps them well
conditioned at any absolute altitude.

Numerics: the CUDA kernel (``csrc/fused_update.cu``) repeats these exact
float32 operations in this exact order, compiled without FMA contraction,
so the two agree bit for bit. Two rules fix the few operations where the
JAX reference's compiled form differs from its source:
- a division by a constant is a multiplication by the constant's float32
  reciprocal (:func:`mul_rcp`), as XLA compiles it;
- ``1 - x / c`` is one fused multiply-add, ``fma(-x, 1/c, 1)``
  (:func:`one_minus_scaled`), as XLA:CPU contracts it. The torch version
  computes the exactly rounded FMA in float64 (:func:`fma_f32`); the kernel
  calls ``__fmaf_rn``.
With them the step layer is bit-exact against the JAX chain. Elsewhere XLA
contracts too, which moves the other float layers by a few ulp (and
roughness in near-planar windows by up to ~2e-4, where the quadratic form is
rounding noise in float32 in both engines).
``python_float / tensor`` is ``reciprocal() * float`` in PyTorch; only
``1.0 / t`` is written.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from traversability_estimation_tpu_torch.grid.geometry import circle_offsets

# +/-3e38 sentinels of the step filter, as float32 values
NEG = float(np.float32(-3.0e38))
POS = float(np.float32(3.0e38))

# 7-term minimax polynomial for acos (Abramowitz & Stegun 4.4.46 form)
ACOS_COEFFS = (
    -0.0012624911,
    0.0066700901,
    -0.0170881256,
    0.0308918810,
    -0.0501743046,
    0.0889789874,
    -0.2145988016,
    1.5707963050,
)


def f32(x: float) -> float:
    """The float32 value nearest to `x`, as a Python float."""
    return float(np.float32(x))


def rcp(c: float) -> float:
    """The float32 reciprocal of float32(c), computed in float32."""
    return float(np.float32(1.0) / np.float32(c))


def mul_rcp(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` for a constant `c`, as XLA compiles it: ``t * rcp(c)``."""
    return t * rcp(c)


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (a fused multiply-add).

    The product of two float32 values is exact in float64; the float64 sum
    is corrected for double rounding: where it lands exactly halfway between
    two float32 values, the sign of its rounding error picks the side."""
    a64 = a.to(torch.float64)
    p = a64 * torch.as_tensor(b, dtype=torch.float64, device=a.device)
    c64 = torch.as_tensor(c, dtype=torch.float64, device=a.device).expand_as(p)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)  # exact: s + err == p + c
    f = s.to(torch.float32)
    f64 = f.to(torch.float64)
    toward = torch.where(s > f64, math.inf, -math.inf).to(torch.float32)
    other = torch.nextafter(f, toward)
    tie = (f64 != s) & ((f64 + other.to(torch.float64)) * 0.5 == s) & (err != 0)
    # on a tie the exact value lies past s on err's side
    pick_other = tie & ((other.to(torch.float64) > f64) == (err > 0))
    return torch.where(pick_other, other, f)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device (PyTorch's CPU
    float32 sqrt is not, on some hosts): the float64 root of a float32
    value rounds to the correctly rounded float32 root."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def one_minus_scaled(x: torch.Tensor, c: float) -> torch.Tensor:
    """``1 - x / c`` as ``fma(-x, rcp(c), 1)``."""
    return fma_f32(-x, rcp(c), 1.0)


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    """Static filter-chain parameters; names follow the reference YAML
    (config/robot_filter_parameter.yaml)."""

    resolution: float
    normals_radius: float = 0.05
    slope_critical_value: float = 1.0
    step_critical_value: float = 0.12
    step_first_window_radius: float = 0.04
    step_second_window_radius: float = 0.04
    step_critical_cell_number: int = 4
    roughness_critical_value: float = 0.05
    roughness_estimation_radius: float = 0.05
    # weighted fusion: traversability = sum(w * layer); default = the
    # reference's MathExpressionFilter "(1/3)*(slope+step+roughness)"
    fusion_weights: Tuple[Tuple[str, float], ...] = (
        ("traversability_slope", 1.0 / 3.0),
        ("traversability_step", 1.0 / 3.0),
        ("traversability_roughness", 1.0 / 3.0),
    )
    # MathExpressionFilter: an arithmetic expression over the chain's layer
    # names (ops/expr.py); when set it takes the weighted sum's place
    fusion_expression: str = ""
    compute_roughness: bool = True


def _shifted(arr: torch.Tensor, di: int, dj: int, fill) -> torch.Tensor:
    """Value of arr at index (i+di, j+dj), `fill` outside (static offsets)."""
    rows, cols = arr.shape
    out = torch.full_like(arr, fill)
    if abs(di) >= rows or abs(dj) >= cols:
        return out
    i0, i1 = max(-di, 0), rows - max(di, 0)
    j0, j1 = max(-dj, 0), cols - max(dj, 0)
    out[i0:i1, j0:j1] = arr[i0 + di : i1 + di, j0 + dj : j1 + dj]
    return out


def smallest_eigvec_planes(c00, c01, c02, c11, c12, c22, sweeps: int = 4):
    """Smallest eigenpair of symmetric 3x3 matrices given as six coefficient
    planes. Returns (vx, vy, vz, eig_min, eig_mid).

    Cyclic Jacobi, fixed schedule, branchless; 4 sweeps (3 leave near-tie
    eigenvectors measurably more sensitive to rounding, 2 fail the golden
    map).
    """
    a = {
        (0, 0): c00, (0, 1): c01, (0, 2): c02,
        (1, 1): c11, (1, 2): c12, (2, 2): c22,
    }
    one = torch.ones_like(c00)
    zero = torch.zeros_like(c00)
    v = {(i, j): (one if i == j else zero) for i in range(3) for j in range(3)}

    def A(i, j):
        return a[(i, j) if i <= j else (j, i)]

    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            k = 3 - p - q
            app, aqq, apq = A(p, p), A(q, q), A(p, q)
            apk, aqk = A(p, k), A(q, k)
            # tan(2 theta) = 2 apq / (aqq - app); stable branchless rotation
            tau = (aqq - app) / torch.where(apq == 0.0, 1.0, 2.0 * apq)
            t = torch.sign(tau) / (tau.abs() + sqrt_f32(1.0 + tau * tau))
            t = torch.where(tau == 0.0, 1.0, t)
            t = torch.where(apq == 0.0, 0.0, t)
            c = 1.0 / sqrt_f32(1.0 + t * t)
            s = t * c
            a[(p, p)] = c * c * app - 2.0 * s * c * apq + s * s * aqq
            a[(q, q)] = s * s * app + 2.0 * s * c * apq + c * c * aqq
            a[(p, q)] = zero
            new_pk = c * apk - s * aqk
            new_qk = s * apk + c * aqk
            a[(p, k) if p <= k else (k, p)] = new_pk
            a[(q, k) if q <= k else (k, q)] = new_qk
            for i in range(3):
                vip, viq = v[(i, p)], v[(i, q)]
                v[(i, p)] = c * vip - s * viq
                v[(i, q)] = s * vip + c * viq

    d0, d1, d2 = a[(0, 0)], a[(1, 1)], a[(2, 2)]
    is0 = (d0 <= d1) & (d0 <= d2)
    is1 = (~is0) & (d1 <= d2)
    eig_min = torch.where(is0, d0, torch.where(is1, d1, d2))
    eig_max = torch.maximum(d0, torch.maximum(d1, d2))
    eig_mid = d0 + d1 + d2 - eig_min - eig_max

    def pick(i):
        return torch.where(is0, v[(i, 0)], torch.where(is1, v[(i, 1)], v[(i, 2)]))

    return pick(0), pick(1), pick(2), eig_min, eig_mid


def smallest_eigpair_sym3(A: torch.Tensor, sweeps: int = 4):
    """Matrix-form wrapper over ``smallest_eigvec_planes`` for (..., 3, 3)
    symmetric inputs (the upper triangle is read); returns (eig_min,
    eig_mid, v_min (..., 3))."""
    vx, vy, vz, eig_min, eig_mid = smallest_eigvec_planes(
        A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
        A[..., 1, 1], A[..., 1, 2], A[..., 2, 2],
        sweeps=sweeps,
    )
    return eig_min, eig_mid, torch.stack([vx, vy, vz], dim=-1)


def moment_planes(
    elevation: torch.Tensor, resolution: float, radius: float
) -> Tuple[torch.Tensor, ...]:
    """Windowed point moments in local coordinates, shared by the normals and
    roughness stages when their radii match.

    Returns (n, sx, sy, sz, sxx, sxy, sxz, syy, syz, szz)."""
    elev = elevation.to(torch.float32)
    valid = torch.isfinite(elev)
    zf = torch.where(valid, elev, 0.0)
    vf = valid.to(torch.float32)

    n, sx, sy, sz, sxx, sxy, sxz, syy, syz, szz = (
        torch.zeros_like(zf) for _ in range(10)
    )
    for di, dj in circle_offsets(radius, resolution).tolist():
        # neighbor local coordinates: grid_map x decreases with row index
        dx = f32(-di * resolution)
        dy = f32(-dj * resolution)
        v = _shifted(vf, di, dj, 0.0)
        z = _shifted(zf, di, dj, 0.0) - zf * v
        n = n + v
        sx = sx + v * dx
        sy = sy + v * dy
        sz = sz + z
        sxx = sxx + v * dx * dx
        sxy = sxy + v * dx * dy
        sxz = sxz + z * dx
        syy = syy + v * dy * dy
        syz = syz + z * dy
        szz = szz + z * z
    return n, sx, sy, sz, sxx, sxy, sxz, syy, syz, szz


def surface_normals(
    elevation: torch.Tensor,
    resolution: float,
    radius: float,
    moments: Optional[Tuple[torch.Tensor, ...]] = None,
) -> Dict[str, torch.Tensor]:
    """PCA surface normals over a circular window (NormalVectorsFilter 'area').

    NaN where the center cell's elevation is invalid; degenerate windows
    (second eigenvalue <= 1e-8) take the +z axis."""
    elev = elevation.to(torch.float32)
    valid = torch.isfinite(elev)
    if moments is None:
        moments = moment_planes(elevation, resolution, radius)
    n, sx, sy, sz, sxx, sxy, sxz, syy, syz, szz = moments

    ns = torch.clamp_min(n, 1.0)
    mx, my, mz = sx / ns, sy / ns, sz / ns
    vx, vy, vz, _, eig_mid = smallest_eigvec_planes(
        sxx / ns - mx * mx,
        sxy / ns - mx * my,
        sxz / ns - mx * mz,
        syy / ns - my * my,
        syz / ns - my * mz,
        szz / ns - mz * mz,
    )
    degenerate = eig_mid <= 1e-8
    vx = torch.where(degenerate, 0.0, vx)
    vy = torch.where(degenerate, 0.0, vy)
    vz = torch.where(degenerate, 1.0, vz)
    flip = vz < 0.0
    vx = torch.where(flip, -vx, vx)
    vy = torch.where(flip, -vy, vy)
    vz = torch.where(flip, -vz, vz)
    nan = float("nan")
    return {
        "surface_normal_x": torch.where(valid, vx, nan),
        "surface_normal_y": torch.where(valid, vy, nan),
        "surface_normal_z": torch.where(valid, vz, nan),
    }


def _acos(x: torch.Tensor) -> torch.Tensor:
    """acos by the minimax polynomial (|error| <= 2e-8 rad), not torch.acos:
    the kernel computes the same polynomial. acos(-x) = pi - acos(x); NaN
    propagates."""
    y = x.abs()
    p = torch.full_like(y, f32(ACOS_COEFFS[0]))
    for c in ACOS_COEFFS[1:]:
        p = p * y + f32(c)
    r = sqrt_f32(torch.clamp_min(1.0 - y, 0.0)) * p
    return torch.where(x < 0.0, f32(np.pi) - r, r)


def slope_from_normals(normal_z: torch.Tensor, critical_value: float) -> torch.Tensor:
    """SlopeFilter formula: 1 - acos(nz)/critical, clamped to 0; NaN kept."""
    slope = _acos(torch.clamp(normal_z, -1.0, 1.0))
    out = torch.where(slope < critical_value, one_minus_scaled(slope, critical_value), 0.0)
    return torch.where(torch.isfinite(normal_z), out, float("nan"))


def step_layer(
    elevation: torch.Tensor,
    resolution: float,
    critical_value: float,
    first_window_radius: float,
    second_window_radius: float,
    critical_cell_number: int,
) -> torch.Tensor:
    """StepFilter: windowed (max - min), then windowed max/count mixing.

    Validity is derived from the +/-3e38 sentinels: a window with no valid
    cell leaves the running max at the sentinel."""
    elev = elevation.to(torch.float32)
    valid = torch.isfinite(elev)
    zmax_in = torch.where(valid, elev, NEG)
    zmin_in = torch.where(valid, elev, POS)

    hmax = torch.full_like(elev, NEG)
    hmin = torch.full_like(elev, POS)
    for di, dj in circle_offsets(first_window_radius, resolution).tolist():
        hmax = torch.maximum(hmax, _shifted(zmax_in, di, dj, NEG))
        hmin = torch.minimum(hmin, _shifted(zmin_in, di, dj, POS))
    any1 = hmax > 0.5 * NEG
    step_height = torch.where(valid & any1, hmax - hmin, float("nan"))

    sh_max_in = torch.where(torch.isfinite(step_height), step_height, NEG)
    smax_raw = torch.full_like(elev, NEG)
    ncrit = torch.zeros_like(elev)
    for di, dj in circle_offsets(second_window_radius, resolution).tolist():
        shn = _shifted(sh_max_in, di, dj, NEG)
        smax_raw = torch.maximum(smax_raw, shn)
        ncrit = ncrit + torch.where(shn > critical_value, 1.0, 0.0)
    any2 = smax_raw > 0.5 * NEG
    # valid step heights are >= 0: clamping the sentinel to 0 makes invalid
    # neighbors contribute 0 to the max
    smax = torch.clamp_min(smax_raw, 0.0)
    step = torch.minimum(smax, mul_rcp(ncrit, float(critical_cell_number)) * smax)
    out = torch.where(step < critical_value, one_minus_scaled(step, critical_value), 0.0)
    return torch.where(any2, out, float("nan"))


def roughness_layer(
    elevation: torch.Tensor,
    normals: Dict[str, torch.Tensor],
    resolution: float,
    critical_value: float,
    estimation_radius: float,
    moments: Optional[Tuple[torch.Tensor, ...]] = None,
) -> torch.Tensor:
    """RoughnessFilter: std of distances to the center cell's tangent plane."""
    if moments is None:
        moments = moment_planes(elevation, resolution, estimation_radius)
    n, sx, sy, sz, sxx, sxy, sxz, syy, syz, szz = moments

    nx = normals["surface_normal_x"]
    ny = normals["surface_normal_y"]
    nz = normals["surface_normal_z"]
    has_normal = torch.isfinite(nx)
    nx0 = torch.where(has_normal, nx, 0.0)
    ny0 = torch.where(has_normal, ny, 0.0)
    nz0 = torch.where(has_normal, nz, 0.0)

    ns = torch.clamp_min(n, 1.0)
    mx, my, mz = sx / ns, sy / ns, sz / ns
    # scatter matrix S = sum (q - mean)(q - mean)^T ; quad = n^T S n
    cxx = sxx - n * mx * mx
    cxy = sxy - n * mx * my
    cxz = sxz - n * mx * mz
    cyy = syy - n * my * my
    cyz = syz - n * my * mz
    czz = szz - n * mz * mz
    quad = (
        nx0 * (cxx * nx0 + cxy * ny0 + cxz * nz0)
        + ny0 * (cxy * nx0 + cyy * ny0 + cyz * nz0)
        + nz0 * (cxz * nx0 + cyz * ny0 + czz * nz0)
    )
    quad = torch.maximum(quad, torch.zeros_like(quad))
    denom = n - 1.0
    roughness = sqrt_f32(quad / torch.where(denom > 0.0, denom, float("nan")))
    out = torch.where(
        roughness < critical_value, one_minus_scaled(roughness, critical_value), 0.0
    )
    return torch.where(has_normal, out, float("nan"))


def shares_moments(config: ChainConfig) -> bool:
    """Whether the normals and roughness stages use one set of moments."""
    return (
        config.compute_roughness
        and config.roughness_estimation_radius == config.normals_radius
    )


def fusion_terms(config: ChainConfig) -> Tuple[Tuple[str, float], ...]:
    """The (layer, float32 weight) terms of the weighted fusion, in order,
    restricted to layers the chain produces."""
    produced = {"traversability_slope", "traversability_step"}
    if config.compute_roughness:
        produced.add("traversability_roughness")
    return tuple((k, f32(w)) for k, w in config.fusion_weights if k in produced)


def run_chain(elevation: torch.Tensor, config: ChainConfig) -> Dict[str, torch.Tensor]:
    """Elevation -> slope, step, roughness and fused traversability layers."""
    shared = (
        moment_planes(elevation, config.resolution, config.normals_radius)
        if shares_moments(config)
        else None
    )
    normals = surface_normals(
        elevation, config.resolution, config.normals_radius, moments=shared
    )
    out: Dict[str, torch.Tensor] = {}
    out["traversability_slope"] = slope_from_normals(
        normals["surface_normal_z"], config.slope_critical_value
    )
    out["traversability_step"] = step_layer(
        elevation,
        config.resolution,
        config.step_critical_value,
        config.step_first_window_radius,
        config.step_second_window_radius,
        config.step_critical_cell_number,
    )
    if config.compute_roughness:
        out["traversability_roughness"] = roughness_layer(
            elevation,
            normals,
            config.resolution,
            config.roughness_critical_value,
            config.roughness_estimation_radius,
            moments=shared,
        )
    if config.fusion_expression:
        from traversability_estimation_tpu_torch.ops import expr

        fused = expr.evaluate(expr.parse(config.fusion_expression), out)
        # an expression of constants alone still fills a plane
        fused = fused.to(torch.float32).expand_as(out["traversability_slope"]).contiguous()
    else:
        fused = torch.zeros_like(out["traversability_slope"])
        for layer, w in fusion_terms(config):
            fused = fused + w * out[layer]
    out["traversability"] = fused
    return out
