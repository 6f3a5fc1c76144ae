"""The port's filter chain (traversability_estimation_tpu_torch.ops.filters)
against the JAX chain, on the CPU.

Bars: the step layer bit-exact; slope within 5e-5 (acos magnifies a 1-ulp
change of a near-vertical normal's z); roughness and the fused
traversability within 2e-4, with equal finite patterns. XLA:CPU contracts
``a*b + c`` into fused multiply-adds across the chain and the port does not
(so that its CUDA kernel can match it bit for bit); in near-planar windows
the roughness quadratic form is float32 rounding noise in both engines and
its square root, scaled by 1/critical = 20, moves by up to ~1e-4 (both
engines sit that far from the float64 NumPy oracle there too).
"""

import fractions
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traversability_estimation_tpu.ops import filters as jf
from traversability_estimation_tpu_torch.ops import filters as tf

RES = 0.03

CONFIGS = {
    "default": {},
    # separate roughness moments, a non-power-of-two cell count, other
    # critical values (each division by a constant is a reciprocal multiply)
    "variant": dict(
        roughness_estimation_radius=0.08,
        step_critical_cell_number=3,
        step_critical_value=0.1,
        slope_critical_value=0.7,
        roughness_critical_value=0.07,
    ),
}


@pytest.fixture(scope="module")
def elevation():
    from conftest import synthetic_terrain

    return synthetic_terrain(64, 80, RES, seed=3, nan_frac=0.08)


def _assert_layer(a, b, atol, name):
    a, b = np.asarray(a), np.asarray(b)
    assert (np.isfinite(a) == np.isfinite(b)).all(), name
    fin = np.isfinite(a)
    np.testing.assert_allclose(b[fin], a[fin], rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_run_chain_matches_jax(elevation, name):
    jcfg = jf.ChainConfig(resolution=RES, **CONFIGS[name])
    tcfg = tf.ChainConfig(resolution=RES, **CONFIGS[name])
    ref = jf.run_chain_jit(jnp.asarray(elevation), jcfg)
    out = tf.run_chain(torch.from_numpy(elevation.copy()), tcfg)
    assert set(out) == set(ref)
    for k in out:
        assert out[k].dtype == torch.float32, k
    np.testing.assert_array_equal(
        out["traversability_step"].numpy(), np.asarray(ref["traversability_step"])
    )
    _assert_layer(ref["traversability_slope"], out["traversability_slope"].numpy(), 5e-5, "slope")
    for k in ("traversability_roughness", "traversability"):
        _assert_layer(ref[k], out[k].numpy(), 2e-4, k)


def test_run_chain_without_roughness(elevation):
    jcfg = jf.ChainConfig(resolution=RES, compute_roughness=False)
    tcfg = tf.ChainConfig(resolution=RES, compute_roughness=False)
    ref = jf.run_chain_jit(jnp.asarray(elevation), jcfg)
    out = tf.run_chain(torch.from_numpy(elevation.copy()), tcfg)
    assert set(out) == set(ref) and "traversability_roughness" not in out
    _assert_layer(ref["traversability"], out["traversability"].numpy(), 1e-5, "traversability")


def test_surface_normals_match_jax(elevation):
    """nz (what the slope reads) within 1e-5. The tangential components of a
    near-vertical normal come from the smallest eigenvector of a window
    whose two smallest eigenvalues nearly tie, where an ulp of rounding
    turns the vector: within 1e-3 on this map (up to ~3e-3 on larger ones)."""
    import jax

    ref = jax.jit(lambda e: jf.surface_normals(e, RES, 0.05))(jnp.asarray(elevation))
    out = tf.surface_normals(torch.from_numpy(elevation.copy()), RES, 0.05)
    _assert_layer(ref["surface_normal_z"], out["surface_normal_z"].numpy(), 1e-5, "nz")
    for k in ("surface_normal_x", "surface_normal_y"):
        _assert_layer(ref[k], out[k].numpy(), 1e-3, k)


def test_acos_polynomial_matches_jax():
    x = np.concatenate(
        [np.linspace(-1.0, 1.0, 4001, dtype=np.float32), np.float32([np.nan, -0.0, 0.0])]
    )
    ref = np.asarray(jf._acos(jnp.asarray(x)))
    out = tf._acos(torch.from_numpy(x)).numpy()
    _assert_layer(ref, out, 1e-6, "acos")
    # the polynomial, not torch.acos: within 2e-7 rad of the true arccos
    fin = np.isfinite(x)
    np.testing.assert_allclose(out[fin], np.arccos(x[fin].astype(np.float64)), atol=2e-7)


def _exact_fma_f32(a, b, c):
    """Round-to-nearest-even float32 of the exact a*b + c (rational)."""
    v = fractions.Fraction(float(a)) * fractions.Fraction(float(b)) + fractions.Fraction(float(c))
    f = np.float32(float(v))  # nearest double, then float32: may double-round
    lo = f if fractions.Fraction(float(f)) <= v else np.nextafter(f, np.float32(-np.inf))
    hi = np.nextafter(lo, np.float32(np.inf))
    dlo = v - fractions.Fraction(float(lo))
    dhi = fractions.Fraction(float(hi)) - v
    if dlo < dhi:
        return lo
    if dhi < dlo:
        return hi
    return lo if (lo.view(np.int32) & 1) == 0 else hi


def test_fma_f32_rounds_once():
    rng = np.random.default_rng(0)
    a = rng.uniform(-2, 2, 300).astype(np.float32)
    b = rng.uniform(-2, 2, 300).astype(np.float32)
    c = rng.uniform(-2, 2, 300).astype(np.float32)
    # double-rounding traps: a*b = 1 + 2^-11 + 2^-24 is a float32 midpoint,
    # and c = +-2^-60 lies below float64 resolution there, so the float64
    # sum lands on the midpoint while the exact value does not
    a[:3] = np.float32([1.0 + 2.0**-12, 1.0 + 2.0**-12, 3.0])
    b[:3] = np.float32([1.0 + 2.0**-12, 1.0 + 2.0**-12, 1.0 / 3.0])
    c[:3] = np.float32([2.0**-60, -(2.0**-60), -1.0])
    out = tf.fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    want = np.array([_exact_fma_f32(x, y, z) for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(out, want)
    # the forms the chain uses: 1 - x / c as fma(-x, 1/c, 1)
    x = rng.uniform(0, 0.12, 1000).astype(np.float32)
    got = tf.one_minus_scaled(torch.from_numpy(x), 0.12).numpy()
    r = np.float32(1.0) / np.float32(0.12)
    np.testing.assert_array_equal(got, [_exact_fma_f32(-v, r, 1.0) for v in x])


def test_sqrt_f32_is_correctly_rounded():
    x = np.random.default_rng(1).uniform(0, 10, 20000).astype(np.float32)
    got = tf.sqrt_f32(torch.from_numpy(x)).numpy()
    want = np.array([np.float32(math.sqrt(v)) for v in x.astype(np.float64)], np.float32)
    np.testing.assert_array_equal(got, want)


EXPRESSIONS = {
    # the reference's MathExpressionFilter
    "reference": ("(1.0 / 3.0) * (traversability_slope + traversability_step + "
                  "traversability_roughness)", True),
    "two_layers": ("0.5*(traversability_slope + traversability_step)", False),
    "min_max_sqrt_pow": ("max(min(traversability_slope, traversability_step), "
                         "-sqrt(traversability_roughness) + traversability_step ^ 2)", True),
    "exp_sin": ("exp(-traversability_roughness) * sin(traversability_slope) + "
                "traversability_step ^ 1.5", True),
}


@pytest.mark.parametrize("name", sorted(EXPRESSIONS))
def test_run_chain_with_fusion_expression_matches_jax(elevation, name):
    """The chain with a fusion expression against the jitted JAX chain: the
    layers at the chain's bars, the fused layer within 2e-4 (it inherits the
    roughness layer's), and exactly the expression of the port's own
    layers."""
    expression, rough = EXPRESSIONS[name]
    kw = dict(resolution=RES, fusion_expression=expression, compute_roughness=rough)
    ref = jf.run_chain_jit(jnp.asarray(elevation), jf.ChainConfig(**kw))
    out = tf.run_chain(torch.from_numpy(elevation.copy()), tf.ChainConfig(**kw))
    assert set(out) == set(ref) and out["traversability"].dtype == torch.float32
    np.testing.assert_array_equal(
        out["traversability_step"].numpy(), np.asarray(ref["traversability_step"])
    )
    _assert_layer(ref["traversability"], out["traversability"].numpy(), 2e-4, "traversability")
    from traversability_estimation_tpu_torch.ops import expr

    layers = {k: v for k, v in out.items() if k != "traversability"}
    again = expr.evaluate(expr.parse(expression), layers)
    np.testing.assert_array_equal(out["traversability"].numpy(), again.numpy())


def test_reference_expression_equals_the_weighted_sum_within_an_ulp(elevation):
    """(1/3) * (a + b + c) against a/3 + b/3 + c/3: the same layer up to the
    order of the roundings."""
    expression, _ = EXPRESSIONS["reference"]
    elev = torch.from_numpy(elevation.copy())
    fused = tf.run_chain(elev, tf.ChainConfig(resolution=RES, fusion_expression=expression))
    summed = tf.run_chain(elev, tf.ChainConfig(resolution=RES))
    _assert_layer(summed["traversability"].numpy(), fused["traversability"].numpy(), 2e-7, "fused")


def test_smallest_eigpair_sym3_matches_jax():
    """The matrix-form eigensolver: the JAX function's accuracy gate
    (tests/test_ops_chain.py) and its values within float32 rounding."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((512, 3, 3)).astype(np.float32)
    A = A + np.swapaxes(A, -1, -2)
    emin, emid, v = (t.numpy() for t in tf.smallest_eigpair_sym3(torch.from_numpy(A)))
    w, V = np.linalg.eigh(A)
    assert np.abs(emin - w[:, 0]).max() < 1e-5 * np.abs(w).max()
    assert np.abs(np.sum(v * V[:, :, 0], axis=-1)).min() > 1.0 - 1e-5
    emin_j, emid_j, v_j = (np.asarray(a) for a in jax.jit(jf.smallest_eigpair_sym3)(jnp.asarray(A)))
    scale = np.abs(w).max()
    np.testing.assert_allclose(emin, emin_j, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(emid, emid_j, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(v, v_j, rtol=0, atol=1e-5)
    assert v.shape == (512, 3)
