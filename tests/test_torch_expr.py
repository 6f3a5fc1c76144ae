"""The port's expression module (traversability_estimation_tpu_torch.ops.expr)
against the JAX package's, on the CPU.

Bars: parse trees and parser errors equal; ``evaluate`` against the JITTED JAX
``compile_expression`` exact (NaN in the same cells) for expressions of
+ - * /, negation, min, max, abs, floor, ceil, sign, sqrt and ``^ 2`` that
hold no ``a * b + c`` (XLA:CPU contracts that into one fused multiply-add;
such expressions, divisions by a constant, which XLA turns into reciprocal
multiplies, and the transcendental functions are held to 1e-6);
``to_program`` run by a small stack machine equals ``evaluate`` bit for bit:
it is the referee of the CUDA interpreter's opcode table.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traversability_estimation_tpu.ops import expr as jexpr
from traversability_estimation_tpu_torch.ops import expr as texpr
from traversability_estimation_tpu_torch.ops.filters import _acos, sqrt_f32

NAMES = ("traversability_slope", "traversability_step", "traversability_roughness")
A, B, C = NAMES

# expression -> absolute tolerance against jitted JAX (0: bit-identical)
EXPRESSIONS = {
    f"(1.0 / 3.0) * ({A} + {B} + {C})": 0.0,
    f"0.5*({A} + {B})": 0.0,
    f"max(min({A}, {B}), -sqrt({C}))": 0.0,
    f"max({B} ^ 2, pow({A}, 2))": 0.0,
    f"{B} ^ 2 - {A}": 1e-6,
    f"min({A}, {B}, {C}, 0.25) / max({A}, 0.1)": 0.0,
    f"abs({A} - {B}) * sign({C} - 0.5)": 0.0,
    f"floor(4 * {A}) - ceil({B} * 3.0)": 0.0,
    f"cwiseMax({A}, cwiseMin({B}, {C}))": 0.0,
    f"--{A} + +{B} - -{C}": 0.0,
    f"{A} * {B} + {C} / 3.0": 1e-6,
    f"exp(-{C}) * sin({A}) + cos({B}) - tan(0.5 * {A})": 1e-6,
    f"log({A} + 1e-3) + atan({B}) + pow({C}, 1.5) + {A} ^ 3": 1e-6,
    f"acos({A}) + asin({B}) - 2.5E-1": 1e-6,
}


@pytest.fixture(scope="module")
def layers():
    rng = np.random.default_rng(5)
    out = {}
    for k in NAMES:
        plane = rng.uniform(0.0, 1.0, (40, 52)).astype(np.float32)
        plane[rng.random(plane.shape) < 0.1] = np.nan
        plane[rng.random(plane.shape) < 0.05] = 0.0
        out[k] = plane
    return out


def _machine(ops, args, planes):
    """The kernel's interpreter, one torch op per program entry."""
    unary = {
        texpr._OP_UNARY["sqrt"]: sqrt_f32, texpr._OP_UNARY["abs"]: torch.abs,
        texpr._OP_UNARY["exp"]: torch.exp, texpr._OP_UNARY["log"]: torch.log,
        texpr._OP_UNARY["sin"]: torch.sin, texpr._OP_UNARY["cos"]: torch.cos,
        texpr._OP_UNARY["tan"]: torch.tan, texpr._OP_UNARY["acos"]: _acos,
        texpr._OP_UNARY["asin"]: lambda x: texpr._HALF_PI - _acos(x),
        texpr._OP_UNARY["atan"]: torch.atan, texpr._OP_UNARY["floor"]: torch.floor,
        texpr._OP_UNARY["ceil"]: torch.ceil, texpr._OP_UNARY["sign"]: texpr._sign,
        texpr.OP_NEG: torch.neg, texpr.OP_SQUARE: lambda x: x * x,
    }
    binary = {
        texpr.OP_ADD: torch.add, texpr.OP_SUB: torch.sub, texpr.OP_MUL: torch.mul,
        texpr.OP_DIV: torch.div, texpr.OP_POW: torch.pow, texpr.OP_MIN: torch.minimum,
        texpr.OP_MAX: torch.maximum,
    }
    stack = []
    for op, arg in zip(ops, args):
        if op == texpr.OP_CONST:
            stack.append(torch.tensor(arg, dtype=torch.float32))
        elif op == texpr.OP_LAYER:
            stack.append(planes[int(arg)])
        elif op in binary:
            b = stack.pop()
            a = stack.pop()
            stack.append(binary[op](a, b))
        else:
            stack.append(unary[op](stack.pop()))
        assert len(stack) <= texpr.MAX_STACK
    (out,) = stack
    return out


def _same(a, b):
    return np.array_equal(a, b, equal_nan=True)


@pytest.mark.parametrize("src", sorted(EXPRESSIONS))
def test_parse_trees_equal(src):
    assert texpr.parse(src) == jexpr.parse(src)
    assert texpr.variables(texpr.parse(src)) == jexpr.variables(jexpr.parse(src))


@pytest.mark.parametrize("src", sorted(EXPRESSIONS))
def test_evaluate_matches_jitted_jax(layers, src):
    atol = EXPRESSIONS[src]
    ref = np.asarray(jax.jit(jexpr.compile_expression(src))(
        {k: jnp.asarray(v) for k, v in layers.items()}))
    out = texpr.compile_expression(src)({k: torch.from_numpy(v) for k, v in layers.items()})
    assert out.dtype == torch.float32 and out.shape == ref.shape
    out = out.numpy()
    if atol == 0.0:
        assert _same(out, ref)
    else:
        assert (np.isnan(out) == np.isnan(ref)).all()
        fin = np.isfinite(ref)
        assert (np.isfinite(out) == fin).all()
        np.testing.assert_allclose(out[fin], ref[fin], rtol=1e-6, atol=atol)


@pytest.mark.parametrize("src", sorted(EXPRESSIONS))
def test_program_equals_evaluate_bit_for_bit(layers, src):
    planes = [torch.from_numpy(layers[k]) for k in NAMES]
    ast = texpr.parse(src)
    ops, args = texpr.to_program(ast, NAMES)
    assert len(ops) == len(args) <= texpr.MAX_PROG
    assert all(0 <= op < texpr.N_OPCODES for op in ops)
    assert texpr.stack_depth(ops) <= texpr.MAX_STACK
    want = texpr.evaluate(ast, dict(zip(NAMES, planes)))
    assert _same(_machine(ops, args, planes).numpy(), want.numpy())


def test_reference_program_is_nine_entries():
    src = f"(1.0 / 3.0) * ({A} + {B} + {C})"
    ops, args = texpr.to_program(texpr.parse(src), NAMES)
    assert ops == (texpr.OP_CONST, texpr.OP_CONST, texpr.OP_DIV, texpr.OP_LAYER, texpr.OP_LAYER,
                   texpr.OP_ADD, texpr.OP_LAYER, texpr.OP_ADD, texpr.OP_MUL)
    assert args == (1.0, 3.0, 0.0, 0.0, 1.0, 0.0, 2.0, 0.0, 0.0)
    assert texpr.stack_depth(ops) == 3
    # n-ary min: n - 1 binary entries; x ^ 2: one square entry
    ops, _ = texpr.to_program(texpr.parse(f"min({A}, {B}, {C}) ^ 2"), NAMES)
    assert ops.count(texpr.OP_MIN) == 2 and ops[-1] == texpr.OP_SQUARE


def test_constants_are_float32():
    third = texpr.evaluate(texpr.parse("1.0 / 3.0"), {"x": torch.zeros(1)})
    assert third.dtype == torch.float32
    assert float(third) == float(np.float32(1.0) / np.float32(3.0)) != 1.0 / 3.0
    _, args = texpr.to_program(texpr.parse("0.1 + x"), ("x",))
    assert args[0] == float(np.float32(0.1))
    assert texpr._HALF_PI == float(np.float32(math.pi / 2))


@pytest.mark.parametrize("src", [
    "1 +", "(1 + 2", "1 + 2)", "foo(1)", "a $ b", "min()", "1 2", "a + * b", "__import__('os')",
    "a.b", "a[0]", "lambda: 1", "",
])
def test_parser_errors_equal(src):
    with pytest.raises(jexpr.ExpressionError) as jerr:
        jexpr.parse(src)
    with pytest.raises(texpr.ExpressionError) as terr:
        texpr.parse(src)
    assert str(terr.value) == str(jerr.value)


def test_unknown_layer_raises_in_both_forms(layers):
    ast = texpr.parse(f"{A} + nope")
    planes = {k: torch.from_numpy(v) for k, v in layers.items()}
    with pytest.raises(texpr.ExpressionError, match="unknown layer 'nope'"):
        texpr.evaluate(ast, planes)
    with pytest.raises(texpr.ExpressionError, match="unknown layer 'nope'"):
        texpr.to_program(ast, NAMES)
    with pytest.raises(jexpr.ExpressionError, match="unknown layer 'nope'"):
        jexpr.evaluate(jexpr.parse(f"{A} + nope"), {k: jnp.asarray(v) for k, v in layers.items()})
    with pytest.raises(texpr.ExpressionError, match="takes 1 argument"):
        texpr.evaluate(texpr.parse(f"sqrt({A}, {B})"), planes)
