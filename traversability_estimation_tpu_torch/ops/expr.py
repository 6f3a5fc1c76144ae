"""Arithmetic expressions over layer names (MathExpressionFilter).

The reference chain fuses its layers with a gridMapFilters/MathExpressionFilter,
an EigenLab expression over layer-name variables. This module parses such an
expression (a small recursive-descent parser: no ``eval``, no Python builtin
reachable) and gives it two forms that compute the same float32 values:

- :func:`evaluate`, whole-plane torch ops: the plain version, and the CPU
  path;
- :func:`to_program`, a postfix program of small integer opcodes that the
  CUDA map-update kernel (``csrc/fused_update.cu``) interprets per cell on a
  stack of at most ``MAX_STACK`` floats.

Grammar (EigenLab-compatible subset, coefficient-wise semantics):

    expr    := term (('+'|'-') term)*
    term    := unary (('*'|'/') unary)*
    unary   := ('+'|'-')* power
    power   := atom ('^' unary)?          # right-associative
    atom    := NUMBER | NAME | NAME '(' expr (',' expr)* ')' | '(' expr ')'

Functions: sqrt, abs, exp, log, sin, cos, tan, asin, acos, atan, min, max,
pow, floor, ceil, sign, cwiseMin, cwiseMax (EigenLab names).

Float semantics, the same in both forms: every constant is a float32 value
and a constant sub-expression such as ``(1.0 / 3.0)`` is evaluated in float32
(which is what a compiler's constant folding of the float32 graph gives);
each binary operator is one IEEE float32 operation; ``min`` / ``max``
propagate NaN; ``sqrt`` is correctly rounded; ``acos`` / ``asin`` go through
the chain's minimax polynomial; ``sign(NaN)`` is NaN; ``x ^ 2`` and
``pow(x, 2)`` are ``x * x`` (the form XLA compiles them to).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import torch

from traversability_estimation_tpu_torch.ops.filters import _acos, sqrt_f32

_TOKEN_CHARS = set("+-*/^(),")


@dataclasses.dataclass(frozen=True)
class _Tok:
    kind: str  # 'num' | 'name' | 'op'
    text: str


class ExpressionError(ValueError):
    """Raised for syntax errors or unknown identifiers."""


def _tokenize(src: str) -> List[_Tok]:
    toks: List[_Tok] = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c.isspace():
            i += 1
        elif c in _TOKEN_CHARS:
            toks.append(_Tok("op", c))
            i += 1
        elif c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            while j < n and (src[j].isdigit() or src[j] == "."):
                j += 1
            # exponent suffix 1e-3 / 2.5E+4
            if j < n and src[j] in "eE":
                k = j + 1
                if k < n and src[k] in "+-":
                    k += 1
                if k < n and src[k].isdigit():
                    j = k
                    while j < n and src[j].isdigit():
                        j += 1
            toks.append(_Tok("num", src[i:j]))
            i = j
        elif c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            toks.append(_Tok("name", src[i:j]))
            i = j
        else:
            raise ExpressionError(f"unexpected character {c!r} in expression {src!r}")
    return toks


# function name -> (number of arguments, or None for one or more)
_ARITY: Dict[str, int | None] = {
    "sqrt": 1, "abs": 1, "exp": 1, "log": 1, "sin": 1, "cos": 1, "tan": 1,
    "acos": 1, "asin": 1, "atan": 1, "floor": 1, "ceil": 1, "sign": 1,
    "min": None, "max": None, "cwiseMin": None, "cwiseMax": None, "pow": 2,
}

# AST: nested tuples ('num', f) | ('var', name) | ('call', name, args) |
# ('bin', op, lhs, rhs) | ('neg', x)


class _Parser:
    def __init__(self, toks: List[_Tok], src: str):
        self.toks = toks
        self.pos = 0
        self.src = src

    def peek(self) -> _Tok | None:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def take(self) -> _Tok:
        t = self.peek()
        if t is None:
            raise ExpressionError(f"unexpected end of expression: {self.src!r}")
        self.pos += 1
        return t

    def expect(self, text: str):
        t = self.take()
        if t.text != text:
            raise ExpressionError(f"expected {text!r}, got {t.text!r} in {self.src!r}")

    def parse(self):
        node = self.expr()
        if self.peek() is not None:
            raise ExpressionError(f"trailing tokens at {self.peek().text!r} in {self.src!r}")
        return node

    def expr(self):
        node = self.term()
        while (t := self.peek()) and t.text in "+-":
            self.take()
            node = ("bin", t.text, node, self.term())
        return node

    def term(self):
        node = self.unary()
        while (t := self.peek()) and t.text in "*/":
            self.take()
            node = ("bin", t.text, node, self.unary())
        return node

    def unary(self):
        neg = False
        while (t := self.peek()) and t.text in "+-" and t.kind == "op":
            self.take()
            neg ^= t.text == "-"
        node = self.power()
        return ("neg", node) if neg else node

    def power(self):
        node = self.atom()
        if (t := self.peek()) and t.text == "^":
            self.take()
            node = ("bin", "^", node, self.unary())  # right-assoc
        return node

    def atom(self):
        t = self.take()
        if t.kind == "num":
            return ("num", float(t.text))
        if t.kind == "name":
            if (nxt := self.peek()) and nxt.text == "(":
                self.take()
                args = [self.expr()]
                while (c := self.peek()) and c.text == ",":
                    self.take()
                    args.append(self.expr())
                self.expect(")")
                if t.text not in _ARITY:
                    raise ExpressionError(f"unknown function {t.text!r}")
                return ("call", t.text, tuple(args))
            return ("var", t.text)
        if t.text == "(":
            node = self.expr()
            self.expect(")")
            return node
        raise ExpressionError(f"unexpected token {t.text!r} in {self.src!r}")


def parse(src: str):
    """Parse to an AST (hashable nested tuples)."""
    return _Parser(_tokenize(src), src).parse()


def variables(ast) -> Tuple[str, ...]:
    """All layer-name variables referenced by the AST, in first-use order."""
    out: List[str] = []

    def walk(node):
        kind = node[0]
        if kind == "var" and node[1] not in out:
            out.append(node[1])
        elif kind == "call":
            for a in node[2]:
                walk(a)
        elif kind == "bin":
            walk(node[2])
            walk(node[3])
        elif kind == "neg":
            walk(node[1])

    walk(ast)
    return tuple(out)


def _is_square(node) -> bool:
    """``x ^ 2`` / ``pow(x, 2)``: evaluated as ``x * x``."""
    return node[0] == "num" and node[1] == 2.0


def _check_arity(name: str, n_args: int) -> None:
    want = _ARITY[name]
    if want is not None and n_args != want:
        raise ExpressionError(f"{name}() takes {want} argument(s), got {n_args}")


# ---------------------------------------------------------------------------
# the plain version: whole-plane torch ops
# ---------------------------------------------------------------------------


def _sign(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(x), x, torch.sign(x))


_HALF_PI = float(torch.tensor(math.pi / 2, dtype=torch.float32))

_UNARY: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "sqrt": sqrt_f32,
    "abs": torch.abs,
    "exp": torch.exp,
    "log": torch.log,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "acos": _acos,
    "asin": lambda x: _HALF_PI - _acos(x),
    "atan": torch.atan,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "sign": _sign,
}
_VARIADIC = {
    "min": torch.minimum, "cwiseMin": torch.minimum,
    "max": torch.maximum, "cwiseMax": torch.maximum,
}


def _pow(lhs: torch.Tensor, rhs_node, rhs: Callable[[], torch.Tensor]) -> torch.Tensor:
    return lhs * lhs if _is_square(rhs_node) else torch.pow(lhs, rhs())


def evaluate(ast, layers: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Evaluate the AST over layer planes (coefficient-wise, float32). An
    expression of constants alone gives a 0-dim tensor."""
    if not layers:
        raise ExpressionError("no layers to evaluate the expression over")
    device = next(iter(layers.values())).device

    def ev(node) -> torch.Tensor:
        kind = node[0]
        if kind == "num":
            return torch.tensor(node[1], dtype=torch.float32, device=device)
        if kind == "var":
            name = node[1]
            if name not in layers:
                raise ExpressionError(
                    f"expression references unknown layer {name!r}; "
                    f"available: {sorted(layers)}"
                )
            return layers[name].to(torch.float32)
        if kind == "neg":
            return -ev(node[1])
        if kind == "call":
            name, args = node[1], node[2]
            _check_arity(name, len(args))
            if name == "pow":
                return _pow(ev(args[0]), args[1], lambda: ev(args[1]))
            if name in _VARIADIC:
                out = ev(args[0])
                for a in args[1:]:
                    out = _VARIADIC[name](out, ev(a))
                return out
            return _UNARY[name](ev(args[0]))
        op, lhs = node[1], ev(node[2])
        if op == "^":
            return _pow(lhs, node[3], lambda: ev(node[3]))
        rhs = ev(node[3])
        if op == "+":
            return lhs + rhs
        if op == "-":
            return lhs - rhs
        if op == "*":
            return lhs * rhs
        if op == "/":
            return lhs / rhs
        raise ExpressionError(f"unknown operator {op!r}")

    return ev(ast)


def compile_expression(src: str) -> Callable[[Mapping[str, torch.Tensor]], torch.Tensor]:
    """Compile an expression string into a function over a layer dict."""
    ast = parse(src)

    def fn(layers: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return evaluate(ast, layers)

    fn.variables = variables(ast)  # type: ignore[attr-defined]
    return fn


# ---------------------------------------------------------------------------
# the postfix program the CUDA kernel interprets
# ---------------------------------------------------------------------------

# opcodes, mirrored by the switch in csrc/fused_update.cu::run_program
OP_CONST, OP_LAYER, OP_NEG, OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_POW, OP_MIN, OP_MAX = range(10)
OP_SQUARE = 10
_OP_UNARY = {
    "sqrt": 11, "abs": 12, "exp": 13, "log": 14, "sin": 15, "cos": 16, "tan": 17,
    "acos": 18, "asin": 19, "atan": 20, "floor": 21, "ceil": 22, "sign": 23,
}
_OP_BINARY = {"+": OP_ADD, "-": OP_SUB, "*": OP_MUL, "/": OP_DIV}
_OP_VARIADIC = {"min": OP_MIN, "cwiseMin": OP_MIN, "max": OP_MAX, "cwiseMax": OP_MAX}
N_OPCODES = 24

# what one entry pushes onto (+1) or takes off (-1) the stack
_PUSHES = {OP_CONST: 1, OP_LAYER: 1, OP_ADD: -1, OP_SUB: -1, OP_MUL: -1, OP_DIV: -1,
           OP_POW: -1, OP_MIN: -1, OP_MAX: -1}

MAX_PROG = 64  # entries the kernel's parameter block holds
MAX_STACK = 8  # floats of the kernel's per-cell stack


def to_program(ast, variables: Sequence[str]) -> Tuple[Tuple[int, ...], Tuple[float, ...]]:
    """The AST as a postfix program ``(ops, args)``: ``ops[k]`` an opcode,
    ``args[k]`` its float32 constant (OP_CONST), the index into `variables`
    of its layer (OP_LAYER), else 0. ``min`` / ``max`` of n arguments become
    n - 1 binary entries. A variable not in `variables` raises
    ExpressionError."""
    ops: List[int] = []
    args: List[float] = []

    def emit(op: int, arg: float = 0.0) -> None:
        ops.append(op)
        args.append(arg)

    def power(base, exponent) -> None:
        walk(base)
        if _is_square(exponent):
            emit(OP_SQUARE)
        else:
            walk(exponent)
            emit(OP_POW)

    def walk(node) -> None:
        kind = node[0]
        if kind == "num":
            emit(OP_CONST, float(torch.tensor(node[1], dtype=torch.float32)))
        elif kind == "var":
            if node[1] not in variables:
                raise ExpressionError(
                    f"expression references unknown layer {node[1]!r}; "
                    f"available: {sorted(variables)}"
                )
            emit(OP_LAYER, float(list(variables).index(node[1])))
        elif kind == "neg":
            walk(node[1])
            emit(OP_NEG)
        elif kind == "call":
            name, cargs = node[1], node[2]
            _check_arity(name, len(cargs))
            if name == "pow":
                power(cargs[0], cargs[1])
            elif name in _OP_VARIADIC:
                walk(cargs[0])
                for a in cargs[1:]:
                    walk(a)
                    emit(_OP_VARIADIC[name])
            else:
                walk(cargs[0])
                emit(_OP_UNARY[name])
        elif node[1] == "^":
            power(node[2], node[3])
        else:
            walk(node[2])
            walk(node[3])
            emit(_OP_BINARY[node[1]])

    walk(ast)
    return tuple(ops), tuple(args)


def stack_depth(ops: Sequence[int]) -> int:
    """The deepest stack the program reaches."""
    depth = deepest = 0
    for op in ops:
        depth += _PUSHES.get(op, 0)
        deepest = max(deepest, depth)
    return deepest
