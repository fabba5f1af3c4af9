"""The kernel-function expression language (paper Fig. 4a).

The port's copy of ``repro.core.kernel_lang``.  Bodies of the iteration
kernel functions I, P, R, E are expressions over a small typed grammar that
drives (a) type-guided enumerative synthesis, (b) evaluation on torch
tensors inside the engines (``eval_expr``, ``compile_expr``) and on numpy
inside the condition checkers, and (c) code generation: ``emit_cuda``
prints a P expression as the body of a CUDA ``__device__`` function, which
the edge-sweep kernels call (``kernels/build.py``).

Environment names available to expressions:
  n        current propagated value                (type = value type T)
  v        vertex id (init function)               VERT
  s        source vertex id (init function)        VERT
  w        weight(e)                               FLT
  c        capacity(e)                             FLT
  esrc     src(e)                                  VERT
  edst     dst(e)                                  VERT
  outdeg   outdeg(src(e))                          FLT
  wdeg     Σ outgoing weight of src(e)             FLT
  nv       |V|                                     FLT
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

INT, FLT, BOOL, VERT = "int", "float", "bool", "vert"


@dataclasses.dataclass(frozen=True)
class Expr:
    pass


@dataclasses.dataclass(frozen=True)
class Lit(Expr):
    val: float
    ty: str

    def __str__(self):
        return str(self.val)


@dataclasses.dataclass(frozen=True)
class Var(Expr):
    name: str
    ty: str

    def __str__(self):
        return self.name


@dataclasses.dataclass(frozen=True)
class Bin(Expr):
    op: str  # + - * / min max == < > <= >=
    a: Expr
    b: Expr

    def __str__(self):
        if self.op in ("min", "max"):
            return f"{self.op}({self.a}, {self.b})"
        return f"({self.a} {self.op} {self.b})"


@dataclasses.dataclass(frozen=True)
class ITE(Expr):
    c: Expr
    a: Expr
    b: Expr

    def __str__(self):
        return f"(if {self.c} then {self.a} else {self.b})"


def _t(x):
    """Python scalars enter torch binary functions as 0-dim tensors, which
    rank below dimensioned tensors in torch's promotion exactly as JAX's
    weak-typed scalars do (int32 ∘ 1.5 → float32, int32 ∘ 1 → int32)."""
    return x if isinstance(x, torch.Tensor) else torch.tensor(x)


def _minmax(fn_np, fn_t, py):
    def f(a, b, xp):
        if not isinstance(a, (torch.Tensor, np.ndarray, np.generic)) and \
                not isinstance(b, (torch.Tensor, np.ndarray, np.generic)):
            return py(a, b)
        if xp is torch:
            return fn_t(_t(a), _t(b))
        return fn_np(a, b)
    return f


_BIN_FNS = {
    "+": lambda a, b, xp: a + b,
    "-": lambda a, b, xp: a - b,
    "*": lambda a, b, xp: a * b,
    "/": lambda a, b, xp: a / b,
    # NaN-propagating, like jnp.minimum / jnp.maximum
    "min": _minmax(np.minimum, torch.minimum, min),
    "max": _minmax(np.maximum, torch.maximum, max),
    "==": lambda a, b, xp: a == b,
    "<": lambda a, b, xp: a < b,
    ">": lambda a, b, xp: a > b,
    "<=": lambda a, b, xp: a <= b,
    ">=": lambda a, b, xp: a >= b,
}


def eval_expr(e: Expr, env: dict, xp=torch):
    """Evaluate ``e`` over ``env`` with ``xp`` = torch (tensors) or np."""
    if isinstance(e, Lit):
        return e.val
    if isinstance(e, Var):
        return env[e.name]
    if isinstance(e, Bin):
        return _BIN_FNS[e.op](eval_expr(e.a, env, xp), eval_expr(e.b, env, xp),
                              xp)
    if isinstance(e, ITE):
        c = eval_expr(e.c, env, xp)
        a, b = eval_expr(e.a, env, xp), eval_expr(e.b, env, xp)
        if xp is torch and isinstance(c, torch.Tensor):
            if not isinstance(a, torch.Tensor) and \
                    not isinstance(b, torch.Tensor):
                a = _t(a)
            return torch.where(c, a, b)
        return np.where(c, a, b)
    raise TypeError(e)


def compile_expr(e: Expr) -> Callable[[dict], object]:
    """Expr → closure over an env of tensors/scalars."""
    return lambda env: eval_expr(e, env, torch)


def expr_size(e: Expr) -> int:
    if isinstance(e, (Lit, Var)):
        return 1
    if isinstance(e, Bin):
        return 1 + expr_size(e.a) + expr_size(e.b)
    if isinstance(e, ITE):
        return 1 + expr_size(e.c) + expr_size(e.a) + expr_size(e.b)
    raise TypeError(e)


def expr_vars(e: Expr) -> frozenset:
    """The environment names ``e`` reads."""
    if isinstance(e, Lit):
        return frozenset()
    if isinstance(e, Var):
        return frozenset((e.name,))
    if isinstance(e, Bin):
        return expr_vars(e.a) | expr_vars(e.b)
    if isinstance(e, ITE):
        return expr_vars(e.c) | expr_vars(e.a) | expr_vars(e.b)
    raise TypeError(e)


# ---------------------------------------------------------------------------
# CUDA code generation.
# ---------------------------------------------------------------------------

# The types of the P environment inside the edge sweeps (the reference's
# kernel env: n is the state dtype, nv a strong float32 scalar).
ENV_TYPES = {"w": "float", "c": "float", "esrc": "int", "edst": "int",
             "outdeg": "float", "wdeg": "float", "nv": "float"}


def _lit_c(val, ty: str) -> str:
    if ty == "float":
        # double literal rounded once to float, as numpy/JAX convert a
        # Python float
        return f"((float){float(val)!r})"
    if ty == "bool":
        return "true" if val else "false"
    return f"((int){int(val)})"


def emit_cuda(expr: Expr, types: dict) -> tuple:
    """Print ``expr`` as a CUDA C++ expression.  ``types`` maps each
    environment name to ``"int"`` or ``"float"`` (int32 / float32).

    Typing follows the reference's JAX promotion, which the port's torch
    evaluation reproduces: a float operand makes a binary result float32;
    Python literals are weak (they take the other operand's type, and a
    subtree of literals alone folds in Python first); int32 / int32 is a
    float32 true division; comparisons give bool; ``min``/``max`` propagate
    NaN like ``jnp.minimum``/``jnp.maximum``; int32 arithmetic wraps
    (``iadd``/``isub``/``imul`` from ``edge_sweep.cuh``).

    Returns ``(code, ty)`` with ``ty`` in {"int", "float", "bool"}; the
    caller casts to the state type (float → int32 truncates toward zero)."""
    code, ty, weak = _emit(expr, types)
    if weak is not None:                    # a literal-only expression
        return _lit_c(weak, ty), ty
    return code, ty


def _py_ty(v) -> str:
    if isinstance(v, (bool, np.bool_)):
        return "bool"
    if isinstance(v, (int, np.integer)):
        return "int"
    return "float"


def _cast(code: str, src: str, dst: str) -> str:
    if src == dst:
        return code
    if dst == "float":
        return f"((float)({code}))"
    if dst == "int":
        return f"((int)({code}))"
    raise TypeError(f"cannot cast {src} to {dst}")


def _emit(e: Expr, types: dict):
    """(code, type, python value if literal-only else None)."""
    if isinstance(e, Lit):
        return None, _py_ty(e.val), e.val
    if isinstance(e, Var):
        ty = types[e.name]
        return e.name, ty, None
    if isinstance(e, Bin):
        ca, ta, va = _emit(e.a, types)
        cb, tb, vb = _emit(e.b, types)
        if va is not None and vb is not None:       # fold in Python
            v = eval_expr(e, {}, np)
            return None, _py_ty(v), v
        ty = "float" if "float" in (ta, tb) else "int"
        a = _lit_c(va, ty) if va is not None else _cast(ca, ta, ty)
        b = _lit_c(vb, ty) if vb is not None else _cast(cb, tb, ty)
        op = e.op
        if op in ("==", "<", ">", "<=", ">="):
            return f"({a} {op} {b})", "bool", None
        if op == "/":
            return f"({_cast(a, ty, 'float')} / {_cast(b, ty, 'float')})", \
                "float", None
        if op in ("min", "max"):
            fn = ("fmin_nan" if op == "min" else "fmax_nan") \
                if ty == "float" else ("imin" if op == "min" else "imax")
            return f"{fn}({a}, {b})", ty, None
        if ty == "int":
            fn = {"+": "iadd", "-": "isub", "*": "imul"}[op]
            return f"{fn}({a}, {b})", "int", None
        return f"({a} {op} {b})", "float", None
    if isinstance(e, ITE):
        cc, tc, vc = _emit(e.c, types)
        ca, ta, va = _emit(e.a, types)
        cb, tb, vb = _emit(e.b, types)
        cond = _lit_c(vc, "bool") if vc is not None else cc
        if va is not None and vb is not None:
            ty = _py_ty(np.where(True, va, vb).item())
        else:
            ty = "float" if "float" in (ta, tb) else \
                ("int" if "int" in (ta, tb) else "bool")
        a = _lit_c(va, ty) if va is not None else _cast(ca, ta, ty)
        b = _lit_c(vb, ty) if vb is not None else _cast(cb, tb, ty)
        return f"(({cond}) ? {a} : {b})", ty, None
    raise TypeError(e)


# ---------------------------------------------------------------------------
# Type-guided enumerative search: expressions of a requested type in order
# of increasing size, memoized per (type, size).
# ---------------------------------------------------------------------------

_ARITH_OPS = ("+", "-", "min", "max", "*", "/")
_NUM = (INT, FLT)


class Enumerator:
    def __init__(self, terminals):
        """terminals: list[Expr] (Vars and Lits available in this context)."""
        self.terminals = list(terminals)
        self._memo: dict = {}

    def of(self, ty: str, size: int):
        """All expressions of type `ty` with exactly `size` AST nodes."""
        key = (ty, size)
        if key in self._memo:
            return self._memo[key]
        out = []
        if size == 1:
            out = [t for t in self.terminals
                   if t.ty == ty or (ty == FLT and t.ty == INT)]
        else:
            if ty in _NUM:
                for op in _ARITH_OPS:
                    # int expressions stay int-typed; '/' only for floats
                    if op == "/" and ty == INT:
                        continue
                    for sa in range(1, size - 1):
                        for a in self.of(ty, sa):
                            for b in self.of(ty, size - 1 - sa):
                                out.append(Bin(op, a, b))
            if ty == BOOL:
                for op in ("==", "<"):
                    for base_ty in (INT, FLT, VERT):
                        for sa in range(1, size - 1):
                            for a in self.of(base_ty, sa):
                                for b in self.of(base_ty, size - 1 - sa):
                                    out.append(Bin(op, a, b))
        self._memo[key] = out
        return out

    def upto(self, ty: str, max_size: int):
        for k in range(1, max_size + 1):
            yield from self.of(ty, k)


def default_terminals(value_ty: str, for_init: bool = False):
    """Terminal set for synthesizing P (or I when for_init)."""
    ts = [Lit(0, INT), Lit(1, INT)]
    if for_init:
        ts += [Var("v", VERT), Var("s", VERT)]
    else:
        ts += [Var("n", value_ty), Var("w", FLT), Var("c", FLT),
               Var("esrc", VERT), Var("edst", VERT), Var("outdeg", FLT),
               Var("nv", FLT)]
    return ts
