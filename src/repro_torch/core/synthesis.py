"""Type-guided enumerative synthesis of the iteration kernel functions
(paper §5.2) — the port's copy of ``repro.core.synthesis``.

Given a factored path-based reduction ``R F`` the synthesizer searches the
grammar of Fig. 4a (kernel_lang) in order of increasing expression size for

  I — the initialization function, specified by C1/C2,
  P — the propagation function, specified by C4/C5 (wrapped into P' for C3),
  R — the reduction function, validated against C6–C9,

memoizing candidate pools per type and caching results per (F, R).

Code generation: ``emit_cuda_round`` prints the P expressions of one fused
round as CUDA ``__device__`` functions in one translation unit that
includes ``csrc/edge_sweep.cuh`` and instantiates its three sweep kernels
(pull, push, sorted push resolution) for the round; ``emit_cuda_level``
prints the P expressions of one ``ell_level_reduce`` call into a unit that
instantiates ``csrc/edge_level.cuh``'s level kernel.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.core import conditions as C
from repro_torch.core import lang as L
from repro_torch.core.kernel_lang import (ENV_TYPES, Bin, Enumerator, Expr,
                                          Lit, Var, FLT, INT, VERT,
                                          compile_expr, default_terminals,
                                          emit_cuda, expr_vars)


@dataclasses.dataclass
class SynthesizedKernels:
    f: L.PathFn
    rop: str
    p_expr: Expr
    i_expr: Expr                  # on-source branch (C2's ⊥ branch is structural)
    idempotent: bool
    terminating: bool             # strengthened C10 verified
    candidates_tried: int
    wall_ms: float

    def p_fn(self):
        return compile_expr(self.p_expr)

    def init_fn(self):
        """Source-generic init kernel ``init_fn(v, s=None)``: the on-source
        branch is only read where ``v == s``; ``s=None`` (sourceless
        components) evaluates the trivial path at each vertex."""
        fn = compile_expr(self.i_expr)
        return lambda v, s=None: fn({"v": v, "s": v if s is None else s})

    def describe(self) -> str:
        return (f"I := λv. if (v = s) {self.i_expr} else ⊥\n"
                f"P := λn, e. {self.p_expr}\n"
                f"R := {self.rop}  (idempotent={self.idempotent})\n"
                f"E := λn. n")


_VALUE_TY = {"int": INT, "float": FLT, "vert": VERT}
_CACHE: dict = {}


class SynthesisError(Exception):
    pass


def synthesize_component(f: L.PathFn, rop: str,
                         require_idempotent: bool = False) -> SynthesizedKernels:
    key = (f.kind, rop, require_idempotent)
    if key in _CACHE:
        return _CACHE[key]
    t0 = time.perf_counter()
    rng = np.random.default_rng(0xC0FFEE)
    ty = _VALUE_TY[f.dtype]

    if not C.check_R(rop, require_idempotent, rng):
        raise SynthesisError(f"reduction {rop} violates C7–C9 "
                             f"(idempotent={require_idempotent})")

    # --- P: C5 then C4, smallest first ------------------------------------
    tried = 0
    p_expr = None
    enum = Enumerator(default_terminals(ty))
    for cand in enum.upto(ty, 5):
        tried += 1
        if C.check_C5(cand, f, rng) and C.check_C4(cand, f, rop, rng):
            p_expr = cand
            break
    if p_expr is None:
        raise SynthesisError(f"no propagation function found for {rop} {f}")

    # --- I: the on-source branch must match F(⟨v,v⟩) (C1) ------------------
    init_terms = [Lit(0, INT), Lit(1, INT), Lit(L.CAP_INF, FLT),
                  Var("v", VERT), Var("s", VERT)]
    i_expr = None
    ienum = Enumerator(init_terms)
    for cand in ienum.upto(ty, 3):
        tried += 1
        if C.check_I(cand, f, rng):
            i_expr = cand
            break
    if i_expr is None:
        raise SynthesisError(f"no initialization function found for {f}")

    terminating = C.check_C10(f, rop, rng)
    out = SynthesizedKernels(
        f=f, rop=rop, p_expr=p_expr, i_expr=i_expr,
        idempotent=L.IDEMPOTENT[rop], terminating=terminating,
        candidates_tried=tried, wall_ms=(time.perf_counter() - t0) * 1e3)
    _CACHE[key] = out
    return out


_ROUND_CACHE: dict = {}


def _plan_position_ops(round_) -> dict:
    """{comp idx: monoid} from each leaf plan's lex-level positions."""
    from repro_torch.core.fusion import Lex

    ops = {}

    def walk(plan):
        ops[plan.comp] = plan.op
        if isinstance(plan, Lex):
            walk(plan.secondary)

    for leaf in round_.leaves:
        walk(leaf.plan)
    return ops


def round_structure_key(round_) -> tuple:
    """Structural identity of a round's iteration part: component path
    functions, sourced-ness and plan-position monoids (the source VALUE is
    runtime data)."""
    ops = _plan_position_ops(round_)
    return tuple((comp.idx, comp.f.kind, comp.source is not None,
                  ops[comp.idx])
                 for comp in round_.components)


def synthesize_round(round_) -> dict:
    """Synthesize kernels for every component of a FusedRound.

    Returns {comp_idx: (p_fn, init_fn)} for iterate.comp_runtimes, plus the
    SynthesizedKernels records under key ("kernels", idx), memoized per
    round structure."""
    key = round_structure_key(round_)
    hit = _ROUND_CACHE.get(key)
    if hit is not None:
        return hit

    ops = _plan_position_ops(round_)
    out = {}
    for comp in round_.components:
        sk = synthesize_component(comp.f, ops[comp.idx])
        out[comp.idx] = (sk.p_fn(), sk.init_fn())
        out[("kernels", comp.idx)] = sk
    _ROUND_CACHE[key] = out
    return out


# ---------------------------------------------------------------------------
# Direct kernel specification (PageRank — paper Fig. 4b gives the kernels
# explicitly; PR's damped-path F is outside the spec language).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DirectKernels:
    """User-supplied kernels, same shape the synthesizer produces.

    ``p_expr`` is P as an ``Expr`` — what the CUDA sweeps are generated
    from (``emit_cuda_round``); ``p_fn`` must compute the same function on
    tensors.  A kernel set without ``p_expr`` runs on the reference engines
    only."""
    name: str
    rop: str
    dtype: str                      # "int" | "float"
    p_fn: object                    # env → value
    init_fn: object                 # (v, s) → value  (or legacy v → value)
    e_fn: Optional[object] = None   # epilogue
    tol: float = 0.0
    max_iter: Optional[int] = None
    source: Optional[int] = None    # default query source (None = sourceless)
    p_expr: Optional[Expr] = None


def pagerank_kernels(n: int, gamma: float = 0.85, tol: float = 1e-6,
                     max_iter: int = 100) -> DirectKernels:
    """Fig. 4b: I = λv. 1/|V|;  P = λn,e. n / outdeg(src(e));  R = sum;
    E = λn. γ·n + (1−γ)/|V|."""
    p_expr = Bin("/", Var("n", FLT), Var("outdeg", FLT))
    return DirectKernels(
        name="pagerank", rop="sum", dtype="float",
        p_fn=compile_expr(p_expr),
        init_fn=lambda v: v * 0 + 1.0 / n,
        e_fn=lambda env: gamma * env["n"] + (1.0 - gamma) / n,
        tol=tol, max_iter=max_iter, p_expr=p_expr)


def weighted_pagerank_kernels(n: int, gamma: float = 0.85, tol: float = 1e-6,
                              max_iter: int = 100) -> DirectKernels:
    """Weighted PageRank: P = λn,e. n · w(e) / wdeg(src(e)); I and E as in
    unweighted PageRank.  On the cuda engine ``model="push"`` runs it as the
    push− recompute whose sorted resolution reduces the same dst-major
    rectangle as the pull sweep, so push ≡ pull holds bitwise."""
    p_expr = Bin("/", Bin("*", Var("n", FLT), Var("w", FLT)),
                 Var("wdeg", FLT))
    return DirectKernels(
        name="weighted_pagerank", rop="sum", dtype="float",
        p_fn=compile_expr(p_expr),
        init_fn=lambda v: v * 0 + 1.0 / n,
        e_fn=lambda env: gamma * env["n"] + (1.0 - gamma) / n,
        tol=tol, max_iter=max_iter, p_expr=p_expr)


# ---------------------------------------------------------------------------
# Backend code generation: printable source for a kernel set.
# ---------------------------------------------------------------------------

_ENGINE_TEMPLATES = {
    "pull": """# pull engine (PowerGraph-pull analogue) — generated by Grafs
def propagate(n, w, c, esrc, edst, outdeg, nv):
    return {p}
def init(v, s):
    return torch.where(v == s, {i}, IDENT)   # IDENT = ⊥ of {rop}
# per iteration: vals = propagate(state[src], ...);  segment_{rop}(vals, dst)
""",
    "push": """# push engine (Ligra analogue) — generated by Grafs
def propagate(n, w, c, esrc, edst, outdeg, nv):
    return {p}
# per iteration: frontier-masked  state.scatter_reduce(dst, propagate(state[src]), {rop})
""",
    "cuda": """// cuda engine (GraphIt analogue) — generated by Grafs
// blocked-ELL tile kernels: gather → propagate → masked {rop}-reduce
__device__ T propagate(T n, float w, float c, int esrc, int edst,
                       float outdeg, float wdeg, float nv) {{
    return {p};
}}
""",
}


def emit_source(sk: SynthesizedKernels, engine: str) -> str:
    tpl = _ENGINE_TEMPLATES[engine]
    p = emit_cuda(sk.p_expr, _env_types(sk.f.dtype))[0] if engine == "cuda" \
        else str(sk.p_expr)
    return tpl.format(p=p, i=str(sk.i_expr), rop=sk.rop)


_OP_CODE = {"min": "OP_MIN", "max": "OP_MAX", "sum": "OP_SUM",
            "prod": "OP_PROD"}


def _env_types(state_dtype: str) -> dict:
    return {"n": "float" if state_dtype == "float" else "int", **ENV_TYPES}


def _word(val, is_float: bool) -> str:
    """A 32-bit word literal holding ``val`` as float32 or int32."""
    arr = np.asarray(val, np.float32 if is_float else np.int32)
    return f"0x{int(arr.view(np.uint32)):08x}u"


def _switch(name, rtype, items) -> str:
    cases = "".join(f"      case {k}: return {v};\n"
                    for k, v in enumerate(items))
    return (f"  static __device__ __forceinline__ {rtype} {name}(int k) "
            f"{{\n    switch (k) {{\n{cases}      default: return 0;\n"
            f"    }}\n  }}\n")


def _p_members(p_exprs, dtypes, idents, reads) -> list:
    """The members every generated struct shares: ``NC``, the ``READS_*``
    flags (the kernels load no other per-edge input), the per-component
    float flag and identity, and one ``P`` per component printed by
    ``emit_cuda``."""
    is_f = [d == "float" for d in dtypes]
    p_cases = []
    for k, (expr, dt) in enumerate(zip(p_exprs, dtypes)):
        ty = "float" if dt == "float" else "int"
        code, ety = emit_cuda(expr, _env_types(dt))
        if ety != ty:
            code = f"(({ty})({code}))"
        n_load = "as_f(nw)" if ty == "float" else "as_i(nw)"
        p_cases.append(
            f"      case {k}: {{\n"
            f"        const {ty} n = {n_load};\n"
            f"        return w_of(({ty})({code}));\n"
            f"      }}\n")
    return [
        f"  static constexpr int NC = {len(p_exprs)};\n",
        *(f"  static constexpr bool READS_{name.upper()} = "
          f"{'true' if name in reads else 'false'};\n"
          for name in ("w", "c", "edst", "outdeg", "wdeg")),
        _switch("comp_float", "bool",
                ["true" if f else "false" for f in is_f]),
        _switch("ident", "uint32_t",
                [_word(i, f) for i, f in zip(idents, is_f)]),
        "  static __device__ __forceinline__ uint32_t P(int k, const Env& e,\n"
        "                                               uint32_t nw) {\n"
        "    const float w = e.w, c = e.c, outdeg = e.outdeg, wdeg = e.wdeg;\n"
        "    const float nv = e.nv;\n"
        "    const int esrc = e.esrc, edst = e.edst;\n"
        "    (void)w; (void)c; (void)outdeg; (void)wdeg; (void)nv;\n"
        "    (void)esrc; (void)edst;\n"
        "    switch (k) {\n",
        *p_cases,
        "      default: return 0u;\n    }\n  }\n",
    ]


def emit_cuda_round(p_exprs, dtypes, idents, plan_specs) -> str:
    """One CUDA translation unit for one fused round.

    ``p_exprs``/``dtypes``/``idents`` describe the round's components in
    the sweeps' component order (``edge_reduce.comps_in_plan_order``):
    each P as an ``Expr``, its state type (``"int"``/``"float"``) and its
    reduction identity.  ``plan_specs`` holds per plan a tuple of
    ``(component position, kernel monoid)`` lex levels, primary first (the
    boolean monoids already mapped to int32 max/min).

    The unit defines ``struct Round`` — the round's shape as constants,
    which per-edge inputs its P functions read (``READS_*``: the kernels
    load no other), its identities and one ``P`` per component printed by
    ``emit_cuda`` — and instantiates the three kernel templates of
    ``edge_sweep.cuh`` for it behind the plain C entry points
    ``grafs_pull``, ``grafs_push`` and ``grafs_resolve``."""
    reads = frozenset().union(*map(expr_vars, p_exprs))
    levels = [(pos, op, li == 0, li == len(spec) - 1)
              for spec in plan_specs for li, (pos, op) in enumerate(spec)]
    src = [
        "// Generated by repro_torch.core.synthesis.emit_cuda_round.\n",
        '#include "edge_sweep.cuh"\n\nusing namespace grafs;\n\n',
        "struct Round {\n",
        f"  static constexpr int NLEV = {len(levels)};\n",
        _switch("lev_pos", "int", [str(lv[0]) for lv in levels]),
        _switch("lev_op", "int", [_OP_CODE[lv[1]] for lv in levels]),
        _switch("lev_first", "bool",
                ["true" if lv[2] else "false" for lv in levels]),
        _switch("lev_last", "bool",
                ["true" if lv[3] else "false" for lv in levels]),
        *_p_members(p_exprs, dtypes, idents, reads),
        "};\n\n",
        "GRAFS_DEFINE_ENTRY_POINTS(Round)\n",
    ]
    return "".join(src)


def emit_cuda_level(p_exprs, dtypes, idents, op: str, mode: str) -> str:
    """One CUDA translation unit for ``edge_reduce.ell_level_reduce``.

    ``p_exprs``/``dtypes``/``idents`` describe the levels, priors first and
    the reduced level last: each P as an ``Expr``, its state type
    (``"int"``/``"float"``) and its identity (= ⊥).  ``op`` is the reduced
    level's kernel monoid (boolean monoids already mapped to int32
    max/min); ``mode`` is ``"value"`` (reduce the P values) or
    ``"nonbot"`` (reduce "state is not ⊥" as int32 max).  The unit defines
    ``struct Level`` and instantiates ``edge_level.cuh``'s kernel behind
    the plain C entry point ``grafs_level``.  In ``nonbot`` mode the last
    P is never evaluated, so its inputs are not loaded."""
    used = p_exprs if mode == "value" else p_exprs[:-1]
    reads = frozenset().union(*map(expr_vars, used))
    if mode == "value":
        out_float = dtypes[-1] == "float"
        out_ident = _word(idents[-1], out_float)
        out_op = _OP_CODE[op]
    else:
        out_float, out_ident, out_op = False, _word(0, False), "OP_MAX"
    src = [
        "// Generated by repro_torch.core.synthesis.emit_cuda_level.\n",
        '#include "edge_level.cuh"\n\nusing namespace grafs;\n\n',
        "struct Level {\n",
        f"  static constexpr int OP = {out_op};\n",
        f"  static constexpr bool NONBOT = "
        f"{'true' if mode == 'nonbot' else 'false'};\n",
        f"  static constexpr bool OUT_FLOAT = "
        f"{'true' if out_float else 'false'};\n",
        f"  static constexpr uint32_t OUT_IDENT = {out_ident};\n",
        *_p_members(p_exprs, dtypes, idents, reads),
        "};\n\n",
        "GRAFS_DEFINE_LEVEL_ENTRY(Level)\n",
    ]
    return "".join(src)
