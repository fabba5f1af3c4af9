"""Correctness and termination conditions C1–C10 (paper Fig. 9) as
executable, bounded-verification checkers — the port's copy of
``repro.core.conditions``.

The paper discharges these universally-quantified conditions with Z3.  Z3 is
unavailable offline, so we check validity by exhaustive evaluation over small
integer domains plus dense random float sampling, using the *extension laws*
of the path functions (lang.PathFn.extend) to replace quantification over
paths with quantification over (value, edge) pairs:

  C4  P(R(F(p1), F(p2)), e) = R(F(p1·e), F(p2·e))
      →  ∀ n1, n2, e:  P(R(n1,n2), e) = R(ext_F(n1,e), ext_F(n2,e))
  C5  P(F(p), e) = F(p·e)        →  ∀ n, e:  P(n,e) = ext_F(n,e)
  C10 (strengthened, §5.2)       →  ∀ n, e:  R(n, ext_F(n,e)) = n

All candidate bodies are piecewise-affine min/max arithmetic over the
grammar of Fig. 4a; hypothesis-based property tests in tests/ re-check the
accepted kernels with thousands of random samples, and the end-to-end suite
cross-validates against the path-enumeration oracle.
"""
from __future__ import annotations

import itertools
import math

import numpy as np

from repro_torch.core import lang as L
from repro_torch.core.kernel_lang import Expr, eval_expr

_REL_TOL = 1e-6


def _eq(a, b) -> bool:
    if isinstance(a, bool) or isinstance(b, bool):
        return bool(a) == bool(b)
    if a == b:
        return True
    try:
        return math.isclose(float(a), float(b), rel_tol=_REL_TOL, abs_tol=1e-9)
    except (TypeError, OverflowError):
        return False


def sample_edges(f: L.PathFn, rng: np.random.Generator, k: int = 24):
    """Edge tuples (src, dst, w, c) + env extras, honoring graph contracts
    (w ≥ 0 — paper's SSSP termination assumes non-negative edges; c > 0)."""
    edges = []
    for w in (0.0, 1.0, 2.5):
        for c in (0.5, 1.0, 3.0):
            edges.append((1, 2, w, c))
    for _ in range(k):
        edges.append((int(rng.integers(0, 6)), int(rng.integers(0, 6)),
                      float(np.round(rng.uniform(0, 8), 3)),
                      float(np.round(rng.uniform(0.1, 8), 3))))
    return edges


def sample_values(f: L.PathFn, rng: np.random.Generator, k: int = 12):
    """Plausible F-codomain values (finite — ⊥ is handled by the P'/R'
    wrappers, conditions C3/C6 hold by construction)."""
    if f.kind == "length":
        return [0, 1, 2, 3, 5, 9]
    if f.kind == "one":
        return [1, 2, 3, 7]
    if f.kind in ("head", "penultimate"):
        return [0, 1, 2, 5]
    if f.kind == "capacity":
        base = [0.5, 1.0, 3.0, L.CAP_INF]
    else:
        base = [0.0, 1.0, 2.5, 7.0]
    return base + [float(np.round(rng.uniform(0, 9), 3)) for _ in range(k)]


def _env(n, edge):
    src, dst, w, c = edge
    return {"n": n, "w": w, "c": c, "esrc": src, "edst": dst,
            "outdeg": 2.0, "nv": 8.0}


def check_C5(p: Expr, f: L.PathFn, rng) -> bool:
    for n in sample_values(f, rng):
        for e in sample_edges(f, rng, 8):
            if not _eq(eval_expr(p, _env(n, e), np), f.extend(n, e)):
                return False
    return True


def check_C4(p: Expr, f: L.PathFn, rop: str, rng) -> bool:
    vals = sample_values(f, rng, 6)
    for n1, n2 in itertools.product(vals, vals):
        for e in sample_edges(f, rng, 4):
            lhs = eval_expr(p, _env(L.reduce_op(rop, n1, n2), e), np)
            rhs = L.reduce_op(rop, f.extend(n1, e), f.extend(n2, e))
            if not _eq(lhs, rhs):
                return False
    return True


def check_R(rop: str, require_idempotent: bool, rng) -> bool:
    """C6 holds by the R' wrapper; check C7 (comm), C8 (assoc), C9 (idem)."""
    vals = [0.0, 1.0, 2.5, 7.0, -3.0] + list(np.round(rng.uniform(-9, 9, 4), 3))
    for a, b, c in itertools.product(vals, vals, vals):
        if not _eq(L.reduce_op(rop, a, b), L.reduce_op(rop, b, a)):
            return False
        if not _eq(L.reduce_op(rop, L.reduce_op(rop, a, b), c),
                   L.reduce_op(rop, a, L.reduce_op(rop, b, c))):
            return False
    if require_idempotent:
        for a in vals:
            if not _eq(L.reduce_op(rop, a, a), a):
                return False
    return True


def check_I(i_expr: Expr, f: L.PathFn, rng) -> bool:
    """C1: the on-source branch must equal F(⟨v,v⟩) (C2 — the off-source ⊥
    branch — holds by construction of the structured I)."""
    for v in range(6):
        env = {"v": v, "s": v, "w": 0.0, "c": 0.0, "esrc": v, "edst": v,
               "outdeg": 1.0, "nv": 8.0, "n": 0}
        if not _eq(eval_expr(i_expr, env, np), f.trivial(v)):
            return False
    return True


def check_C10(f: L.PathFn, rop: str, rng) -> bool:
    """Strengthened termination (§5.2): R(F(p), F(p·e)) = F(p) for every
    edge extension, under the graph contracts."""
    for n in sample_values(f, rng):
        if n >= L.CAP_INF and f.kind != "capacity":
            continue
        for e in sample_edges(f, rng, 8):
            ext = f.extend(n, e)
            if not _eq(L.reduce_op(rop, n, ext), n):
                return False
    return True


# ---------------------------------------------------------------------------
# Runtime termination preconditions (the guarded-execution entry check).
# ---------------------------------------------------------------------------

_IN_CONTRACT_W_MIN = 0.0      # sample_edges' graph contract: w >= 0, c > 0.
                              # Synthesis verifies C10 under exactly these
                              # ranges, so in-contract graphs need no re-probe.


def _probe_values(dtype_str: str):
    """Plausible finite F-codomain samples per component dtype (⊥ excluded —
    the P'/R' wrappers handle it, C3/C6)."""
    if dtype_str in ("int", "vert"):
        return [0, 1, 2, 5]
    return [0.0, 1.0, 2.5, 7.0]


def violated_preconditions(comps, plans, w_range, c_range) -> list:
    """Probe the strengthened termination condition C10 — R(n, P'(n, e)) = n
    (§5.2) — against a graph's ACTUAL edge-value ranges.

    Synthesis discharges C10 under the graph contracts ``w >= 0, c > 0``
    (``sample_edges``); a graph outside those ranges (negative weights under
    min-plus being the canonical case) voids that proof, so the engine entry
    points re-probe here with (value, edge) samples drawn from the real
    ranges before launching a fixpoint that may never terminate.  In-contract
    graphs return ``[]`` without probing.

    ``comps`` are the runtime components (``iterate.CompRuntime``: the
    synthesized ``p_fn`` closures evaluate P exactly as the engines do);
    only each plan's PRIMARY level is probed — lexicographic secondaries
    ride the primary's ordering (FPNEST), and non-idempotent reductions
    (PageRank-style sum/prod with an epilogue) terminate by tol/max_iter,
    not by C10.  Returns a list of violation dicts
    ``{"condition", "component", "op", "detail"}``."""
    import numpy as _np

    w_lo, w_hi = float(w_range[0]), float(w_range[1])
    c_lo, c_hi = float(c_range[0]), float(c_range[1])
    in_contract = w_lo >= _IN_CONTRACT_W_MIN and c_lo > 0.0
    if in_contract:
        return []
    comps_by_idx = {cr.idx: cr for cr in comps}
    edge_vals = sorted({w_lo, w_hi, (w_lo + w_hi) / 2.0})
    cap_vals = sorted({c_lo, c_hi, (c_lo + c_hi) / 2.0})
    out = []
    for plan in plans:
        cr = comps_by_idx[plan.comp]
        if plan.op not in ("min", "max", "or", "and") or cr.e_fn is not None:
            continue                      # tol/max_iter-bounded, not C10
        # component dtypes are torch dtypes in the port
        dtype_str = "float" if cr.dtype.is_floating_point else "int"
        for n0 in _probe_values(dtype_str):
            for w0 in edge_vals:
                for c0 in cap_vals:
                    env = {"n": n0, "w": w0, "c": c0, "esrc": 1, "edst": 2,
                           "outdeg": 2.0, "wdeg": 1.0, "nv": 8.0}
                    try:
                        ext = float(_np.asarray(cr.p_fn(env)))
                    except Exception:     # non-scalar/odd P: can't probe
                        continue
                    red = L.reduce_op(plan.op, n0, ext)
                    if not _eq(red, n0):
                        out.append({
                            "condition": "C10",
                            "component": cr.idx,
                            "op": plan.op,
                            "detail": (
                                f"R(n, P(n, e)) != n at n={n0}, "
                                f"w={w0}, c={c0}: "
                                f"{plan.op}({n0}, {ext}) = {red}"),
                        })
                        break
                else:
                    continue
                break
            else:
                continue
            break
    return out
