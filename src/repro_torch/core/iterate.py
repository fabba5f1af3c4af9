"""Iterative reduction engines (paper §3, Fig. 5) on PyTorch.

The port's counterpart of ``repro.core.iterate``: the plan algebra shared by
every engine, and the ``pull``/``push`` reference engines — the paper's
synchronous models

  pull+  Def. 1: gather from predecessors, merge with previous value
  pull−  Def. 2: gather from ALL predecessors, full recompute
  push+  Def. 3: frontier-masked scatter from changed predecessors
  push−  Def. 4: scatter recompute from all predecessors

over *reduction plans* (``Prim`` / ``Lex`` trees), and on the same plan
algebra the ``adaptive`` engine (Gemini: per iteration, pull when the
frontier is dense, push when it is sparse), the ``dense`` engine
(GridGraph analogue: reductions over ``[n, n]`` edge matrices, small graphs
only) and the ``distributed`` engine (a vertex cut: per-shard segment
reduces folded across the shards of a ``ShardMesh``, ``cross_shard``).
These engines use only torch segment/scatter and dense reductions
(``graph.segment``), none of the CUDA sweeps, so they are the port's own
oracle for the ``cuda`` engine on the card and the floor of its fallback
chain.  Each fixpoint is a host loop that reads the frontier once per
iteration.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.fusion import FusedRound, Lex, Prim
from repro_torch.graph import segment
from repro_torch.graph.partition import mesh_shards, partition_edges
from repro_torch.graph.structure import Graph
from repro_torch.graph.structure import w_out_deg as structure_w_out_deg

DTYPES = {"int": torch.int32, "float": torch.float32, "vert": torch.int32}

_IDEMPOTENT_OPS = ("min", "max", "or", "and")


@dataclasses.dataclass(frozen=True)
class CompRuntime:
    """Everything an engine needs for one component of the fused tuple.

    ``p_expr`` is the synthesized P as an ``Expr`` (what the CUDA sweeps are
    generated from); ``p_fn`` evaluates the same P on tensors."""
    idx: int
    op: str
    dtype: object                    # torch dtype
    p_fn: Callable
    init_fn: Callable
    source: Optional[int]
    e_fn: Optional[Callable] = None
    p_expr: object = None

    @property
    def ident(self):
        return segment.identity(self.op, self.dtype)


def comp_runtimes(round_: FusedRound, synth: dict) -> list:
    """Assign each component its plan-position monoid + synthesized kernels.
    ``synth[idx]`` = (p_fn, init_fn[, e_fn]); ``synth[("kernels", idx)]``,
    when present, supplies the P expression."""
    ops = {}

    def walk(plan):
        ops[plan.comp] = plan.op
        if isinstance(plan, Lex):
            walk(plan.secondary)

    for leaf in round_.leaves:
        walk(leaf.plan)
    out = []
    for comp in round_.components:
        entry = synth[comp.idx]
        p_fn, init_fn = entry[0], entry[1]
        e_fn = entry[2] if len(entry) > 2 else None
        sk = synth.get(("kernels", comp.idx))
        out.append(CompRuntime(
            idx=comp.idx, op=ops[comp.idx], dtype=DTYPES[comp.f.dtype],
            p_fn=p_fn, init_fn=init_fn, source=comp.source, e_fn=e_fn,
            p_expr=None if sk is None else sk.p_expr))
    return out


# ---------------------------------------------------------------------------
# Plan algebra: segment-reduce, scatter-reduce and two-state merge.
# ---------------------------------------------------------------------------

def _ident(cr):
    return cr.ident.item()


def _plan_comps(plan):
    if isinstance(plan, Prim):
        return (plan.comp,)
    return (plan.comp,) + _plan_comps(plan.secondary)


def plan_idempotent(plan) -> bool:
    if isinstance(plan, Prim):
        return plan.op in _IDEMPOTENT_OPS
    return plan_idempotent(plan.secondary)


def plan_segment_reduce(plan, evals: dict, dst, n: int, comps) -> dict:
    """Reduce per-edge values into per-vertex partials (pull side)."""
    dst_l = dst.long()
    if isinstance(plan, Prim):
        return {plan.comp: segment.segment_reduce(plan.op, evals[plan.comp],
                                                  dst, n)}
    prim = segment.segment_reduce(plan.op, evals[plan.comp], dst, n)
    tie = evals[plan.comp] == prim[dst_l]
    masked = dict(evals)
    for j in _plan_comps(plan.secondary):
        masked[j] = torch.where(tie, evals[j], _ident(comps[j]))
    return {plan.comp: prim,
            **plan_segment_reduce(plan.secondary, masked, dst, n, comps)}


def plan_scatter_reduce(plan, old: dict, evals: dict, dst, eactive, keep,
                        comps) -> dict:
    """Push side: scatter per-edge values onto (lex-masked) old state."""
    c = plan.comp
    init = torch.where(keep, old[c], _ident(comps[c]))
    vals = torch.where(eactive, evals[c], _ident(comps[c]))
    prim = segment.scatter_reduce(plan.op, init, vals, dst)
    if isinstance(plan, Prim):
        return {c: prim}
    tie_e = eactive & (evals[c] == prim[dst.long()])
    keep2 = keep & (old[c] == prim)
    rec = plan_scatter_reduce(plan.secondary, old, evals, dst, tie_e, keep2,
                              comps)
    return {c: prim, **rec}


def plan_merge(plan, a: dict, b: dict, comps) -> dict:
    """Lexicographic/componentwise merge of two candidate states."""
    c = plan.comp
    prim = segment.combine(plan.op, a[c], b[c])
    if isinstance(plan, Prim):
        return {c: prim}
    a_w = a[c] == prim
    b_w = b[c] == prim
    tie = a_w & b_w
    rec = plan_merge(plan.secondary, a, b, comps)
    out = {c: prim}
    for j in _plan_comps(plan.secondary):
        out[j] = torch.where(tie, rec[j], torch.where(a_w, a[j], b[j]))
    return out


def _recompute_merge(plans, comps_by_idx, state_d, red, has_pred) -> dict:
    """Update rule of the non-idempotent (−) models: the recomputed value
    wins unless the previous value is strictly better, vertices with no
    non-⊥ predecessor keep their value, and epilogue components always
    take the recomputed value."""
    new_d = {}
    for p in plans:
        c = p.comp
        if comps_by_idx[c].e_fn is not None:
            for j in _plan_comps(p):
                new_d[j] = red[j]
            continue
        if isinstance(p, Prim) and p.op not in _IDEMPOTENT_OPS:
            new_d[c] = torch.where(has_pred[c], red[c], state_d[c])
            continue
        comb = segment.combine(p.op, state_d[c], red[c])
        strictly = (comb == state_d[c]) & (state_d[c] != red[c])
        take_old = strictly | ~has_pred[c]
        for j in _plan_comps(p):
            new_d[j] = torch.where(take_old, state_d[j], red[j])
    return new_d


# ---------------------------------------------------------------------------
# Shared iteration scaffolding.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IterationResult:
    state: tuple                     # per-component [n] tensors
    iterations: int
    edge_work: int
    converged: bool = True
    diverged: bool = False
    active_count: int = 0
    residual: float = 0.0


def _divergence(comps, new):
    """In-loop NaN/Inf sentinel: NaN anywhere; ±Inf only for sum/prod or
    epilogue components (±Inf is the legitimate ⊥ of min/max).  Reduces
    over the last axis: a 0-d flag for [n] states, one per query slot for
    a batch's [S, n]."""
    bad = torch.zeros(new[0].shape[:-1], dtype=torch.bool,
                      device=new[0].device)
    for i, cr in enumerate(comps):
        if not cr.dtype.is_floating_point:
            continue
        bad = bad | torch.isnan(new[i]).any(dim=-1)
        if cr.op in ("sum", "prod") or cr.e_fn is not None:
            bad = bad | torch.isinf(new[i]).any(dim=-1)
    return bad


def _residual(comps, new, old):
    """Max |new − old| over float components, non-finite diffs masked;
    per query slot for a batch's [S, n] states, as ``_divergence``."""
    r = torch.zeros(new[0].shape[:-1], dtype=torch.float32,
                    device=new[0].device)
    for i, cr in enumerate(comps):
        if not cr.dtype.is_floating_point:
            continue
        d = (new[i] - old[i]).abs()
        d = torch.where(torch.isfinite(d), d, 0.0)
        if d.shape[-1]:
            r = torch.maximum(r, d.amax(dim=-1))
    return r


def check_shard_replication(counts, what: str, engine: str) -> None:
    """Replication contract of the sharded engines: every shard runs the
    same fixpoint (iteration count, direction sequence), so every shard
    must report the identical value.  On divergence, report the per-shard
    values and the offending shard ids (the minority) instead of a bare
    mismatch."""
    counts = np.asarray(counts)
    if counts.size == 0 or (counts == counts.flat[0]).all():
        return
    vals, freq = np.unique(counts, return_counts=True)
    majority = vals[int(freq.argmax())]
    offenders = np.flatnonzero(counts != majority)
    raise RuntimeError(
        f"{engine} shards diverged on {what}: per-shard {what} = "
        f"{counts.tolist()}; majority value {majority} held by "
        f"{int(freq.max())}/{counts.size} shards, offending shard ids "
        f"{offenders.tolist()} — replicated-state contract broken")


def _init_arity(init_fn) -> int:
    """2 for the source-generic ``init_fn(v, src)``, 1 for legacy closures."""
    try:
        params = inspect.signature(init_fn).parameters.values()
    except (TypeError, ValueError):
        return 1
    n_pos = sum(p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                for p in params)
    return 2 if n_pos >= 2 else 1


def _init_state(comps, n: int, sources: Optional[dict] = None,
                device=None):
    """Initial per-component state (C1/C2): the synthesized I on the source
    vertex, ⊥ everywhere else; sourceless components initialize every
    vertex.  ``sources`` overrides ``cr.source`` per component index."""
    v = torch.arange(n, dtype=torch.int32, device=device)
    state = []
    for cr in comps:
        src = cr.source
        if sources is not None and cr.source is not None:
            src = sources.get(cr.idx, cr.source)
        if _init_arity(cr.init_fn) >= 2:
            vals = cr.init_fn(v, src)
        else:
            vals = cr.init_fn(v)
        vals = torch.as_tensor(vals, device=device).to(cr.dtype)
        vals = vals.broadcast_to((n,))
        if cr.source is not None:
            vals = torch.where(v == int(src), vals, _ident(cr))
        state.append(vals.contiguous())
    return tuple(state)


def _edge_env(src, dst, w, c, out_deg, n, wdeg=None):
    src_l = src.long()
    env = {"w": w, "c": c, "esrc": src, "edst": dst,
           "outdeg": out_deg.clamp(min=1).to(torch.float32)[src_l],
           "nv": torch.tensor(float(n), dtype=torch.float32,
                              device=src.device)}
    env["wdeg"] = torch.ones_like(env["outdeg"]) if wdeg is None \
        else wdeg[src_l]
    return env


def cast_like(p, dtype, like):
    """P's (or E's) value cast to the state dtype (float → int32 truncates
    toward zero, as JAX's convert does) and broadcast to ``like``."""
    return torch.as_tensor(p, device=like.device).to(dtype) \
        .broadcast_to(like.shape)


def _propagate(comps, state_d, src, env):
    """P'(n, e): synthesized P wrapped with the ⊥ guard (condition C3)."""
    evals = {}
    src_l = src.long()
    for cr in comps:
        nvals = state_d[cr.idx][src_l]
        p = cast_like(cr.p_fn({"n": nvals, **env}), cr.dtype, nvals)
        evals[cr.idx] = torch.where(nvals == _ident(cr), _ident(cr), p)
    return evals


def _changed(comps, new, old, tol):
    ch = torch.zeros(new[0].shape, dtype=torch.bool, device=new[0].device)
    for i, cr in enumerate(comps):
        if tol > 0 and cr.dtype.is_floating_point:
            ch = ch | ((new[i] - old[i]).abs() > tol)
        else:
            ch = ch | (new[i] != old[i])
    return ch


def _apply_epilogue(comps, red: dict) -> dict:
    out = dict(red)
    for cr in comps:
        if cr.e_fn is not None:
            out[cr.idx] = cast_like(cr.e_fn({"n": red[cr.idx]}), cr.dtype,
                              red[cr.idx])
    return out


def _has_pred(comps, state_d, src, dst, n) -> dict:
    out = {}
    src_l = src.long()
    for cr in comps:
        nonbot = (state_d[cr.idx][src_l] != _ident(cr)).to(torch.int32)
        out[cr.idx] = segment.segment_reduce("max", nonbot, dst, n) > 0
    return out


def _finish(comps, state, active, k, work, div, resid) -> IterationResult:
    active_n = int(active.sum())
    diverged = bool(div)
    return IterationResult(
        state=tuple(state), iterations=int(k), edge_work=int(work),
        converged=(not diverged) and active_n == 0, diverged=diverged,
        active_count=active_n, residual=float(resid))


def _pull_plus(plans, comps_by_idx, state_d, evals, dst, eactive) -> dict:
    """pull+ update: the frontier's edge values segment-reduced per
    destination, merged with the previous state."""
    n = state_d[plans[0].comp].shape[0]
    masked = {i: torch.where(eactive, evals[i], _ident(comps_by_idx[i]))
              for i in evals}
    red = {}
    for p in plans:
        red.update(plan_segment_reduce(p, masked, dst, n, comps_by_idx))
    new_d = {}
    for p in plans:
        new_d.update(plan_merge(p, state_d, red, comps_by_idx))
    return new_d


def _push_plus(plans, comps_by_idx, state_d, evals, dst, eactive) -> dict:
    """push+ update: the frontier's edge values scattered onto the previous
    state."""
    n = state_d[plans[0].comp].shape[0]
    keep = torch.ones(n, dtype=torch.bool, device=eactive.device)
    new_d = {}
    for p in plans:
        new_d.update(plan_scatter_reduce(p, state_d, evals, dst, eactive,
                                         keep, comps_by_idx))
    return new_d


# ---------------------------------------------------------------------------
# pull / push engines.
# ---------------------------------------------------------------------------

def iterate_graph(g: Graph, comps, plans, model: str = "pull+",
                  max_iter: Optional[int] = None, tol: float = 0.0,
                  sources: Optional[dict] = None) -> IterationResult:
    """Run the fused reduction to fixpoint on the graph's device.
    ``plans`` = [leaf.plan, ...]; ``sources`` optionally overrides
    per-component query sources."""
    n = g.n
    dev = g.device
    max_iter = max_iter if max_iter is not None else 2 * n + 4
    idempotent = all(plan_idempotent(p) for p in plans)
    if model in ("pull+", "push+") and not idempotent:
        model = {"pull+": "pull-", "push+": "push-"}[model]
    comps_by_idx = {cr.idx: cr for cr in comps}

    eo = g.by_dst if model.startswith("pull") else g.by_src
    src, dst = eo.src, eo.dst
    src_l = src.long()
    env = _edge_env(src, dst, eo.weight, eo.capacity, g.out_deg, n,
                    wdeg=structure_w_out_deg(g))
    all_e = torch.ones(src.shape, dtype=torch.bool, device=dev)

    state = _init_state(comps, n, sources, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    k = 0
    work = torch.zeros((), dtype=torch.int64, device=dev)
    div = torch.zeros((), dtype=torch.bool, device=dev)
    resid = torch.zeros((), dtype=torch.float32, device=dev)
    while k < max_iter and bool(active.any()):
        state_d = {cr.idx: state[i] for i, cr in enumerate(comps)}
        evals = _propagate(comps, state_d, src, env)
        if model in ("pull+", "push+"):
            eactive = active[src_l]
            work = work + eactive.sum()
            step = _pull_plus if model == "pull+" else _push_plus
            new_d = step(plans, comps_by_idx, state_d, evals, dst, eactive)
        else:
            work = work + src.shape[0]
            red = {}
            if model == "pull-":
                for p in plans:
                    red.update(plan_segment_reduce(p, evals, dst, n,
                                                   comps_by_idx))
            else:
                ident = {cr.idx: torch.full((n,), _ident(cr), dtype=cr.dtype,
                                            device=dev) for cr in comps}
                keep = torch.zeros(n, dtype=torch.bool, device=dev)
                for p in plans:
                    red.update(plan_scatter_reduce(
                        p, ident, evals, dst, all_e, keep, comps_by_idx))
            red = _apply_epilogue(comps, red)
            has_pred = _has_pred(comps, state_d, src, dst, n)
            new_d = _recompute_merge(plans, comps_by_idx, state_d, red,
                                     has_pred)
        new = tuple(new_d[cr.idx] for cr in comps)
        ch = _changed(comps, new, state, tol)
        div = div | _divergence(comps, new)
        resid = _residual(comps, new, state)
        active = ch & ~div
        state = new
        k += 1
    return _finish(comps, state, active, k, work, div, resid)


# ---------------------------------------------------------------------------
# adaptive engine (Gemini): per-iteration push/pull direction switch.
# ---------------------------------------------------------------------------

def iterate_adaptive(g: Graph, comps, plans, max_iter: Optional[int] = None,
                     tol: float = 0.0, dense_threshold: float = 0.05,
                     sources: Optional[dict] = None) -> IterationResult:
    """Gemini's per-iteration direction switch: a dense frontier (active
    fraction > ``dense_threshold``) takes the pull+ segment reduce over
    ``g.by_dst``, a sparse one the push+ frontier-masked scatter over
    ``g.by_src``.  Idempotent plans only; other rounds run pull−.

    The fraction is the reference's float32 mean of the active mask, held
    against the float32 threshold, so the switch flips on the same
    iteration.  ``edge_work`` adds Σ out_deg over the frontier each
    iteration, in int64 (the reference accumulates it in float32, exact
    only below 2²⁴).  The result carries ``pull_iters``."""
    n = g.n
    max_iter = max_iter if max_iter is not None else 2 * n + 4
    if not all(plan_idempotent(p) for p in plans):
        return iterate_graph(g, comps, plans, model="pull-",
                             max_iter=max_iter, tol=tol, sources=sources)
    dev = g.device
    comps_by_idx = {cr.idx: cr for cr in comps}
    wdeg = structure_w_out_deg(g)
    sides = {}
    for pull, eo, step in ((True, g.by_dst, _pull_plus),
                           (False, g.by_src, _push_plus)):
        env = _edge_env(eo.src, eo.dst, eo.weight, eo.capacity, g.out_deg,
                        n, wdeg=wdeg)
        sides[pull] = (eo, env, step)
    out_deg = g.out_deg.to(torch.int64)
    threshold = np.float32(dense_threshold)

    state = _init_state(comps, n, sources, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    k = pulls = 0
    work = torch.zeros((), dtype=torch.int64, device=dev)
    div = torch.zeros((), dtype=torch.bool, device=dev)
    resid = torch.zeros((), dtype=torch.float32, device=dev)
    while k < max_iter:
        n_act = int(active.sum())
        if n_act == 0:
            break
        use_pull = bool(np.float32(n_act) / np.float32(n) > threshold)
        eo, env, step = sides[use_pull]
        state_d = {cr.idx: state[i] for i, cr in enumerate(comps)}
        evals = _propagate(comps, state_d, eo.src, env)
        new_d = step(plans, comps_by_idx, state_d, evals, eo.dst,
                     active[eo.src.long()])
        work = work + (active * out_deg).sum()
        new = tuple(new_d[cr.idx] for cr in comps)
        ch = _changed(comps, new, state, tol)
        div = div | _divergence(comps, new)
        resid = _residual(comps, new, state)
        active = ch & ~div
        state = new
        k += 1
        pulls += use_pull
    res = _finish(comps, state, active, k, work, div, resid)
    res.pull_iters = pulls
    return res


# ---------------------------------------------------------------------------
# dense engine (GridGraph analogue): reductions over [n, n] edge matrices.
# ---------------------------------------------------------------------------

# or/and reduce as max/min, as in the reference
_DENSE_RED = {"min": torch.amin, "max": torch.amax, "sum": torch.sum,
              "prod": torch.prod, "or": torch.amax, "and": torch.amin}


def _dense_reduce(plan, mats: dict, comps_by_idx) -> dict:
    """Column reduction of the per-edge value matrices (pull side), the
    secondaries of a lex plan over the primary's tied edges."""
    c = plan.comp
    prim = _DENSE_RED[plan.op](mats[c], dim=0).to(mats[c].dtype)
    if isinstance(plan, Prim):
        return {c: prim}
    tie = mats[c] == prim[None, :]
    masked = dict(mats)
    for j in _plan_comps(plan.secondary):
        masked[j] = torch.where(tie, mats[j], _ident(comps_by_idx[j]))
    return {c: prim, **_dense_reduce(plan.secondary, masked, comps_by_idx)}


def iterate_dense(g: Graph, comps, plans, max_iter: Optional[int] = None,
                  tol: float = 0.0,
                  sources: Optional[dict] = None) -> IterationResult:
    """Reference engine on dense ``[n, n]`` adjacency, weight and capacity
    matrices built on the graph's device (small graphs only: each matrix
    holds n² entries).  The per-vertex inputs of P (source and destination
    ids, degrees) are expanded views, never copies; non-idempotent rounds
    take the recompute merge with a dense has-pred."""
    n = g.n
    dev = g.device
    max_iter = max_iter if max_iter is not None else 2 * n + 4
    eo = g.by_src
    src_l, dst_l = eo.src.long(), eo.dst.long()
    adj = torch.zeros((n, n), dtype=torch.bool, device=dev)
    wm = torch.zeros((n, n), dtype=torch.float32, device=dev)
    cm = torch.zeros((n, n), dtype=torch.float32, device=dev)
    adj[src_l, dst_l] = True
    wm[src_l, dst_l] = eo.weight
    cm[src_l, dst_l] = eo.capacity
    comps_by_idx = {cr.idx: cr for cr in comps}
    idempotent = all(plan_idempotent(p) for p in plans)
    vs = torch.arange(n, dtype=torch.int32, device=dev)
    env = {"w": wm, "c": cm,
           "esrc": vs[:, None].expand(n, n),
           "edst": vs[None, :].expand(n, n),
           "outdeg": g.out_deg.clamp(min=1).to(torch.float32)[:, None]
           .expand(n, n),
           "wdeg": structure_w_out_deg(g)[:, None].expand(n, n),
           "nv": torch.tensor(float(n), dtype=torch.float32, device=dev)}

    state = _init_state(comps, n, sources, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    k = work = 0
    div = torch.zeros((), dtype=torch.bool, device=dev)
    resid = torch.zeros((), dtype=torch.float32, device=dev)
    while k < max_iter and bool(active.any()):
        state_d = {cr.idx: state[i] for i, cr in enumerate(comps)}
        work += g.num_edges
        mats = {}
        for cr in comps:
            s = state_d[cr.idx]
            nmat = s[:, None].expand(n, n)
            p = cast_like(cr.p_fn({"n": nmat, **env}), cr.dtype, nmat)
            live = adj & (s != _ident(cr))[:, None]
            mats[cr.idx] = torch.where(live, p, _ident(cr))
        red = {}
        for pl in plans:
            red.update(_dense_reduce(pl, mats, comps_by_idx))
        del mats
        red = _apply_epilogue(comps, red)
        if idempotent:
            new_d = {}
            for pl in plans:
                new_d.update(plan_merge(pl, state_d, red, comps_by_idx))
        else:
            has_pred = {cr.idx: (adj & (state_d[cr.idx] != _ident(cr))
                                 [:, None]).any(dim=0) for cr in comps}
            new_d = _recompute_merge(plans, comps_by_idx, state_d, red,
                                     has_pred)
        new = tuple(new_d[cr.idx] for cr in comps)
        ch = _changed(comps, new, state, tol)
        div = div | _divergence(comps, new)
        resid = _residual(comps, new, state)
        active = ch & ~div
        state = new
        k += 1
    return _finish(comps, state, active, k, work, div, resid)


# ---------------------------------------------------------------------------
# distributed engine: PowerGraph-style vertex-cut over a ShardMesh.
# ---------------------------------------------------------------------------

def _cross_plan(plan, red: dict, mesh, comps_by_idx) -> dict:
    """Cross-shard lexicographic fold of one plan: ``red[c]`` lists the k
    per-shard partials of component c; the primary folds across shards,
    each shard's secondaries are masked to the identity where its primary
    is not the global best, and the secondary plan folds those.  Returns
    {c: the folded value on each shard's device}."""
    best = segment.psum_like(plan.op, red[plan.comp], mesh)
    out = {plan.comp: best}
    if isinstance(plan, Lex):
        masked = {c: [torch.where(r == b, x, _ident(comps_by_idx[c]))
                      for r, b, x in zip(red[plan.comp], best, red[c])]
                  for c in _plan_comps(plan.secondary)}
        out.update(_cross_plan(plan.secondary, masked, mesh, comps_by_idx))
    return out


def cross_shard(plans, red: dict, mesh, comps_by_idx) -> dict:
    """The sharded engines' combine of per-shard partial reductions (``red``:
    {component: [k partials]}) over every plan, one ``segment.psum_like``
    per lex level: {component: [the folded value on each shard's
    device]}."""
    out = dict(red)
    for p in plans:
        out.update(_cross_plan(p, red, mesh, comps_by_idx))
    return out


def iterate_distributed(g: Graph, comps, plans, mesh, axes=("data",),
                        model: str = "pull+",
                        max_iter: Optional[int] = None, tol: float = 0.0,
                        sources: Optional[dict] = None) -> IterationResult:
    """Edge-partitioned fused reduction over the shards of ``mesh`` (a
    ``partition.ShardMesh``): the port of the reference's vertex cut over
    plain segment ops.  Shard j holds the j-th ``partition_edges`` block
    (contiguous) on ``mesh.devices[j]`` and each iteration does its masked
    segment reduce (Gather + Apply); the partials fold across shards in
    shard order (``cross_shard``, Scatter), then ``plan_merge`` (pull+) or
    the pull− epilogue with the has-pred folded by ``or``, on
    ``mesh.devices[0]``, where the state lives.  The result carries
    ``shards`` and ``shard_work`` (each shard's edge work, int; their sum
    is ``edge_work``)."""
    k_shards = mesh_shards(mesh, axes)
    devs = mesh.devices
    n = g.n
    part = partition_edges(g, k_shards)
    max_iter = max_iter if max_iter is not None else 2 * n + 4
    if model == "pull+" and not all(plan_idempotent(p) for p in plans):
        model = "pull-"
    comps_by_idx = {cr.idx: cr for cr in comps}
    wdeg = structure_w_out_deg(g)
    shards = []
    for j, d in enumerate(devs):
        src, dst = part.src[j].to(d), part.dst[j].to(d)
        env = _edge_env(src, dst, part.weight[j].to(d),
                        part.capacity[j].to(d), g.out_deg.to(d), n,
                        wdeg=wdeg.to(d))
        shards.append((d, src, dst, part.mask[j].to(d), env))

    state = _init_state(comps, n, sources, device=devs[0])
    active = torch.ones(n, dtype=torch.bool, device=devs[0])
    k = 0
    work = [torch.zeros((), dtype=torch.int64, device=d) for d in devs]
    reduces = [0] * k_shards
    div = torch.zeros((), dtype=torch.bool, device=devs[0])
    resid = torch.zeros((), dtype=torch.float32, device=devs[0])
    while k < max_iter and bool(active.any()):
        state_d = {cr.idx: state[i] for i, cr in enumerate(comps)}
        reds, nonbot = {}, {}
        for j, (d, src, dst, mask, env) in enumerate(shards):
            st = {c: v.to(d) for c, v in state_d.items()}
            src_l = src.long()
            evals = _propagate(comps, st, src, env)
            eactive = (active.to(d)[src_l] & mask) if model == "pull+" \
                else mask
            work[j] = work[j] + eactive.sum()
            masked = {i: torch.where(eactive, evals[i],
                                     _ident(comps_by_idx[i]))
                      for i in evals}
            for p in plans:
                for c, v in plan_segment_reduce(p, masked, dst, n,
                                                comps_by_idx).items():
                    reds.setdefault(c, []).append(v)
            if model != "pull+":
                for cr in comps:
                    nonbot.setdefault(cr.idx, []).append(
                        segment.segment_reduce(
                            "or", (st[cr.idx][src_l] != _ident(cr)) & mask,
                            dst, n))
            reduces[j] += 1
        red = {c: v[0] for c, v in
               cross_shard(plans, reds, mesh, comps_by_idx).items()}
        if model == "pull+":
            new_d = {}
            for p in plans:
                new_d.update(plan_merge(p, state_d, red, comps_by_idx))
        else:
            red = _apply_epilogue(comps, red)
            has_pred = {c: segment.psum_like("or", v, mesh)[0]
                        for c, v in nonbot.items()}
            new_d = _recompute_merge(plans, comps_by_idx, state_d, red,
                                     has_pred)
        new = tuple(new_d[cr.idx] for cr in comps)
        ch = _changed(comps, new, state, tol)
        div = div | _divergence(comps, new)
        resid = _residual(comps, new, state)
        active = ch & ~div
        state = new
        k += 1
    check_shard_replication(reduces, "iteration count", "distributed")
    work_h = torch.stack([w.to(devs[0]) for w in work]).tolist()
    res = _finish(comps, tuple(s.to(g.device) for s in state), active, k,
                  sum(work_h), div, resid)
    res.shards = k_shards
    res.shard_work = tuple(work_h)
    return res
