"""Triple-let executor: iteration → map → reduce (paper §5).

The port's counterpart of ``repro.core.engine``: runs a ``FusedProgram``
(``fusion.fuse``) or a ``DirectKernels`` set on a graph under one of

  pull | push   the reference engines of ``core.iterate`` (segment ops)
  adaptive      Gemini's per-iteration pull/push switch on segment ops
  dense         reductions over [n, n] edge matrices (small graphs)
  cuda          the direction-optimized blocked-ELL engine whose every
                iteration launches the hand-written pull kernel, or the push
                kernel followed by the sorted-resolution kernel
                (``kernels.ops.iterate_cuda``; ``model`` forces "pull" /
                "push", the default picks per iteration)

``fallback=True`` degrades an infrastructure failure down
``guard.FALLBACK_CHAIN`` (cuda → adaptive) after a bounded same-engine
retry (``ft_config`` sets the budget), recording each step in
``ExecStats.fallbacks``.  A kernel's build or launch fault, a CUDA runtime
error and every guard verdict propagate instead (``guard.recoverable``).

Entry points take ``device=None``, which means the CUDA card: without one
they raise ``RuntimeError`` unless the caller passes ``device="cpu"``, and
the graph must live on that device.  On the CPU the cuda engine runs the
plain PyTorch versions of its kernels.

The fused ilet runs as an iterative path reduction, the mlet as a
vectorized per-vertex map, the rlet as masked reductions over the vertex
dimension; ⊥ values are excluded from vertex reductions per C6.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import torch

from repro_torch.core import conditions as _conditions
from repro_torch.core import guard, iterate
from repro_torch.core import plan as _plan
from repro_torch.core.fusion import FusedProgram, FusedRound, plan_output
from repro_torch.core.kernel_lang import eval_expr
from repro_torch.core.plan import ExecutionPlan, plan_execution
from repro_torch.core.synthesis import DirectKernels, synthesize_round
from repro_torch.graph.structure import resolve_device

_BOT_CUTOFF = 1e8

# Keyword arguments of the reference entry points that belong to later
# slices of the port; passing one with a non-default value raises.
_LATER = {
    "delta": "incremental fixpoints (ROADMAP Queue 1, item 9)",
    "mesh": "the sharded engines (ROADMAP Queue 1, item 11)",
    "axes": "the sharded engines (ROADMAP Queue 1, item 11)",
    "shard_strategy": "the sharded engines (ROADMAP Queue 1, item 11)",
    "sources": "batched queries (ROADMAP Queue 1, item 7)",
}
_LATER_DEFAULTS = {"axes": ("data",)}

# The same-engine retry budget of the fallback chain when no ``ft_config``
# is given: the reference's constants, kept for parity, so they differ from
# ``FTConfig``'s defaults (3 retries, 0.05 s) as the reference's do.
_FALLBACK_RETRIES = 1
_FALLBACK_BACKOFF_S = 0.01


def _reject_later(kwargs: dict) -> None:
    for name, val in kwargs.items():
        if name not in _LATER:
            raise TypeError(f"unexpected keyword argument {name!r}")
        if val is not None and val != _LATER_DEFAULTS.get(name):
            raise NotImplementedError(
                f"{name}= is not ported yet: it comes with {_LATER[name]}")


def clear_program_caches():
    """Drop every layer of the program cache: synthesized round kernels,
    layouts, plans and the per-round sweep shapes."""
    from repro_torch.core import synthesis
    from repro_torch.graph import structure
    from repro_torch.kernels import ops as kops
    synthesis._ROUND_CACHE.clear()
    for cache in (structure._ELL_CACHE, structure._RES_CACHE,
                  structure._WDEG_CACHE, structure._VALID_CACHE,
                  structure._STATS_CACHE):
        cache.clear()
    _plan.clear_plan_caches()
    kops.clear_executor_cache()


def clear_graph_caches(g) -> int:
    """Drop ONE graph's derived layouts, degrees, validation summary, plans
    and feedback; returns the number of entries dropped."""
    from repro_torch.graph import structure
    return structure.clear_graph_caches(g) + _plan.clear_graph_plans(g)


def program_cache_stats() -> dict:
    from repro_torch.core import synthesis
    from repro_torch.graph import structure
    from repro_torch.kernels import ops as kops
    return {"synth_rounds": len(synthesis._ROUND_CACHE),
            "ell_layouts": len(structure._ELL_CACHE),
            "push_resolutions": len(structure._RES_CACHE),
            "graph_stats": len(structure._STATS_CACHE),
            "plans": _plan.plan_cache_size(),
            "feedback": _plan.feedback_cache_size(),
            "cuda_rounds": kops.executor_cache_size()}


@dataclasses.dataclass
class ExecStats:
    rounds: int = 0
    iterations: int = 0
    edge_work: int = 0
    synth_ms: float = 0.0
    push_iters: int = 0
    pull_iters: int = 0
    resolve_work: int = 0           # Σ resolution-tile nnz (sorted), full
                                    # rectangle (scatter), 0 on pull
    gather_work: int = 0            # candidate slots the resolve kernel read
    engine_used: str = ""
    converged: bool = True
    fallbacks: tuple = ()
    exec_retries: int = 0
    plan: object = None


@dataclasses.dataclass
class ExecResult:
    value: object
    named: dict
    stats: ExecStats


def _valid_mask(x):
    xf = x.to(torch.float32)
    return torch.isfinite(xf) & (xf.abs() < _BOT_CUTOFF)


def _vertex_reduce(op: str, vals, mask):
    vals = vals.to(torch.float32)
    if op == "collect":
        return mask
    ident = {"min": float("inf"), "max": float("-inf"), "sum": 0.0,
             "prod": 1.0}[op]
    masked = torch.where(mask, vals, ident)
    return {"min": torch.amin, "max": torch.amax, "sum": torch.sum,
            "prod": torch.prod}[op](masked)


def _source_overrides(round_, source) -> Optional[dict]:
    if source is None:
        return None
    return {comp.idx: int(source) for comp in round_.components
            if comp.source is not None}


def _synthesize_timed(round_):
    t0 = time.perf_counter()
    synth = synthesize_round(round_)
    return synth, (time.perf_counter() - t0) * 1e3


def _round_runtime(round_, synth):
    comps = iterate.comp_runtimes(round_, synth)
    plans = [leaf.plan for leaf in round_.leaves]
    return comps, plans


def _prepare(g, device):
    dev = resolve_device(device)
    if g.device != dev:
        raise ValueError(f"the graph lives on {g.device}, the query asked "
                         f"for {dev}; build the graph with device={dev}")
    return dev


def _validate_inputs(g, source=None):
    from repro_torch.graph import structure
    chk = structure.validate_graph(g)
    if source is not None and not 0 <= int(source) < g.n:
        raise guard.GraphValidationError(
            f"query source {int(source)} out of range [0, {g.n})")
    return chk


def _check_preconditions(chk, comps, plans):
    """Raise ``TerminationPreconditionError`` when the graph's edge-value
    ranges void the spec's synthesis-time termination proof."""
    if chk is None:
        return
    bad = _conditions.violated_preconditions(
        comps, plans, (chk.w_min, chk.w_max), (chk.c_min, chk.c_max))
    if bad:
        v = bad[0]
        raise guard.TerminationPreconditionError(
            f"termination precondition {v['condition']} violated for "
            f"component {v['component']} (op {v['op']}) on this graph "
            f"(w ∈ [{chk.w_min}, {chk.w_max}], c ∈ [{chk.c_min}, "
            f"{chk.c_max}]): {v['detail']} — the fixpoint may not "
            "terminate; fix the graph or run with validate=False",
            condition=v["condition"], component=v["component"],
            detail=v["detail"])


def _check_outcome(res, max_iter_eff, on_nonconverge):
    if on_nonconverge == "ignore":
        return
    if res.diverged:
        raise guard.DivergenceError(
            f"fixpoint diverged after {res.iterations} iterations: the "
            "NaN/Inf sentinel fired (values left the monoid's meaningful "
            "domain)", iterations=int(res.iterations))
    if not res.converged:
        msg = (f"fixpoint exhausted max_iter={max_iter_eff} without "
               f"converging: {res.active_count} vertices still active after "
               f"{res.iterations} iterations, last-iteration residual "
               f"{res.residual:.3e}")
        if on_nonconverge == "warn":
            warnings.warn(msg, RuntimeWarning, stacklevel=3)
            return
        raise guard.NonConvergenceError(
            msg, iterations=int(res.iterations), max_iter=int(max_iter_eff),
            active_count=res.active_count, residual=res.residual)


def _run(engine: str, plan: ExecutionPlan, g, comps, plans, max_iter, tol,
         sources, warm: dict):
    """One iteration round on ``engine``, which differs from ``plan.engine``
    only while walking the fallback chain; the engine-dependent plan fields
    then re-resolve (``degrade_plan``).  ``warm`` holds the warm-start and
    checkpoint arguments, which only the cuda engine reads: as in the
    reference, a query degraded to another engine runs cold."""
    plan = _plan.degrade_plan(plan, engine)
    if engine in ("pull", "push"):
        idempotent = all(iterate.plan_idempotent(p) for p in plans)
        model = plan.model or (engine + ("+" if idempotent else "-"))
        return iterate.iterate_graph(g, comps, plans, model=model,
                                     max_iter=max_iter, tol=tol,
                                     sources=sources)
    if engine == "adaptive":
        # As in the reference, without the plan's dense_threshold: the
        # engine switches at its default 0.05 whatever the hint.
        return iterate.iterate_adaptive(g, comps, plans, max_iter=max_iter,
                                        tol=tol, sources=sources)
    if engine == "dense":
        return iterate.iterate_dense(g, comps, plans, max_iter=max_iter,
                                     tol=tol, sources=sources)
    if engine == "cuda":
        from repro_torch.kernels import ops as kops
        return kops.iterate_cuda(g, comps, plans, max_iter=max_iter, tol=tol,
                                 sources=sources, plan=plan, **warm)
    raise ValueError(f"unknown engine {engine}")


def _dispatch_guarded(call, engine, fallback, ft_config):
    """Run ``call(engine)``; on an infrastructure-shaped failure
    (``guard.recoverable``) retry the SAME engine with a bounded budget,
    then degrade one step down ``guard.FALLBACK_CHAIN`` and repeat.  Guard
    verdicts, programming errors and kernel faults propagate unchanged.
    Returns ``(result, engine_used, fallback_events, retries_used)``."""
    if not fallback:
        return call(engine), engine, (), 0
    from repro_torch.runtime import ft as _ft
    retries = _FALLBACK_RETRIES if ft_config is None else ft_config.max_retries
    backoff = _FALLBACK_BACKOFF_S if ft_config is None else ft_config.backoff_s
    eng = engine
    events = []
    retries_used = 0
    while True:
        try:
            out, r = _ft.bounded_retry(lambda: call(eng), retries, backoff,
                                       retryable=guard.recoverable)
            return out, eng, tuple(events), retries_used + r
        except Exception as exc:
            retries_used += retries
            if not guard.recoverable(exc):
                raise
            nxt = guard.FALLBACK_CHAIN.get(eng)
            if nxt is None:
                raise
            events.append(guard.FallbackEvent(eng, nxt,
                                              f"{type(exc).__name__}: {exc}"))
            eng = nxt


def _finish_round(g, round_: FusedRound, env: dict):
    """mlet + rlet + the round's output expression over an env already
    holding the leaf results."""
    for name, expr in round_.maps:
        env[name] = eval_expr(expr, env, torch)
    for name, op, m_name, cond_name in round_.vreduces:
        vals = torch.as_tensor(env[m_name], device=g.device)
        vals = vals.broadcast_to((g.n,)) if vals.ndim == 0 else vals
        mask = _valid_mask(vals)
        if cond_name is not None:
            cond = torch.as_tensor(env[cond_name], device=g.device)
            mask = mask & cond.to(torch.bool).broadcast_to((g.n,))
        env[name] = _vertex_reduce(op, vals, mask)
    if getattr(round_, "multi_out", None):
        return {key: eval_expr(e, env, torch) for key, e in round_.multi_out}
    return eval_expr(round_.out, env, torch)


def _accumulate(stats: ExecStats, res, synth_ms: float) -> None:
    stats.rounds += 1
    stats.iterations += res.iterations
    stats.edge_work += res.edge_work
    stats.synth_ms += synth_ms
    stats.converged = stats.converged and bool(res.converged)
    stats.push_iters += getattr(res, "push_iters", 0)
    stats.pull_iters += getattr(res, "pull_iters", 0)
    stats.resolve_work += getattr(res, "resolve_work", 0)
    stats.gather_work += getattr(res, "gather_work", 0)


def run_program(g, prog: FusedProgram, engine: Optional[str] = None,
                model: Optional[str] = None,
                max_iter: Optional[int] = None, tol: float = 0.0,
                source: Optional[int] = None,
                push_resolution: Optional[str] = None,
                switch_k="auto",
                validate: bool = True,
                on_nonconverge: str = "raise",
                fallback: bool = False, ft_config=None,
                divergence_sentinel: bool = True,
                checkpoint_every: Optional[int] = None,
                ckpt_dir=None, resume: bool = False,
                init_state=None, return_state: bool = False,
                adaptive: bool = False,
                plan: Optional[ExecutionPlan] = None,
                explain: bool = False,
                device=None, **later):
    """Execute a fused program.  ``source`` re-sources every sourced
    component to one query source.

    Every knob kwarg is a hint to the query planner (``core.plan``):
    ``engine`` (None → "pull", "auto" → "cuda"), ``model`` (cuda engine:
    "pull"/"push" pins the sweep direction), ``switch_k``,
    ``push_resolution``; the resolved plan lands in ``stats.plan`` and
    ``explain=True`` returns the ``PlanExplanation`` without executing.

    Guarded execution: ``validate`` checks the graph's structural contract,
    the source's range and the termination preconditions before any kernel
    launches; ``on_nonconverge`` ("raise"/"warn"/"ignore") governs a round
    that exhausts ``max_iter`` or trips the divergence sentinel;
    ``fallback=True`` degrades an infrastructure failure down the fallback
    chain (cuda → adaptive) with bounded retry (``ft_config`` tunes the
    budget), recording each event in the stats.

    Chunked fixpoints (cuda engine, ``kernels.ops.iterate_cuda``):
    ``checkpoint_every`` / ``ckpt_dir`` / ``resume`` snapshot the loop
    carry every ``checkpoint_every`` iterations and resume from the newest
    snapshot; ``init_state`` (per-component [n] tensors or arrays)
    warm-starts the round.  ``return_state=True`` returns ``(result,
    state)``, ``state`` the round's final per-component [n] tensors on the
    graph's device, to feed back as the next query's ``init_state``.  The
    warm hooks need a single-round program; with ``init_state`` or
    ``return_state`` the default engine is cuda.  A query that falls back
    to adaptive runs cold."""
    _reject_later(later)
    _prepare(g, device)
    if plan is None or explain:
        planned = plan_execution(
            g, prog, engine=engine, model=model, switch_k=switch_k,
            push_resolution=push_resolution, validate=validate,
            on_nonconverge=on_nonconverge, fallback=fallback,
            divergence_sentinel=divergence_sentinel, adaptive=adaptive,
            default_engine="cuda" if (init_state is not None
                                      or return_state) else "pull",
            explain=explain)
        if explain:
            return planned
        plan = planned
    if (checkpoint_every is not None or resume) and plan.engine != "cuda":
        raise ValueError("checkpointed fixpoints are a cuda-engine feature; "
                         f"got engine={plan.engine!r}")
    if init_state is not None or return_state:
        if plan.engine != "cuda":
            raise ValueError(
                "init_state/return_state warm-start hooks are a cuda-engine "
                f"feature; got engine={plan.engine!r}")
        iter_rounds = [r for _, r in prog.rounds if r.leaves]
        if len(prog.rounds) != 1 or len(iter_rounds) != 1:
            raise ValueError(
                "init_state/return_state need a single-round program (one "
                f"iteration round, no LetRound chain); got "
                f"{len(prog.rounds)} rounds")
    warm = dict(checkpoint_every=checkpoint_every, ckpt_dir=ckpt_dir,
                resume=resume, init_state=init_state)
    chk = _validate_inputs(g, source=source) if plan.validate else None
    max_iter_eff = max_iter if max_iter is not None else 2 * g.n + 4
    stats = ExecStats(engine_used=plan.engine, plan=plan)
    named: dict = {}
    final = None
    state_out = None
    for bind_name, round_ in prog.rounds:
        env: dict = dict(named)
        if round_.leaves:
            synth, synth_ms = _synthesize_timed(round_)
            comps, plans = _round_runtime(round_, synth)
            _check_preconditions(chk, comps, plans)
            src_over = _source_overrides(round_, source)
            res, eng_used, events, retries = _dispatch_guarded(
                lambda eng: _run(eng, plan, g, comps, plans, max_iter, tol,
                                 src_over, warm),
                plan.engine, plan.fallback, ft_config)
            stats.engine_used = eng_used
            stats.fallbacks += tuple(ev.as_tuple() for ev in events)
            stats.exec_retries += retries
            _accumulate(stats, res, synth_ms)
            _check_outcome(res, max_iter_eff, plan.on_nonconverge)
            if return_state:
                state_out = tuple(res.state)
            for leaf in round_.leaves:
                env[leaf.name] = res.state[plan_output(leaf.plan)]
        out = _finish_round(g, round_, env)
        if bind_name is not None:
            prefix = "$vec:" if round_.out_kind == "vertex" else "$scalar:"
            named[prefix + bind_name] = out
        final = out
    _plan.record_feedback(g, plan.kind, stats)
    result = ExecResult(value=final, named=named, stats=stats)
    if return_state:
        return result, state_out
    return result


def run_direct(g, dk: DirectKernels, engine: Optional[str] = None,
               model: Optional[str] = None,
               source: Optional[int] = None,
               push_resolution: Optional[str] = None,
               switch_k="auto",
               validate: bool = True,
               on_nonconverge: str = "raise",
               fallback: bool = False, ft_config=None,
               divergence_sentinel: bool = True,
               checkpoint_every: Optional[int] = None,
               ckpt_dir=None, resume: bool = False,
               init_state=None,
               adaptive: bool = False,
               plan: Optional[ExecutionPlan] = None,
               explain: bool = False,
               device=None, **later):
    """Execute a direct kernel set (PageRank-style, paper Fig. 4b) on one
    engine.  ``model`` pins the cuda engine's sweep direction; by default
    idempotent kernels switch per iteration and the rest run the pull−
    recompute.  The cuda engine needs ``dk.p_expr`` (the kernel is
    generated from it).  ``fallback``, ``ft_config``, ``checkpoint_every``,
    ``ckpt_dir``, ``resume`` and ``init_state`` act as in ``run_program``;
    with ``init_state`` the default engine is cuda."""
    from repro_torch.core.fusion import Prim

    _reject_later(later)
    _prepare(g, device)
    if plan is None or explain:
        planned = plan_execution(
            g, dk, engine=engine, model=model, switch_k=switch_k,
            push_resolution=push_resolution, validate=validate,
            on_nonconverge=on_nonconverge, fallback=fallback,
            divergence_sentinel=divergence_sentinel, adaptive=adaptive,
            default_engine="cuda" if init_state is not None else "pull",
            explain=explain)
        if explain:
            return planned
        plan = planned
    if (checkpoint_every is not None or resume or init_state is not None) \
            and plan.engine != "cuda":
        raise ValueError("checkpointed/warm-started fixpoints are a "
                         f"cuda-engine feature; got engine={plan.engine!r}")
    if source is not None and dk.source is None:
        raise ValueError(
            "run_direct source overrides need a source-generic DirectKernels "
            "(init_fn(v, s) with source=...); this kernel set is sourceless "
            "or bakes its source into the init closure")
    if dk.source is not None and iterate._init_arity(dk.init_fn) < 2:
        raise ValueError(
            "DirectKernels.source requires a source-generic init_fn(v, s)")
    chk = _validate_inputs(g, source=source) if plan.validate else None
    max_iter_eff = dk.max_iter if dk.max_iter is not None else 2 * g.n + 4
    comp = iterate.CompRuntime(
        idx=0, op=dk.rop, dtype=iterate.DTYPES[dk.dtype], p_fn=dk.p_fn,
        init_fn=dk.init_fn, source=dk.source, e_fn=dk.e_fn,
        p_expr=dk.p_expr)
    plans = [Prim(dk.rop, 0)]
    _check_preconditions(chk, [comp], plans)
    src_over = None if source is None else {0: int(source)}
    warm = dict(checkpoint_every=checkpoint_every, ckpt_dir=ckpt_dir,
                resume=resume, init_state=init_state)
    res, eng_used, events, retries = _dispatch_guarded(
        lambda eng: _run(eng, plan, g, [comp], plans, dk.max_iter, dk.tol,
                         src_over, warm),
        plan.engine, plan.fallback, ft_config)
    stats = ExecStats(engine_used=eng_used,
                      fallbacks=tuple(ev.as_tuple() for ev in events),
                      exec_retries=retries, plan=plan)
    _accumulate(stats, res, 0.0)
    _check_outcome(res, max_iter_eff, plan.on_nonconverge)
    _plan.record_feedback(g, plan.kind, stats)
    return ExecResult(value=res.state[0], named={}, stats=stats)
