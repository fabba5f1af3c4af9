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
  cuda_sharded  the same sweeps on each of the k vertex-cut shards of a
                ``partition.ShardMesh``, the partials folded across shards
                and the direction switch kept global
                (``kernels.ops.iterate_cuda_sharded``; needs ``mesh``)
  distributed   the vertex cut over plain segment ops per shard
                (``core.iterate.iterate_distributed``; needs ``mesh``)

``run_program_batch`` and ``run_direct(sources=…)`` serve B queries of
one program or kernel set together: on ``cuda`` one batched fixpoint with
one launch per sweep per iteration for the whole batch
(``kernels.ops.iterate_cuda_batch``), elsewhere B solo queries.
``batchable_program`` and ``batch_init_state`` are the continuous-batching
hooks of a scheduler that carries a batch's state between chunks.

``fallback=True`` degrades an infrastructure failure down
``guard.FALLBACK_CHAIN`` (cuda_sharded → cuda → adaptive) after a bounded
same-engine retry (``ft_config`` sets the budget), recording each step in
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
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import conditions as _conditions
from repro_torch.core import guard, iterate
from repro_torch.core import plan as _plan
from repro_torch.core.fusion import FusedProgram, FusedRound, plan_output
from repro_torch.core.kernel_lang import eval_expr
from repro_torch.core.plan import ExecutionPlan, plan_execution
from repro_torch.core.synthesis import DirectKernels, synthesize_round
from repro_torch.graph.partition import check_mesh
from repro_torch.graph.structure import resolve_device

_BOT_CUTOFF = 1e8

# The same-engine retry budget of the fallback chain when no ``ft_config``
# is given: the reference's constants, kept for parity, so they differ from
# ``FTConfig``'s defaults (3 retries, 0.05 s) as the reference's do.
_FALLBACK_RETRIES = 1
_FALLBACK_BACKOFF_S = 0.01


def clear_program_caches():
    """Drop every layer of the program cache: synthesized round kernels,
    layouts (sharded ones included), mutation slot maps, plans and the
    per-round sweep shapes; and zero ``mutate.MUTATION_STATS``."""
    from repro_torch.core import synthesis
    from repro_torch.graph import mutate, structure
    from repro_torch.kernels import ops as kops
    synthesis._ROUND_CACHE.clear()
    for cache in (structure._ELL_CACHE, structure._SHARDED_ELL_CACHE,
                  structure._RES_CACHE, structure._SHARDED_RES_CACHE,
                  structure._WDEG_CACHE, structure._VALID_CACHE,
                  structure._STATS_CACHE, structure._SLOT_CACHE):
        cache.clear()
    _plan.clear_plan_caches()
    mutate.reset_mutation_stats()
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
            "sharded_layouts": len(structure._SHARDED_ELL_CACHE),
            "push_resolutions": len(structure._RES_CACHE),
            "sharded_resolutions": len(structure._SHARDED_RES_CACHE),
            "graph_stats": len(structure._STATS_CACHE),
            "slot_maps": len(structure._SLOT_CACHE),
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
    shards: int = 0                 # shard count of the sharded engines
    shard_launches: int = 0         # sweeps per shard per iteration,
                                    # summed over rounds (cuda_sharded)
    cross_combines: int = 0         # cross-shard state folds run
                                    # (cuda_sharded)
    shard_work: tuple = ()          # per-shard edge work ([k]; its sum is
                                    # the sharded rounds' edge work)
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


def _prepare(g, device, mesh=None):
    if mesh is not None:
        check_mesh(mesh)
    dev = resolve_device(device)
    if g.device != dev:
        raise ValueError(f"the graph lives on {g.device}, the query asked "
                         f"for {dev}; build the graph with device={dev}")
    return dev


def _validate_inputs(g, source=None, sources=None):
    """Graph structural validation and the range of the query source(s);
    returns the cached ``GraphCheck`` for the precondition probe."""
    from repro_torch.graph import structure
    chk = structure.validate_graph(g)
    probe = [] if source is None else [source]
    if sources is not None:
        probe.extend(np.asarray(sources).ravel().tolist())
    for s in probe:
        if not 0 <= int(s) < g.n:
            raise guard.GraphValidationError(
                f"query source {int(s)} out of range [0, {g.n})")
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


def _require_single_round(prog, what="init_state/return_state") -> None:
    """The warm-start hooks need one iteration round and no LetRound
    chain."""
    iter_rounds = [r for _, r in prog.rounds if r.leaves]
    if len(prog.rounds) != 1 or len(iter_rounds) != 1:
        raise ValueError(
            f"{what} needs a single-round program (one iteration round, no "
            f"LetRound chain); got {len(prog.rounds)} rounds")


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
         sources, warm: dict, mesh=None, direct: bool = False):
    """One iteration round on ``engine``, which differs from ``plan.engine``
    only while walking the fallback chain; the engine-dependent plan fields
    then re-resolve (``degrade_plan``).  ``warm`` holds the warm-start and
    checkpoint arguments, which only the cuda engine reads: as in the
    reference, a query degraded to another engine runs cold.  A delta seed
    over a non-idempotent round warm-starts from the rescaled state
    (``_rescale_warm_state``).  The sharded engines need ``mesh``; on
    ``distributed`` a direct kernel set (``direct``) runs pull−, as the
    reference's ``run_direct`` runs it."""
    plan = _plan.degrade_plan(plan, engine)
    if engine in _plan.SHARDED_ENGINES and mesh is None:
        raise AssertionError(f"{engine} engine needs a mesh")
    if engine == "distributed":
        model = "pull-" if direct else (plan.model or "pull+")
        return iterate.iterate_distributed(g, comps, plans, mesh,
                                           axes=plan.axes, model=model,
                                           max_iter=max_iter, tol=tol,
                                           sources=sources)
    if engine == "cuda_sharded":
        from repro_torch.kernels import ops as kops
        return kops.iterate_cuda_sharded(g, comps, plans, mesh,
                                         axes=plan.axes, max_iter=max_iter,
                                         tol=tol, sources=sources, plan=plan)
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
        if (warm["delta"] is not None and warm["init_state"] is not None
                and not all(iterate.plan_idempotent(p) for p in plans)):
            warm = dict(warm, init_state=_rescale_warm_state(
                warm["init_state"], comps, g))
        return kops.iterate_cuda(g, comps, plans, max_iter=max_iter, tol=tol,
                                 sources=sources, plan=plan, **warm)
    raise ValueError(f"unknown engine {engine}")


def _rescale_warm_state(init_state, comps, g) -> tuple:
    """The guarded warm start of a NON-idempotent round from a previous
    solution: a (−) recompute round re-derives every vertex from its
    neighbourhood each sweep and contracts to its unique attractive
    fixpoint from any finite state, so the warm state needs sanitizing, not
    re-deriving.  For mass-conserving "sum" components (PageRank-style) the
    non-finite entries (values an edit invalidated) take the finite mean
    and the whole is rescaled to the retired answer's total mass; an
    all-finite state passes bitwise untouched.  Host numpy, exactly the
    reference's arithmetic; the result lies on the graph's device."""
    out = []
    for a, cr in zip(init_state, comps):
        arr = (a.detach().cpu().numpy().copy() if isinstance(a, torch.Tensor)
               else np.array(a))
        if cr.op == "sum":
            finite = np.isfinite(arr)
            if not finite.all():
                mass = float(arr[finite].sum()) if finite.any() else 0.0
                fill = mass / max(1, int(finite.sum()))
                arr = np.where(finite, arr, fill).astype(arr.dtype)
                tot = float(arr.sum())
                if np.isfinite(tot) and tot != 0.0 and mass != 0.0:
                    arr = (arr * (mass / tot)).astype(arr.dtype)
        out.append(torch.from_numpy(np.ascontiguousarray(arr))
                   .to(g.device))
    return tuple(out)


def _mutation_hints(delta):
    """``delta=`` as ``(mutation, ids)``: a ``MutationDelta`` (anything with
    ``touched``) feeds the planner and seeds its touched set; raw vertex
    ids are taken as given, with no mutation."""
    if delta is not None and hasattr(delta, "touched"):
        return delta, np.asarray(delta.touched)
    return None, delta


def _check_batch_outcomes(res, src_list, max_iter_eff, on_nonconverge):
    """Per-query convergence outcomes of one batched round (per-slot
    ``converged`` / ``diverged``), naming the offending query sources."""
    if on_nonconverge == "ignore":
        return
    divg = np.asarray(res.diverged)
    conv = np.asarray(res.converged)
    if divg.any():
        bad = [src_list[i] for i in np.flatnonzero(divg)]
        raise guard.DivergenceError(
            f"batched fixpoint diverged for query sources {bad}: the "
            "NaN/Inf sentinel fired",
            iterations=int(np.asarray(res.iterations).max()))
    if not conv.all():
        bad = np.flatnonzero(~conv)
        acts = np.asarray(res.active_count)
        iters = np.asarray(res.iterations)
        msg = (f"batched fixpoint exhausted max_iter={max_iter_eff} for "
               f"query sources {[src_list[i] for i in bad]} "
               f"(active counts {[int(acts[i]) for i in bad]})")
        if on_nonconverge == "warn":
            warnings.warn(msg, RuntimeWarning, stacklevel=3)
            return
        raise guard.NonConvergenceError(
            msg, iterations=int(iters.max()), max_iter=int(max_iter_eff),
            active_count=int(acts[bad].sum()))


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
    stats.shards = max(stats.shards, getattr(res, "shards", 0))
    stats.shard_launches += getattr(res, "shard_launches", 0)
    stats.cross_combines += getattr(res, "cross_combines", 0)
    sw = tuple(getattr(res, "shard_work", ()))
    if sw:
        if len(stats.shard_work) == len(sw):
            stats.shard_work = tuple(a + b
                                     for a, b in zip(stats.shard_work, sw))
        elif not stats.shard_work:
            stats.shard_work = sw
        else:                       # the shard count changed between rounds
            stats.shard_work = stats.shard_work + sw


def run_program(g, prog: FusedProgram, engine: Optional[str] = None,
                model: Optional[str] = None, mesh=None, axes=("data",),
                max_iter: Optional[int] = None, tol: float = 0.0,
                source: Optional[int] = None,
                push_resolution: Optional[str] = None,
                switch_k="auto", shard_strategy: Optional[str] = None,
                validate: bool = True,
                on_nonconverge: str = "raise",
                fallback: bool = False, ft_config=None,
                divergence_sentinel: bool = True,
                checkpoint_every: Optional[int] = None,
                ckpt_dir=None, resume: bool = False,
                init_state=None, delta=None, return_state: bool = False,
                adaptive: bool = False,
                plan: Optional[ExecutionPlan] = None,
                explain: bool = False,
                device=None):
    """Execute a fused program.  ``source`` re-sources every sourced
    component to one query source.

    Every knob kwarg is a hint to the query planner (``core.plan``):
    ``engine`` (None → "pull", "auto" → "cuda", or "cuda_sharded" with a
    ``mesh`` of more than one device), ``model`` (cuda engines:
    "pull"/"push" pins the sweep direction), ``switch_k``,
    ``push_resolution``, ``shard_strategy`` ("contiguous" | "dst_hash");
    the resolved plan lands in ``stats.plan`` and ``explain=True`` returns
    the ``PlanExplanation`` without executing.

    Sharded engines (``engine="cuda_sharded"`` or ``"distributed"``) run
    the k vertex-cut shards of ``mesh``, a ``partition.ShardMesh`` (shard
    j on ``mesh.devices[j]``, e.g. ``ShardMesh.on("cuda", 4)``; any other
    mesh raises ``TypeError``); ``stats`` then carries ``shards``,
    ``shard_work``, ``shard_launches`` and ``cross_combines``.

    Guarded execution: ``validate`` checks the graph's structural contract,
    the source's range and the termination preconditions before any kernel
    launches; ``on_nonconverge`` ("raise"/"warn"/"ignore") governs a round
    that exhausts ``max_iter`` or trips the divergence sentinel;
    ``fallback=True`` degrades an infrastructure failure down the fallback
    chain (cuda_sharded → cuda → adaptive) with bounded retry (``ft_config`` tunes the
    budget), recording each event in the stats.

    Chunked fixpoints (cuda engine, ``kernels.ops.iterate_cuda``):
    ``checkpoint_every`` / ``ckpt_dir`` / ``resume`` snapshot the loop
    carry every ``checkpoint_every`` iterations and resume from the newest
    snapshot; ``init_state`` (per-component [n] tensors or arrays)
    warm-starts the round.  ``return_state=True`` returns ``(result,
    state)``, ``state`` the round's final per-component [n] tensors on the
    graph's device, to feed back as the next query's ``init_state``.  The
    warm hooks need a single-round program; with ``init_state``, ``delta``
    or ``return_state`` the default engine is cuda.  A query that falls
    back to adaptive runs cold.

    Incremental queries over a mutated graph (``graph.mutate``):
    ``init_state=prev`` with ``delta=`` seeds the frontier with only the
    vertices whose values may have changed.  A ``MutationDelta`` also feeds
    the planner's ``incremental`` knob: "delta" for a small edit, "full"
    (the cold recompute, warm hints dropped) for a large one or for an
    idempotent round after deletions, whose stale values cannot retract.
    Raw vertex ids are taken as given.  Idempotent rounds converge bitwise
    to the cold query on the mutated graph; non-idempotent (PageRank-style)
    rounds warm-start from the rescaled state and need ``tol > 0``."""
    _prepare(g, device, mesh)
    mutation, delta_ids = _mutation_hints(delta)
    if plan is None or explain:
        planned = plan_execution(
            g, prog, engine=engine, model=model, mesh=mesh, axes=axes,
            switch_k=switch_k, push_resolution=push_resolution,
            shard_strategy=shard_strategy, validate=validate,
            on_nonconverge=on_nonconverge, fallback=fallback,
            divergence_sentinel=divergence_sentinel, adaptive=adaptive,
            mutation=mutation,
            default_engine="cuda" if (init_state is not None
                                      or delta is not None
                                      or return_state) else "pull",
            explain=explain)
        if explain:
            return planned
        plan = planned
    if mutation is not None and plan.incremental == "full":
        # the planner judged the warm+delta path unsound or unprofitable:
        # the planned cold recompute, visible in stats.plan
        init_state = delta_ids = None
    if (checkpoint_every is not None or resume) and plan.engine != "cuda":
        raise ValueError("checkpointed fixpoints are a cuda-engine feature; "
                         f"got engine={plan.engine!r}")
    if init_state is not None or delta_ids is not None or return_state:
        if plan.engine != "cuda":
            raise ValueError(
                "init_state/delta/return_state warm-start hooks are a "
                f"cuda-engine feature; got engine={plan.engine!r}")
        _require_single_round(prog, "init_state/delta/return_state")
    warm = dict(checkpoint_every=checkpoint_every, ckpt_dir=ckpt_dir,
                resume=resume, init_state=init_state, delta=delta_ids)
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
                                 src_over, warm, mesh),
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


def run_program_batch(g, prog: FusedProgram, sources: Sequence,
                      engine: Optional[str] = None,
                      model: Optional[str] = None, mesh=None,
                      axes=("data",),
                      max_iter: Optional[int] = None, tol: float = 0.0,
                      push_resolution: Optional[str] = None,
                      switch_k="auto", shard_strategy: Optional[str] = None,
                      validate: bool = True,
                      on_nonconverge: str = "raise",
                      fallback: bool = False, ft_config=None,
                      init_state=None, return_state: bool = False,
                      adaptive: bool = False,
                      plan: Optional[ExecutionPlan] = None,
                      explain: bool = False,
                      device=None):
    """Serve B single-source queries of one program together.

    ``sources`` is a [B] sequence of query sources; every sourced component
    of every round is re-sourced per query.  On the cuda engine (the
    default here) each iteration round runs as one batched fixpoint over
    the shared blocked-ELL layout (``kernels.ops.iterate_cuda_batch``): one
    launch of each sweep kernel per iteration for the whole batch, each
    query converging in its own slot, each result bitwise the solo
    ``run_program(..., source=s)`` query's with its counters.  Other
    engines run the B queries one after the other (the plan's
    ``batch_lane="sequential"``, recorded as a ``guard.batch_degradation``
    event on every query's stats; the sharded engines take ``mesh``,
    ``axes`` and ``shard_strategy`` as ``run_program`` does).

    Returns a list of B ``ExecResult``s, each with its own stats
    (``synth_ms`` is the round's shared synthesis cost, on each).

    Guarded execution as in ``run_program``: the graph and every source
    are validated up front, the termination preconditions per round, the
    convergence outcomes per query; with ``fallback=True`` a recoverable
    failure of the batched round (outside the kernel layer, whose faults
    propagate) re-runs the batch query by query on ``adaptive``, one
    ``FallbackEvent("cuda", "adaptive", …)`` on each query.

    Continuous batching (cuda engine, single-round programs, no
    fallback): ``init_state``, one per-component [B, n] array or tensor,
    warm-starts every slot (an earlier chunk's carried state, with fresh
    ``batch_init_state`` rows where new queries joined); ``return_state=
    True`` returns ``(results, state)``, ``state`` the round's final
    per-component [B, n] tensors on the graph's device.  Bound
    ``max_iter`` to the chunk and read each query's ``stats.converged``
    (under ``on_nonconverge="ignore"``) to retire or carry a slot."""
    _prepare(g, device, mesh)
    src_arr = np.asarray(sources)
    if src_arr.ndim != 1:
        raise ValueError(
            f"run_program_batch sources must be a [B] vector of query "
            f"sources, got shape {src_arr.shape}; per-component [B, n_comps] "
            "batching is the kernels-layer iterate_cuda_batch API")
    if plan is None or explain:
        planned = plan_execution(
            g, prog, engine=engine, model=model, mesh=mesh, axes=axes,
            switch_k=switch_k, push_resolution=push_resolution,
            shard_strategy=shard_strategy, batch=len(src_arr),
            validate=validate, on_nonconverge=on_nonconverge,
            fallback=fallback, adaptive=adaptive, default_engine="cuda",
            explain=explain)
        if explain:
            return planned
        plan = planned
    if init_state is not None or return_state:
        if plan.engine != "cuda":
            raise ValueError("init_state/return_state are cuda-engine "
                             f"continuous-batching hooks; got {plan.engine!r}")
        if plan.fallback:
            raise ValueError("init_state/return_state cannot degrade to the "
                             "sequential fallback loop (a warm-started batch "
                             "has no per-query equivalent there); run with "
                             "fallback=False")
        _require_single_round(prog)
    chk = _validate_inputs(g, sources=src_arr) if plan.validate else None
    max_iter_eff = max_iter if max_iter is not None else 2 * g.n + 4
    src_list = [int(s) for s in src_arr]
    n_q = len(src_list)
    if plan.engine != "cuda":
        return _each_solo(
            lambda s: run_program(g, prog, mesh=mesh, max_iter=max_iter,
                                  tol=tol, source=s, ft_config=ft_config,
                                  plan=plan, device=device),
            src_list, guard.batch_degradation(plan.engine, n_q))
    from repro_torch.kernels import ops as kops
    stats = [ExecStats(engine_used="cuda", plan=plan) for _ in range(n_q)]
    named: list = [{} for _ in range(n_q)]
    finals: list = [None] * n_q
    state_out = None
    for bind_name, round_ in prog.rounds:
        envs = [dict(nm) for nm in named]
        if round_.leaves:
            synth, synth_ms = _synthesize_timed(round_)
            comps, plans = _round_runtime(round_, synth)
            _check_preconditions(chk, comps, plans)
            try:
                res = kops.iterate_cuda_batch(
                    g, comps, plans, src_list, max_iter=max_iter, tol=tol,
                    init_state=init_state, plan=plan)
            except Exception as exc:
                if not plan.fallback or not guard.recoverable(exc):
                    raise
                return _each_solo(lambda s: run_program(
                    g, prog, engine="adaptive", max_iter=max_iter, tol=tol,
                    source=s, validate=plan.validate,
                    on_nonconverge=plan.on_nonconverge,
                    fallback=plan.fallback, ft_config=ft_config,
                    device=device), src_list, _batch_fallback(exc),
                    engine="adaptive")
            _check_batch_outcomes(res, src_list, max_iter_eff,
                                  plan.on_nonconverge)
            for b, st in enumerate(stats):
                _accumulate_slot(st, res, b, synth_ms)
                for leaf in round_.leaves:
                    envs[b][leaf.name] = res.state[plan_output(leaf.plan)][b]
            if return_state:
                state_out = tuple(res.state)
        for b in range(n_q):
            out = _finish_round(g, round_, envs[b])
            if bind_name is not None:
                prefix = "$vec:" if round_.out_kind == "vertex" else "$scalar:"
                named[b][prefix + bind_name] = out
            finals[b] = out
    for st in stats:
        _plan.record_feedback(g, plan.kind, st)
    results = [ExecResult(value=finals[b], named=named[b], stats=stats[b])
               for b in range(n_q)]
    if return_state:
        return results, state_out
    return results


def _accumulate_slot(stats: ExecStats, res, b: int, synth_ms: float) -> None:
    """``_accumulate`` for query slot ``b`` of a batched round."""
    stats.rounds += 1
    stats.iterations += res.iterations[b]
    stats.edge_work += res.edge_work[b]
    stats.synth_ms += synth_ms
    stats.converged = stats.converged and bool(res.converged[b])
    stats.push_iters += res.push_iters[b]
    stats.pull_iters += res.pull_iters[b]
    stats.resolve_work += res.resolve_work[b]
    stats.gather_work += res.gather_work[b]


def _batch_fallback(exc) -> guard.FallbackEvent:
    """The event of a batched cuda round that failed recoverably and
    re-runs query by query on adaptive."""
    return guard.FallbackEvent("cuda", "adaptive",
                               f"{type(exc).__name__}: {exc}")


def _each_solo(solo, src_list, event: guard.FallbackEvent,
               engine: Optional[str] = None) -> list:
    """A batch served as one solo query per source (``solo(source)``),
    ``event`` first in each query's fallbacks and, where the queries ran
    on another engine than planned, ``engine`` as their engine used."""
    ev = event.as_tuple()
    outs = [solo(s) for s in src_list]
    for o in outs:
        o.stats.fallbacks = (ev,) + o.stats.fallbacks
        if engine is not None:
            o.stats.engine_used = engine
    return outs


def batchable_program(prog: FusedProgram) -> bool:
    """True when a fused program fits the continuous-batching contract:
    exactly one round, with an iteration (leaves), every plan idempotent
    (monotone (+) rounds, whose unique fixpoint makes a chunked warm
    resume bitwise safe; (−) recompute rounds depend on the iteration
    count and run whole), and every component sourced (so a per-slot
    source re-sources the whole round)."""
    if len(prog.rounds) != 1:
        return False
    _, round_ = prog.rounds[0]
    if not round_.leaves:
        return False
    if not all(iterate.plan_idempotent(leaf.plan) for leaf in round_.leaves):
        return False
    return all(c.source is not None for c in round_.components)


def batch_init_state(g, prog: FusedProgram, sources: Sequence) -> tuple:
    """Fresh per-component [B, n] initial state for a batch of query
    sources of a single-round program, on the graph's device: the rows a
    continuous-batching scheduler splices into its carried state when new
    queries take over retired slots (``run_program_batch(init_state=…)``).
    Row b is exactly the C1/C2 initial state of a solo ``source=
    sources[b]`` query.  A program with a LetRound chain is refused, as
    ``run_program_batch(init_state=…)`` refuses it (the reference builds
    rows for it that its batch then rejects)."""
    _require_single_round(prog, "batch_init_state")
    round_ = prog.rounds[0][1]
    synth, _ = _synthesize_timed(round_)
    comps, _plans = _round_runtime(round_, synth)
    rows = [iterate._init_state(comps, g.n,
                                _source_overrides(round_, int(s)),
                                device=g.device)
            for s in sources]
    return tuple(torch.stack([r[i] for r in rows])
                 for i in range(len(comps)))


def run_direct(g, dk: DirectKernels, engine: Optional[str] = None,
               model: Optional[str] = None, mesh=None, axes=("data",),
               source: Optional[int] = None,
               sources: Optional[Sequence] = None,
               push_resolution: Optional[str] = None,
               switch_k="auto", shard_strategy: Optional[str] = None,
               validate: bool = True,
               on_nonconverge: str = "raise",
               fallback: bool = False, ft_config=None,
               divergence_sentinel: bool = True,
               checkpoint_every: Optional[int] = None,
               ckpt_dir=None, resume: bool = False,
               init_state=None, delta=None,
               adaptive: bool = False,
               plan: Optional[ExecutionPlan] = None,
               explain: bool = False,
               device=None):
    """Execute a direct kernel set (PageRank-style, paper Fig. 4b) on one
    engine.  ``model`` pins the cuda engine's sweep direction; by default
    idempotent kernels switch per iteration and the rest run the pull−
    recompute.  The cuda engine needs ``dk.p_expr`` (the kernel is
    generated from it).  ``fallback``, ``ft_config``, ``checkpoint_every``,
    ``ckpt_dir``, ``resume``, ``init_state`` and ``delta`` act as in
    ``run_program``; with ``init_state`` or ``delta`` the default engine is
    cuda.  For the non-idempotent kernels this entry point mostly serves
    (PageRank), ``delta`` is the rescaled warm start, converging to the
    tolerance-fixed answer of a cold run.

    ``source`` overrides ``dk.source`` for one query; ``sources`` runs a
    [B] batch of queries and returns a list of per-query ``ExecResult``s:
    one batched fixpoint on the cuda engine (``ops.iterate_cuda_batch``,
    each result bitwise its solo query's), B solo queries elsewhere with
    the ``guard.batch_degradation`` event.  ``mesh``, ``axes`` and
    ``shard_strategy`` act as in ``run_program``; ``distributed`` runs the
    kernel set pull−, as the reference does.  Both need a source-generic
    kernel set (``dk.source`` not None); a batch is neither chunked nor
    warm-started."""
    from repro_torch.core.fusion import Prim

    _prepare(g, device, mesh)
    mutation, delta_ids = _mutation_hints(delta)
    if plan is None or explain:
        planned = plan_execution(
            g, dk, engine=engine, model=model, mesh=mesh, axes=axes,
            switch_k=switch_k, push_resolution=push_resolution,
            shard_strategy=shard_strategy,
            batch=None if sources is None else len(sources),
            validate=validate, on_nonconverge=on_nonconverge,
            fallback=fallback, divergence_sentinel=divergence_sentinel,
            adaptive=adaptive, mutation=mutation,
            default_engine="cuda" if (init_state is not None
                                      or delta is not None) else "pull",
            explain=explain)
        if explain:
            return planned
        plan = planned
    if mutation is not None and plan.incremental == "full":
        init_state = delta_ids = None
    if delta_ids is not None and sources is not None:
        raise ValueError("delta warm starts are a solo-query path; "
                         "batched sources cannot share one touched set")
    chunked = (checkpoint_every is not None or resume
               or init_state is not None or delta_ids is not None)
    if chunked and plan.engine != "cuda":
        raise ValueError("checkpointed/warm-started fixpoints are a "
                         f"cuda-engine feature; got engine={plan.engine!r}")
    if chunked and sources is not None:
        raise ValueError("a batch of sources is neither checkpointed nor "
                         "warm-started; run each source solo for that")
    if (source is not None or sources is not None) and dk.source is None:
        raise ValueError(
            "run_direct source overrides need a source-generic DirectKernels "
            "(init_fn(v, s) with source=...); this kernel set is sourceless "
            "or bakes its source into the init closure")
    if dk.source is not None and iterate._init_arity(dk.init_fn) < 2:
        raise ValueError(
            "DirectKernels.source requires a source-generic init_fn(v, s)")
    chk = _validate_inputs(g, source=source, sources=sources) \
        if plan.validate else None
    max_iter_eff = dk.max_iter if dk.max_iter is not None else 2 * g.n + 4
    comp = iterate.CompRuntime(
        idx=0, op=dk.rop, dtype=iterate.DTYPES[dk.dtype], p_fn=dk.p_fn,
        init_fn=dk.init_fn, source=dk.source, e_fn=dk.e_fn,
        p_expr=dk.p_expr)
    plans = [Prim(dk.rop, 0)]
    _check_preconditions(chk, [comp], plans)
    if sources is not None:
        return _direct_batch(g, dk, comp, plans, sources, plan, ft_config,
                             max_iter_eff, device, mesh)
    src_over = None if source is None else {0: int(source)}
    warm = dict(checkpoint_every=checkpoint_every, ckpt_dir=ckpt_dir,
                resume=resume, init_state=init_state, delta=delta_ids)
    res, eng_used, events, retries = _dispatch_guarded(
        lambda eng: _run(eng, plan, g, [comp], plans, dk.max_iter, dk.tol,
                         src_over, warm, mesh, direct=True),
        plan.engine, plan.fallback, ft_config)
    stats = ExecStats(engine_used=eng_used,
                      fallbacks=tuple(ev.as_tuple() for ev in events),
                      exec_retries=retries, plan=plan)
    _accumulate(stats, res, 0.0)
    _check_outcome(res, max_iter_eff, plan.on_nonconverge)
    _plan.record_feedback(g, plan.kind, stats)
    return ExecResult(value=res.state[0], named={}, stats=stats)


def _direct_batch(g, dk, comp, plans, sources, plan, ft_config, max_iter_eff,
                  device, mesh) -> list:
    """``run_direct(sources=…)`` past its checks: one batched fixpoint on
    cuda, B solo queries (with the ``batch_degradation`` event) elsewhere."""
    src_list = [int(s) for s in sources]
    if plan.engine != "cuda":
        return _each_solo(
            lambda s: run_direct(g, dk, mesh=mesh, source=s,
                                 ft_config=ft_config, plan=plan,
                                 device=device),
            src_list, guard.batch_degradation(plan.engine, len(src_list)))
    from repro_torch.kernels import ops as kops
    try:
        res = kops.iterate_cuda_batch(g, [comp], plans, src_list,
                                      max_iter=dk.max_iter, tol=dk.tol,
                                      plan=plan)
    except Exception as exc:
        if not plan.fallback or not guard.recoverable(exc):
            raise
        return _each_solo(lambda s: run_direct(
            g, dk, engine="adaptive", source=s, validate=plan.validate,
            on_nonconverge=plan.on_nonconverge, fallback=plan.fallback,
            ft_config=ft_config, device=device), src_list,
            _batch_fallback(exc), engine="adaptive")
    _check_batch_outcomes(res, src_list, max_iter_eff, plan.on_nonconverge)
    outs = []
    for b in range(len(src_list)):
        stats = ExecStats(engine_used="cuda", plan=plan)
        _accumulate_slot(stats, res, b, 0.0)
        _plan.record_feedback(g, plan.kind, stats)
        outs.append(ExecResult(value=res.state[0][b], named={}, stats=stats))
    return outs
