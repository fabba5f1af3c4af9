"""ExecutionPlan: the query planner of the GraFS executor.

The port's counterpart of ``repro.core.plan``: every execution knob —
engine, sweep direction, the Gemini ``switch_k``, push resolution and the
guarded-execution policy, fallback included — is resolved in ONE place,
``plan_execution``, from cached per-graph statistics, with caller kwargs
acting as hints that are normalized exactly once.  The resolved
``ExecutionPlan`` is frozen; the engine entry points lower through it and
``ops.iterate_cuda`` asserts its fields.  Default plans reproduce the documented heuristics (Gemini
``SWITCH_K``, ``"sorted"`` resolution, ``"auto"`` direction).

Engines: ``pull``, ``push``, ``adaptive`` and ``dense`` (the reference
engines of ``core.iterate``) and ``cuda`` (the direction-optimized
blocked-ELL engine whose sweeps are the hand-written CUDA kernels — the
reference's ``pallas``).  ``degrade_plan`` gives the plan one step of the
guard fallback chain runs under.  ``batch_size`` / ``batch_lane``
describe a batch of query sources: "vmapped" on ``cuda`` (one launch per
sweep per iteration for the whole batch, the reference's name for it),
"sequential" elsewhere (B solo queries, a recorded degradation).
``incremental`` is the mutation-aware mode of a query over a mutated graph
(``mutation=``): "delta" (warm start, touched-frontier seed) or "full" (the
cold recompute).  The sharded engines belong to a later slice.

A recorded-stats feedback cache closes the loop: each executed query
records its push/pull split and resolve work per (graph, query kind);
queries that opt in (``adaptive=True``) get a bounded ``switch_k`` /
resolution adjustment — idempotent rounds only, where push and pull sweeps
are bitwise-interchangeable per iteration.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import OrderedDict
from typing import Optional

from repro_torch.core import iterate
from repro_torch.core.fusion import FusedProgram, Lex
from repro_torch.core.synthesis import DirectKernels

DENSE_FRONTIER = 0.05      # FALLBACK switch point (switch_k=None): frontier
                           # vertex fraction above which the pull sweep wins

SWITCH_K = 20.0            # the default Gemini rule: push while the
                           # frontier's outgoing edge count |E_frontier|
                           # stays ≤ |E| / k

PUSH_RESOLUTION = "sorted"  # default dst-keyed resolution of the push sweep:
                            # "sorted" = the resolve kernel over the
                            # dst-major layout; "scatter" = full-rectangle
                            # torch scatter (the reference path)

INCREMENTAL_DELTA = 0.05   # mutated-edge fraction of |E| up to which a query
                           # over a mutated graph plans the warm+delta path

ADAPT_SPAN = 4.0
ADAPT_PUSH_HI = 0.75
ADAPT_PUSH_LO = 0.25

ENGINES = ("pull", "push", "adaptive", "dense", "cuda")


def _normalize_switch_k(switch_k, dense_threshold=DENSE_FRONTIER):
    """"auto" → the default Gemini k; None → the DENSE_FRONTIER fallback;
    a positive number → that k.  A non-default ``dense_threshold`` with an
    active Gemini rule is rejected rather than silently ignored."""
    if isinstance(switch_k, str):
        if switch_k != "auto":
            raise ValueError(f"switch_k must be 'auto', None or a number, "
                             f"got {switch_k!r}")
        switch_k = SWITCH_K
    elif switch_k is not None:
        switch_k = float(switch_k)
        if not switch_k > 0:
            raise ValueError(f"switch_k must be > 0 (push while |E_frontier|"
                             f" <= |E|/k), got {switch_k}")
    if switch_k is not None and dense_threshold != DENSE_FRONTIER:
        raise ValueError(
            "dense_threshold only governs the switch_k=None fallback; pass "
            "switch_k=None to use a custom frontier-fraction threshold, or "
            "tune the Gemini rule via switch_k")
    return switch_k


def _check_resolution(push_resolution) -> str:
    if push_resolution is None:
        return PUSH_RESOLUTION
    if push_resolution not in ("scatter", "sorted"):
        raise ValueError(f"push_resolution must be 'scatter' or 'sorted', "
                         f"got {push_resolution!r}")
    return push_resolution


def _cuda_direction(model) -> str:
    """Engine-level ``model`` → sweep-direction policy of the cuda engine."""
    if model in (None, "auto"):
        return "auto"
    base = str(model).rstrip("+-")
    if base in ("pull", "push"):
        return base
    raise ValueError(f"cuda engine: unknown model {model!r}")


def _check_on_nonconverge(on_nonconverge: str) -> str:
    if on_nonconverge not in ("raise", "warn", "ignore"):
        raise ValueError(f"on_nonconverge must be 'raise', 'warn' or "
                         f"'ignore', got {on_nonconverge!r}")
    return on_nonconverge


def assert_normalized(plan: "ExecutionPlan") -> None:
    """The kernels-layer contract: a plan that reaches ``ops`` is already
    normalized — fields are checked, never re-parsed."""
    if plan.direction not in ("auto", "pull", "push"):
        raise ValueError(f"unnormalized direction {plan.direction!r}")
    if not (plan.switch_k is None or (isinstance(plan.switch_k, float)
                                      and plan.switch_k > 0)):
        raise ValueError(f"unnormalized switch_k {plan.switch_k!r}")
    if plan.push_resolution not in ("sorted", "scatter"):
        raise ValueError(
            f"unnormalized push_resolution {plan.push_resolution!r}")
    if plan.incremental not in (None, "delta", "full"):
        raise ValueError(f"unnormalized incremental {plan.incremental!r}")


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Every resolved execution decision of one query, in one frozen
    value."""
    engine: str
    model: Optional[str] = None
    direction: str = "auto"
    switch_k: Optional[float] = SWITCH_K
    dense_threshold: float = DENSE_FRONTIER
    push_resolution: str = PUSH_RESOLUTION
    resolution_hint: Optional[str] = None
    batch_size: Optional[int] = None
    batch_lane: Optional[str] = None
    validate: bool = True
    on_nonconverge: str = "raise"
    fallback: bool = False
    divergence_sentinel: bool = True
    adaptive: bool = False
    incremental: Optional[str] = None
    kind: tuple = ()

    def knobs(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


@dataclasses.dataclass
class PlanExplanation:
    """``explain=True`` payload: the plan, the graph statistics behind it,
    the feedback snapshot (if any) and one reason per resolved field."""
    plan: ExecutionPlan
    stats: object
    feedback: Optional[dict]
    decisions: dict


def _plan_levels(plan):
    levels = []
    p = plan
    while isinstance(p, Lex):
        levels.append((p.comp, p.op))
        p = p.secondary
    levels.append((p.comp, p.op))
    return levels


def program_kind(prog) -> tuple:
    """Structural, source-free identity of a query shape."""
    if isinstance(prog, FusedProgram):
        rounds = []
        for _name, round_ in prog.rounds:
            rounds.append((
                tuple(tuple(_plan_levels(leaf.plan)) for leaf in round_.leaves),
                tuple(c.source is not None for c in round_.components)))
        return ("program", tuple(rounds))
    if isinstance(prog, DirectKernels):
        return ("direct", prog.rop, str(prog.dtype),
                prog.e_fn is not None, prog.source is not None)
    return ("adhoc",)


def _prog_idempotent(prog) -> bool:
    if isinstance(prog, FusedProgram):
        leaves = [leaf for _n, r in prog.rounds for leaf in r.leaves]
        return bool(leaves) and all(iterate.plan_idempotent(leaf.plan)
                                    for leaf in leaves)
    if isinstance(prog, DirectKernels):
        return prog.rop in iterate._IDEMPOTENT_OPS and prog.e_fn is None
    return False


_PLAN_CACHE: OrderedDict = OrderedDict()
_PLAN_CACHE_MAX = 256

_FEEDBACK: OrderedDict = OrderedDict()
_FEEDBACK_MAX = 256


@dataclasses.dataclass
class FeedbackRecord:
    """Per-(graph, kind) observed execution statistics."""
    queries: int = 0
    iterations: int = 0
    push_iters: int = 0
    pull_iters: int = 0
    edge_work: float = 0.0
    resolve_work: float = 0.0
    nonconverged: int = 0
    epoch: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _lru_put(cache: OrderedDict, maxlen: int, key, value) -> None:
    cache[key] = value
    cache.move_to_end(key)
    while len(cache) > maxlen:
        cache.popitem(last=False)


def plan_cache_size() -> int:
    return len(_PLAN_CACHE)


def feedback_cache_size() -> int:
    return len(_FEEDBACK)


def clear_plan_caches() -> None:
    _PLAN_CACHE.clear()
    _FEEDBACK.clear()


def clear_graph_plans(g) -> int:
    dropped = 0
    for cache in (_PLAN_CACHE, _FEEDBACK):
        stale = [k for k, (ref, _) in list(cache.items()) if ref() is g]
        for k in stale:
            if cache.pop(k, None) is not None:
                dropped += 1
    return dropped


def record_feedback(g, kind: tuple, stats) -> None:
    """Fold one executed query's ``ExecStats`` into the (graph, kind)
    feedback record."""
    key = (id(g), kind)
    hit = _FEEDBACK.get(key)
    rec = None
    if hit is not None:
        ref, rec = hit
        if ref() is not g:
            rec = None
    if rec is None:
        rec = FeedbackRecord()
        _lru_put(_FEEDBACK, _FEEDBACK_MAX, key, (weakref.ref(g), rec))
        weakref.finalize(g, _FEEDBACK.pop, key, None)
    else:
        _FEEDBACK.move_to_end(key)
    rec.queries += 1
    rec.iterations += int(stats.iterations)
    rec.push_iters += int(stats.push_iters)
    rec.pull_iters += int(stats.pull_iters)
    rec.edge_work += float(stats.edge_work)
    rec.resolve_work += float(stats.resolve_work)
    if not stats.converged:
        rec.nonconverged += 1
    rec.epoch += 1


def feedback_for(g, kind: tuple) -> Optional[FeedbackRecord]:
    hit = _FEEDBACK.get((id(g), kind))
    if hit is None:
        return None
    ref, rec = hit
    return rec if ref() is g else None


def _adapted_switch_k(rec: FeedbackRecord) -> float:
    if rec.iterations <= 0:
        return SWITCH_K
    frac = rec.push_iters / rec.iterations
    if frac >= ADAPT_PUSH_HI:
        k = SWITCH_K / 2.0
    elif frac <= ADAPT_PUSH_LO:
        k = SWITCH_K * 2.0
    else:
        k = SWITCH_K
    return float(min(max(k, SWITCH_K / ADAPT_SPAN), SWITCH_K * ADAPT_SPAN))


def _adapted_resolution(rec: FeedbackRecord) -> Optional[str]:
    if rec.push_iters > 0 and rec.resolve_work > rec.edge_work > 0:
        return "scatter"
    return None


def plan_execution(g, prog=None, *, engine: Optional[str] = None,
                   model: Optional[str] = None,
                   switch_k="auto", dense_threshold: Optional[float] = None,
                   push_resolution: Optional[str] = None,
                   validate: bool = True,
                   on_nonconverge: str = "raise",
                   fallback: bool = False,
                   divergence_sentinel: bool = True,
                   adaptive: bool = False,
                   batch: Optional[int] = None,
                   mutation=None,
                   default_engine: str = "pull",
                   explain: bool = False):
    """Resolve every execution knob of one query into an ``ExecutionPlan``.

    An explicit caller kwarg always wins; ``engine=None`` takes the entry
    point's default; ``engine="auto"`` picks ``cuda``; unset knobs take the
    documented defaults.  ``batch`` (B query sources) resolves the batch
    lane.  ``mutation=`` (a ``graph.mutate.MutationDelta``, or anything
    with ``inserted`` / ``deleted`` / ``touched`` / ``has_deletes``)
    resolves ``incremental``: an edit of at most ``INCREMENTAL_DELTA`` of
    |E| plans "delta" (warm start + touched-frontier seed), a larger one,
    or an idempotent query after deletions (whose stale monotone values
    cannot retract), "full".  Plans are cached per (graph identity, kind,
    hints[, feedback epoch]); ``explain=True`` returns a
    ``PlanExplanation``."""
    from repro_torch.graph import structure

    decisions: dict = {} if explain else None
    kind = program_kind(prog)
    idempotent = _prog_idempotent(prog)
    fb = feedback_for(g, kind) if adaptive else None
    fb_epoch = fb.epoch if fb is not None else 0
    mut_key = None
    if mutation is not None:
        touched = getattr(mutation, "touched", None)
        mut_key = (int(getattr(mutation, "inserted", 0)),
                   int(getattr(mutation, "deleted", 0)),
                   0 if touched is None else int(getattr(touched, "size",
                                                         len(touched))),
                   bool(getattr(mutation, "has_deletes", False)))
    hints_key = (engine, model, switch_k, dense_threshold, push_resolution,
                 validate, on_nonconverge, fallback, divergence_sentinel,
                 adaptive, batch, mut_key, default_engine)
    cache_key = (id(g), kind, hints_key, fb_epoch)
    if not explain:
        hit = _PLAN_CACHE.get(cache_key)
        if hit is not None:
            ref, plan = hit
            if ref() is g:
                _PLAN_CACHE.move_to_end(cache_key)
                return plan

    stats = structure.graph_stats(g)
    _check_on_nonconverge(on_nonconverge)

    if engine is None:
        eng, reason = default_engine, f"entry-point default ({default_engine!r})"
    elif engine == "auto":
        eng, reason = "cuda", "auto: single device → blocked-ELL CUDA engine"
    else:
        eng, reason = engine, "caller hint"
    if eng not in ENGINES:
        raise ValueError(f"unknown engine {eng}")
    if decisions is not None:
        decisions["engine"] = reason

    if eng == "cuda":
        direction = _cuda_direction(model)
        if decisions is not None:
            decisions["direction"] = (
                "forced by model hint" if direction != "auto" else
                ("per-iteration Gemini switch (idempotent rounds)"
                 if idempotent else
                 "auto (non-idempotent rounds run the pull− recompute)"))
    else:
        direction = "auto"
        if decisions is not None:
            decisions["direction"] = "reference engines take model directly"

    dt = DENSE_FRONTIER if dense_threshold is None else float(dense_threshold)
    k_norm = _normalize_switch_k(switch_k, dt)
    k_reason = ("caller hint" if switch_k != "auto"
                else f"documented Gemini default k={SWITCH_K}")
    if (adaptive and idempotent and switch_k == "auto" and fb is not None
            and fb.queries > 0):
        k_norm = _adapted_switch_k(fb)
        k_reason = (f"feedback: {fb.push_iters}/{fb.iterations} push "
                    f"iterations over {fb.queries} queries → k={k_norm}")
    if decisions is not None:
        decisions["switch_k"] = k_reason
        decisions["dense_threshold"] = (
            "caller hint (switch_k=None fallback)" if dense_threshold
            is not None else "documented DENSE_FRONTIER default")

    res = _check_resolution(push_resolution)
    res_reason = ("caller hint" if push_resolution is not None else
                  "documented dst-sorted default")
    if (adaptive and idempotent and push_resolution is None
            and fb is not None):
        flipped = _adapted_resolution(fb)
        if flipped is not None:
            res = flipped
            res_reason = (f"feedback: resolve_work {fb.resolve_work:.0f} > "
                          f"edge_work {fb.edge_work:.0f} → reference scatter")
    if decisions is not None:
        decisions["push_resolution"] = res_reason

    lane = None
    if batch is not None:
        lane = "vmapped" if eng == "cuda" else "sequential"
        if decisions is not None:
            decisions["batch_lane"] = (
                f"B={batch} sources in one launch per sweep per iteration"
                if lane == "vmapped"
                else f"engine {eng!r} has no batched fixpoint — B={batch} "
                     "sequential runs (recorded degradation)")

    inc = None
    if mut_key is not None:
        n_ins, n_del, _n_touched, has_del = mut_key
        sz = n_ins + n_del
        if idempotent and has_del:
            inc = "full"
            inc_reason = ("idempotent round after deletions: stale monotone "
                          "values cannot retract — planned full recompute")
        elif sz <= INCREMENTAL_DELTA * max(1, stats.num_edges):
            inc = "delta"
            inc_reason = (f"{sz} mutated edges ≤ {INCREMENTAL_DELTA:.0%} of "
                          f"|E|={stats.num_edges} → warm+delta propagation")
        else:
            inc = "full"
            inc_reason = (f"{sz} mutated edges > {INCREMENTAL_DELTA:.0%} of "
                          f"|E|={stats.num_edges} → planned full recompute")
        if decisions is not None:
            decisions["incremental"] = inc_reason

    plan = ExecutionPlan(
        engine=eng, model=model, direction=direction,
        switch_k=k_norm, dense_threshold=dt,
        push_resolution=res, resolution_hint=push_resolution,
        batch_size=batch, batch_lane=lane, validate=validate,
        on_nonconverge=on_nonconverge,
        fallback=fallback, divergence_sentinel=divergence_sentinel,
        adaptive=adaptive, incremental=inc, kind=kind)
    if explain:
        return PlanExplanation(
            plan=plan, stats=stats,
            feedback=fb.as_dict() if fb is not None else None,
            decisions=decisions)
    _lru_put(_PLAN_CACHE, _PLAN_CACHE_MAX, cache_key, (weakref.ref(g), plan))
    weakref.finalize(g, _PLAN_CACHE.pop, cache_key, None)
    return plan


def degrade_plan(plan: ExecutionPlan, engine: str) -> ExecutionPlan:
    """The plan a guard-fallback step executes under: same normalized knobs,
    target engine, with the resolution re-resolved from the raw hint (an
    explicit caller hint survives the hop; a hintless plan lands on the
    documented dst-sorted default)."""
    if engine == plan.engine:
        return plan
    return dataclasses.replace(
        plan, engine=engine,
        push_resolution=_check_resolution(plan.resolution_hint))
