"""The single-device fixpoint of the ``cuda`` engine.

The port of ``repro.kernels.ops.iterate_pallas`` and ``iterate_pallas_batch``
(single-device): the same fixpoint semantics as ``iterate.iterate_graph``, with
every edge sweep executed by the hand-written CUDA kernels of
``edge_reduce``.  One iteration launches either the pull kernel or the
push kernel followed by the sorted-resolution kernel.

``lax.while_loop`` becomes a host loop that reads the frontier once per
iteration (together with the frontier's edge mass when the direction
switch needs it); ``lax.cond`` becomes a Python branch on the Gemini rule
— push while Σ out_deg(frontier) ≤ |E|/k, ``SWITCH_K`` = 20 by default,
``switch_k=None`` falling back to the ``DENSE_FRONTIER`` vertex fraction.
Non-idempotent rounds run the pull− recompute with the fused has-pred
probe, or push− with sorted resolution under ``model="push"``.  An
idempotent pull iteration runs the pull kernel in its derived-activity
mode: it walks the layout's static tiles, decides the frontier's tile
activity itself and returns it for the edge-work counter, so no torch
gather over the in-layout rectangle runs per iteration.  Each sweep step
runs under a ``grafs::pull`` or ``grafs::push`` profiler range, by which a
trace attributes its device time.

The carry is the reference's nine fields: state, active, k, work, pushes,
resolve work, gather work, divergence, residual.  The work counters are
int64 on the device (the reference accumulates them in float32, exact only
below 2²⁴) and are read once, at the end.  The query is cut as the
reference's ``(init, step)`` pair: a per-call set-up (``_Fixpoint``),
``_init_carry`` and ``_advance(carry, k_stop)``, the one loop body.  The
monolithic query is ``_advance(_init_carry(), max_iter)``; a chunked one
(checkpointed, resumed or warm-started) calls ``_advance`` once per chunk
on the same carry, so both are bitwise the same.  ``delta=`` (a
mutation's touched vertex ids, with ``init_state``) replaces the warm
start's all-ones frontier with exactly those vertices before the first
chunk; the loop body is the same.

``iterate_cuda_batch`` (the port of ``iterate_pallas_batch``) runs B
queries of one round over the one shared layout: the carry gains a slot
axis, each live slot picks its own direction, and one iteration launches
at most one pull, one push and one resolve kernel for the whole batch.

``embedding_bag`` and ``ell_softmax`` are the embedding-bag and ELL-softmax
kernels' entry points under the names the reference's ``ops`` gives them.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.checkpoint.fixpoint import FixpointCheckpointer
from repro_torch.core import guard, iterate
from repro_torch.core.plan import (DENSE_FRONTIER, PUSH_RESOLUTION,
                                   _check_resolution, _normalize_switch_k,
                                   _plan_levels, assert_normalized)
from repro_torch.graph.structure import (Graph, blocked_ell_cached,
                                         push_resolution_cached, w_out_deg)
from repro_torch.kernels import edge_reduce as _er
from repro_torch.kernels.embedding_bag import embedding_bag  # noqa: F401
from repro_torch.kernels.segment_softmax import ell_softmax  # noqa: F401


# The per-round sweep shape (and with it the built CUDA library), keyed
# like the reference's executor cache: plan levels + kernel-set identity,
# never the query source.
_EXEC_CACHE: dict = {}


def clear_executor_cache():
    _EXEC_CACHE.clear()


def executor_cache_size() -> int:
    return len(_EXEC_CACHE)


def _comps_key(comps):
    return tuple((cr.idx, cr.op, str(cr.dtype), cr.source is not None,
                  id(cr.p_fn), id(cr.init_fn),
                  None if cr.e_fn is None else id(cr.e_fn),
                  None if cr.p_expr is None else str(cr.p_expr))
                 for cr in comps)


def sweep_round(comps, plans) -> _er.SweepRound:
    """The memoized ``SweepRound`` of one fused round.  The entry pins the
    keyed closures so a collected kernel set can never hand its id to a new
    one while the entry lives."""
    plan_levels = tuple(tuple(_plan_levels(p)) for p in plans)
    key = (plan_levels, _comps_key(comps))
    hit = _EXEC_CACHE.get(key)
    if hit is not None:
        return hit[0]
    by_idx = {cr.idx: cr for cr in comps}
    order = _er.comps_in_plan_order(plan_levels)
    rnd = _er.SweepRound(
        plan_levels, {c: by_idx[c].dtype for c in order},
        {c: by_idx[c].ident for c in order},
        {c: by_idx[c].p_fn for c in order},
        {c: by_idx[c].p_expr for c in order})
    _EXEC_CACHE[key] = (rnd, tuple((cr.p_fn, cr.init_fn, cr.e_fn)
                                   for cr in comps))
    return rnd


def _step_range(direction: str):
    """The profiler range ``grafs::<direction>`` around one sweep step, by
    which a trace attributes the step's device time.  Opened only while a
    profiler records: a range costs microseconds of host time even when
    none does, the check a fraction of one."""
    if torch._C._autograd._profiler_enabled():
        return record_function(f"grafs::{direction}")
    return contextlib.nullcontext()


def _directions_used(direction: str, idempotent: bool):
    if direction == "auto":
        return ("pull", "push") if idempotent else ("pull",)
    if direction == "pull":
        return ("pull",)
    if direction == "push":
        return ("push",)
    raise ValueError(f"direction must be auto|pull|push, got {direction!r}")


def _padded_init_state(comps, n, n_pad, sources, device):
    base = iterate._init_state(comps, n, sources, device=device)
    out = []
    for s, cr in zip(base, comps):
        full = torch.full((n_pad,), cr.ident.item(), dtype=s.dtype,
                          device=device)
        full[:n] = s
        out.append(full)
    return tuple(out)


def _srcs_vector(comps, sources=None) -> list:
    """The effective source per component (``sources`` overrides
    ``cr.source`` for sourced components), −1 where a component has
    none."""
    vals = []
    for cr in comps:
        if cr.source is None:
            vals.append(-1)
        elif sources is not None and cr.idx in sources:
            vals.append(int(sources[cr.idx]))
        else:
            vals.append(int(cr.source))
    return vals


def _fixpoint_fingerprint(g, comps, plans, use, max_iter, tol, block_v,
                          block_e, push_resolution, switch_k, srcs) -> dict:
    """JSON-able identity of a chunked fixpoint, the reference's fields: a
    checkpoint written under one fingerprint must never resume another
    query (a different graph, plan structure, sources or knobs).  The
    device is not part of it, so a snapshot resumes on any device."""
    return {
        "n": int(g.n), "num_edges": int(g.num_edges),
        "plans": repr(tuple(tuple(_plan_levels(p)) for p in plans)),
        "comps": repr(tuple((cr.idx, cr.op,
                             str(cr.dtype).removeprefix("torch."),
                             cr.e_fn is not None) for cr in comps)),
        "use": list(use), "max_iter": int(max_iter), "tol": float(tol),
        "block_v": int(block_v), "block_e": int(block_e),
        "push_resolution": str(push_resolution),
        "switch_k": None if switch_k is None else float(switch_k),
        "srcs": [int(s) for s in srcs],
    }


@contextlib.contextmanager
def _kernel_faults():
    """Raise a failure that ``guard.recoverable`` would let the fallback
    chain take, an out-of-memory error aside, as a ``KernelLaunchError``."""
    try:
        yield
    except Exception as exc:
        if guard.recoverable(exc) and not guard.out_of_memory(exc):
            raise guard.KernelLaunchError(
                f"the cuda engine failed: {type(exc).__name__}: {exc}"
            ) from exc
        raise


def iterate_cuda(g: Graph, comps, plans, max_iter: Optional[int] = None,
                 tol: float = 0.0, direction: str = "auto",
                 dense_threshold: float = DENSE_FRONTIER,
                 switch_k="auto", push_resolution: str = PUSH_RESOLUTION,
                 sources: Optional[dict] = None,
                 divergence_sentinel: bool = True,
                 init_state=None, checkpoint_every: Optional[int] = None,
                 ckpt_dir=None, resume: bool = False, fault_hook=None,
                 delta=None, plan=None) -> iterate.IterationResult:
    """Fixpoint of the fused reduction with CUDA edge sweeps on the graph's
    device (the plain versions of the kernels when the graph lies on the
    CPU).

    ``direction``: "auto" (Gemini switch for idempotent rounds, pull−
    recompute otherwise), "pull" or "push".  ``switch_k``: "auto" (k =
    ``SWITCH_K``), a positive k, or None (``DENSE_FRONTIER`` fraction
    rule).  ``push_resolution``: "sorted" (the resolve kernel) or
    "scatter" (torch).  ``plan``: an engine-resolved ``ExecutionPlan``
    whose normalized fields override those knobs.

    The result carries ``push_iters``/``pull_iters``, ``resolve_work`` (Σ
    tile_nnz of the resolution tiles processed) and ``gather_work`` (the
    candidate slots the resolve kernel read) beside the fields of
    ``IterationResult``.

    Chunked execution (the loop body is the whole query's, so the result
    is bitwise the same):

    ``init_state``
        per-component [n] tensors or arrays to warm-start from (e.g. a
        previous query's converged state); padding keeps the identity and
        the frontier starts all ones.
    ``delta``
        vertex ids whose values may have changed (a mutation's touched set,
        ``mutate.MutationDelta.touched``): the warm-started frontier holds
        exactly these vertices instead of all ones (padding rows inactive),
        so an idempotent round after a small insert-only edit converges in a
        few frontier-sized sweeps, bitwise the cold query's.  Needs
        ``init_state``; a non-idempotent round needs ``tol > 0``, its
        convergence to the unique attractive fixpoint being a tolerance
        statement.  A resumed snapshot carries its own frontier, so the
        seed applies only where no snapshot was restored.
    ``checkpoint_every`` / ``ckpt_dir`` / ``resume``
        run the loop in chunks of ``checkpoint_every`` iterations and
        snapshot the carry through ``checkpoint.FixpointCheckpointer``
        after each; ``resume=True`` restores the newest snapshot whose
        fingerprint matches (onto this graph's device) and continues.
    ``fault_hook``
        test-only callable invoked with the iteration count after each
        chunk: fault-injection tests raise from it to kill a run.

    Inside the set-up and the loop, a failure that ``guard.recoverable``
    would let the fallback chain take, an out-of-memory error aside, is
    raised again as a ``KernelLaunchError``: a library that lacks an entry
    point, a mis-typed ctypes call or a fault in the torch glue around the
    launches is a kernel fault, never an infrastructure failure.  The
    checkpoint I/O, a ``CheckpointMismatchError`` and the hook's
    exceptions pass through unchanged."""
    if checkpoint_every is not None and int(checkpoint_every) < 1:
        raise ValueError("checkpoint_every must be >= 1")
    if (checkpoint_every is not None or resume) and ckpt_dir is None:
        raise ValueError("checkpoint_every/resume require ckpt_dir")
    if delta is not None:
        delta = _check_delta(g, plans, tol, init_state, delta)
    with _kernel_faults():
        fx = _Fixpoint(g, comps, plans, max_iter, tol, direction,
                       dense_threshold, switch_k, push_resolution,
                       divergence_sentinel, plan)
        carry = _init_carry(fx, sources)
    max_iter = fx.max_iter
    ckpt = None
    if ckpt_dir is not None:
        ckpt = FixpointCheckpointer(ckpt_dir, fingerprint=_fixpoint_fingerprint(
            g, comps, plans, fx.use, max_iter, tol, fx.block_v, fx.block_e,
            fx.push_resolution, fx.switch_k, _srcs_vector(comps, sources)))
    restored = ckpt.restore(_snapshot(carry)) if resume else None
    if restored is not None:
        carry = _from_snapshot(restored)
    elif init_state is not None:
        carry = _warm_start_carry(carry, comps, init_state, g.n)
        if delta is not None:
            carry = _delta_seeded(carry, delta)
    # without checkpoint_every one chunk runs the whole query
    chunk = int(checkpoint_every) if checkpoint_every else max_iter
    while carry[2] < max_iter:
        k0 = carry[2]
        with _kernel_faults():
            carry, emptied = _advance(fx, carry, min(k0 + chunk, max_iter))
        if carry[2] == k0:           # the frontier was empty already
            break
        if ckpt is not None and checkpoint_every is not None:
            ckpt.save(_snapshot(carry), carry[2])
        if fault_hook is not None:
            fault_hook(carry[2])
        if emptied:
            break
    with _kernel_faults():
        return _finish(fx, carry)


def _check_delta(g, plans, tol, init_state, delta) -> np.ndarray:
    """The reference's guards on a delta seed; the ids as int64."""
    if init_state is None:
        raise ValueError(
            "delta= seeds the frontier of a warm start; pass init_state= "
            "(the previous solution) with it")
    if not all(iterate.plan_idempotent(p) for p in plans) and not tol > 0:
        raise ValueError(
            "delta warm start of a non-idempotent round requires tol > 0:"
            " convergence to the unique attractive fixpoint is a "
            "tolerance statement, not a bitwise one (DESIGN.md §15)")
    ids = np.asarray(delta, dtype=np.int64).ravel()
    if ids.size and (ids.min() < 0 or ids.max() >= g.n):
        raise ValueError(f"delta vertex ids out of range [0, {g.n})")
    return ids


def _delta_seeded(carry, delta: np.ndarray) -> tuple:
    """The warm carry with its all-ones frontier replaced by exactly the
    ``delta`` vertices: the first sweep propagates only from them, padding
    rows stay inactive."""
    active = torch.zeros_like(carry[1])
    active[torch.from_numpy(delta).to(active.device)] = True
    return (carry[0], active) + tuple(carry[2:])


class _Fixpoint:
    """The per-call set-up of one ``iterate_cuda`` query: plan knobs,
    layouts, degrees, the sweep round and the static activities.  Derived
    anew on every call (the layouts and the round from their caches), it
    never enters the carry."""

    def __init__(self, g, comps, plans, max_iter, tol, direction,
                 dense_threshold, switch_k, push_resolution,
                 divergence_sentinel, plan):
        n = g.n
        dev = g.device
        self.g, self.comps, self.plans, self.tol = g, comps, plans, tol
        self.nv = float(n)
        self.max_iter = max_iter if max_iter is not None else 2 * n + 4
        self.idempotent = all(iterate.plan_idempotent(p) for p in plans)
        if plan is not None:
            assert_normalized(plan)
            direction, dense_threshold = plan.direction, plan.dense_threshold
            switch_k, push_resolution = plan.switch_k, plan.push_resolution
            divergence_sentinel = plan.divergence_sentinel
            self.use = _directions_used(direction, self.idempotent)
        else:
            self.use = _directions_used(direction, self.idempotent)
            switch_k = _normalize_switch_k(
                switch_k,
                dense_threshold if len(self.use) == 2 else DENSE_FRONTIER)
            push_resolution = _check_resolution(push_resolution)
        self.dense_threshold, self.switch_k = dense_threshold, switch_k
        self.push_resolution = push_resolution
        self.sentinel = divergence_sentinel
        self.rnd = sweep_round(comps, plans)
        self.comps_by_idx = {cr.idx: cr for cr in comps}
        self.ell = {"pull": blocked_ell_cached(g, direction="in")
                    if "pull" in self.use else None,
                    "push": blocked_ell_cached(g, direction="out")
                    if "push" in self.use else None}
        self.sorted_res = push_resolution == "sorted" and "push" in self.use
        self.res = push_resolution_cached(g) if self.sorted_res else None
        first = self.ell[self.use[0]]
        self.block_v, self.block_e = first.block_v, first.block_e
        self.n_pad = n_pad = first.n_pad
        out_deg = g.out_deg
        self.out_deg_pad = torch.zeros(n_pad, dtype=torch.float32, device=dev)
        self.out_deg_pad[:n] = out_deg.clamp(min=1).to(torch.float32)
        # unclamped degrees for the Gemini |E_frontier| estimate (exact
        # int64)
        self.out_deg_raw = torch.zeros(n_pad, dtype=torch.int64, device=dev)
        self.out_deg_raw[:n] = out_deg.to(torch.int64)
        self.wdeg_pad = torch.ones(n_pad, dtype=torch.float32, device=dev)
        self.wdeg_pad[:n] = w_out_deg(g)
        self.num_edges = int(first.tile_nnz.sum())
        self.tiles_static = first.tiles_static
        # A non-idempotent round sweeps every tile each iteration, so under
        # sorted resolution its resolution-tile activity is the same every
        # iteration (every live tile, which is also what the resolve
        # kernel's has-pred probe must cover): computed once here.
        self.res_static = None
        if self.sorted_res and not self.idempotent:
            self.res_static = _er.resolution_tile_activity(
                self.res.contrib, self.tiles_static, self.res.tile_nnz)
        self.ones_act = torch.ones(n_pad, dtype=torch.int32, device=dev)


def _init_carry(fx: _Fixpoint, sources) -> tuple:
    """The nine-field carry of a cold start: state (tuple of [n_pad]),
    active (bool [n_pad], all ones), k, work, pushes, resolve work, gather
    work, divergence, residual.  ``k`` and ``pushes`` are host ints; the
    rest lie on the graph's device."""
    dev = fx.g.device
    state = _padded_init_state(fx.comps, fx.g.n, fx.n_pad, sources, dev)
    active = torch.ones(fx.n_pad, dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    div = torch.zeros((), dtype=torch.bool, device=dev)
    resid = torch.zeros((), dtype=torch.float32, device=dev)
    return (state, active, 0, zero, 0, zero, zero, div, resid)


def _snapshot(carry) -> tuple:
    """The carry as a checkpoint tree: ``k`` and ``pushes`` as 0-d int64."""
    return carry[:2] + (torch.tensor(carry[2], dtype=torch.int64),
                        carry[3], torch.tensor(carry[4], dtype=torch.int64)) \
        + carry[5:]


def _from_snapshot(snap) -> tuple:
    return tuple(snap[:2]) + (int(snap[2]), snap[3], int(snap[4])) \
        + tuple(snap[5:])


def _warm_start_carry(carry, comps, init_state, n) -> tuple:
    """Override the initial carry's state with per-component [n] tensors or
    arrays ([B, n] for a batch's carry, one row per slot), cast to each
    component's dtype on the carry's device: padding keeps the identity,
    and the frontier stays all ones (padding included) so the first sweep
    re-derives the true active set."""
    init_state = tuple(init_state)
    if len(init_state) != len(comps):
        raise ValueError(f"init_state has {len(init_state)} arrays for "
                         f"{len(comps)} components")
    want = tuple(carry[1].shape[:-1]) + (n,)
    new_state = []
    for ref, cr, arr in zip(carry[0], comps, init_state):
        a = arr if isinstance(arr, torch.Tensor) else \
            torch.from_numpy(np.array(arr))
        a = a.to(device=ref.device, dtype=ref.dtype)
        if tuple(a.shape) != want:
            raise ValueError(f"init_state for component {cr.idx} has shape "
                             f"{tuple(a.shape)}, expected {want}")
        s = ref.clone()
        s[..., :n] = a
        new_state.append(s)
    return (tuple(new_state),) + tuple(carry[1:])


def _sweep(fx: _Fixpoint, d, state_d, active_i32, tile_act, need_hp):
    """One sweep + its resolution → (red, hp, resolve work, gather work)."""
    e = fx.ell[d]
    args = (e.nbrs, e.weight, e.capacity, e.mask, tile_act, state_d,
            active_i32, fx.out_deg_pad, fx.wdeg_pad, fx.nv, need_hp)
    if d == "pull":
        red, hp = _er.fused_ell_sweep(fx.rnd, *args)
        return red, hp, 0, 0
    if fx.sorted_res:
        res = fx.res
        res_act = fx.res_static if fx.res_static is not None else \
            _er.resolution_tile_activity(res.contrib, tile_act, res.tile_nnz)
        red, hp = _er.fused_ell_push_sweep(
            fx.rnd, *args, resolution="sorted",
            res=(res.in2out, res.valid, res_act))
        # per query slot in a batch (res_act [S, n_i, n_j]), a 0-d sum solo
        res_w = (res.tile_nnz.to(torch.int64) * res_act).sum((-2, -1))
        return red, hp, res_w, res_w
    red, hp = _er.fused_ell_push_sweep(fx.rnd, *args, resolution="scatter")
    return red, hp, e.nbrs.numel(), 0


def _advance(fx: _Fixpoint, carry, k_stop: int) -> tuple:
    """Run the loop body from ``carry`` until ``k == k_stop`` or the
    frontier is empty: the one body of the monolithic and the chunked
    fixpoint.  One host read per iteration.  Returns ``(carry,
    emptied)``, ``emptied`` True when the loop stopped on an empty
    frontier."""
    comps, plans = fx.comps, fx.plans
    idempotent, use = fx.idempotent, fx.use
    (state, active, k, work, pushes, res_work, gather_work, div,
     resid) = carry
    emptied = False
    while k < k_stop:
        switching = idempotent and len(use) == 2
        if switching and fx.switch_k is not None:
            # one host read per iteration: frontier non-empty + edge mass
            n_act, e_frontier = torch.stack(
                [active.sum(), (active * fx.out_deg_raw).sum()]).tolist()
            use_push = e_frontier <= fx.num_edges / fx.switch_k
        elif switching:
            # the reference's frontier fraction: the padded frontier over n
            n_act = int(active.sum())
            use_push = n_act / fx.g.n <= fx.dense_threshold
        else:
            n_act = int(active.any())
        if n_act == 0:
            emptied = True
            break
        state_d = {cr.idx: state[i] for i, cr in enumerate(comps)}
        if idempotent:
            active_i32 = active.to(torch.int32)
            d = ("push" if use_push else "pull") if switching else use[0]
            e = fx.ell[d]
            if d == "pull":
                # the kernel derives the frontier's tile activity (an output)
                with _step_range("pull"):
                    red, tile_act = _er.fused_ell_sweep_frontier(
                        fx.rnd, e.nbrs, e.weight, e.capacity, e.mask,
                        e.tiles_static, state_d, active_i32, fx.out_deg_pad,
                        fx.wdeg_pad, fx.nv)
                res_w = gat_w = 0
            else:
                with _step_range("push"):
                    tile_act = _er.tile_activity_push(e.tile_nnz, active_i32)
                    red, _hp, res_w, gat_w = _sweep(fx, d, state_d,
                                                    active_i32, tile_act,
                                                    False)
            work = work + (e.tile_nnz.to(torch.int64) * tile_act).sum()
            new_d = {}
            for p in plans:
                new_d.update(iterate.plan_merge(p, state_d, red,
                                                fx.comps_by_idx))
        else:
            d = use[0]
            work = work + fx.num_edges
            with _step_range(d):
                red, hp, res_w, gat_w = _sweep(fx, d, state_d, fx.ones_act,
                                               fx.tiles_static, True)
            red = iterate._apply_epilogue(comps, red)
            new_d = iterate._recompute_merge(plans, fx.comps_by_idx, state_d,
                                             red, hp)
        pushes += d == "push"
        res_work = res_work + res_w
        gather_work = gather_work + gat_w
        new = tuple(new_d[cr.idx] for cr in comps)
        ch = iterate._changed(comps, new, state, fx.tol)
        if fx.sentinel:
            div = div | iterate._divergence(comps, new)
            resid = iterate._residual(comps, new, state)
            ch = ch & ~div
        state, active = new, ch
        k += 1
    return (state, active, k, work, pushes, res_work, gather_work, div,
            resid), emptied


def _finish(fx: _Fixpoint, carry) -> iterate.IterationResult:
    (state, active, k, work, pushes, res_work, gather_work, div,
     resid) = carry
    n = fx.g.n
    out = iterate._finish(fx.comps, tuple(s[:n] for s in state), active[:n],
                          k, work, div, resid)
    out.push_iters = pushes
    out.pull_iters = k - pushes
    out.resolve_work = int(res_work)
    out.gather_work = int(gather_work)
    return out


# ---------------------------------------------------------------------------
# Batched queries: B sources of one round over the one shared layout.
# ---------------------------------------------------------------------------

def iterate_cuda_batch(g: Graph, comps, plans, sources,
                       max_iter: Optional[int] = None, tol: float = 0.0,
                       direction: str = "auto",
                       dense_threshold: float = DENSE_FRONTIER,
                       switch_k="auto",
                       push_resolution: str = PUSH_RESOLUTION,
                       divergence_sentinel: bool = True, init_state=None,
                       plan=None) -> iterate.IterationResult:
    """B queries of one fused round, each to its own fixpoint, with one
    launch of each sweep kernel per iteration for the whole batch: the
    port of ``repro.kernels.ops.iterate_pallas_batch``.

    ``sources`` is a [B] sequence of query sources (applied to every
    sourced component) or a [B, n_comps] array of per-component sources.
    The carry is ``iterate_cuda``'s nine fields with a slot axis: [B,
    n_pad] state per component and frontier, and per slot the iteration
    count, the work counters, the divergence flag and the residual.  Each
    iteration reads every slot's frontier count and edge mass in one host
    read; each live slot takes its own direction by the Gemini rule, the
    pulling slots share one pull launch and the pushing ones one push and
    one resolve launch.  A slot whose frontier is empty, or that reached
    ``max_iter``, is frozen: its carry no longer changes.  Inside a sweep a
    slot computes what its solo query computes, and the bookkeeping around
    it is elementwise per slot, so every slot's result is bitwise its solo
    ``iterate_cuda`` query's, counters included.

    ``init_state`` warm-starts every slot from one per-component [B, n]
    array (the continuous-batching join hook): each row overrides that
    slot's initial state and the frontier starts all ones.  A batch runs
    whole: no checkpoints, as in the reference ("chunked execution does not
    batch").  Knobs and ``plan`` act as in ``iterate_cuda``, and so does
    the kernel-fault rule: a recoverable failure inside the set-up or the
    loop, out-of-memory aside, is raised as a ``KernelLaunchError``.

    Returns an ``IterationResult`` whose ``state`` entries are [B, n]
    device tensors and whose ``iterations``, ``edge_work``, ``converged``,
    ``diverged``, ``active_count``, ``residual``, ``push_iters``,
    ``pull_iters``, ``resolve_work`` and ``gather_work`` are per-slot
    lists."""
    srcs = _batch_sources(comps, sources)
    with _kernel_faults():
        fx = _Fixpoint(g, comps, plans, max_iter, tol, direction,
                       dense_threshold, switch_k, push_resolution,
                       divergence_sentinel, plan)
        carry = _init_batch_carry(fx, srcs)
        if init_state is not None:
            carry = _warm_start_carry(carry, comps, init_state, g.n)
        return _finish_batch(fx, _advance_batch(fx, carry))


def _batch_sources(comps, sources) -> np.ndarray:
    """[B] query sources or [B, n_comps] per-component sources → [B,
    n_comps], −1 for a sourceless component."""
    srcs = np.asarray(sources, dtype=np.int64)
    if srcs.ndim == 1:
        per_comp = np.array([-1 if cr.source is None else 0 for cr in comps])
        srcs = np.where(per_comp[None, :] < 0, per_comp[None, :],
                        srcs[:, None])
    if srcs.ndim != 2 or srcs.shape[1] != len(comps) or not len(srcs):
        raise ValueError(f"sources must be [B] or [B, {len(comps)}] with "
                         f"B >= 1, got shape {srcs.shape}")
    return srcs


def _init_batch_carry(fx: _Fixpoint, srcs) -> tuple:
    """The batch's cold carry: slot b is ``_init_carry`` of its sources
    (state rows, all-ones frontier, zero counters).  ``k`` and ``pushes``
    are host lists; the rest lie on the graph's device with a leading
    slot axis."""
    dev, b = fx.g.device, len(srcs)
    rows = [_padded_init_state(
        fx.comps, fx.g.n, fx.n_pad,
        {cr.idx: int(s) for cr, s in zip(fx.comps, row)
         if cr.source is not None}, dev) for row in srcs]
    state = tuple(torch.stack([r[i] for r in rows])
                  for i in range(len(fx.comps)))
    active = torch.ones((b, fx.n_pad), dtype=torch.bool, device=dev)
    zero = torch.zeros(b, dtype=torch.int64, device=dev)
    div = torch.zeros(b, dtype=torch.bool, device=dev)
    resid = torch.zeros(b, dtype=torch.float32, device=dev)
    return (state, active, [0] * b, zero, [0] * b, zero, zero, div, resid)


def _advance_batch(fx: _Fixpoint, carry) -> tuple:
    """Run every slot to its fixpoint or to ``max_iter``.  Per iteration
    one host read of every slot's frontier count (and edge mass, where the
    Gemini switch reads it); the live slots split by direction, each
    direction one group step (``_batch_step``)."""
    (state, active, k, work, pushes, res_work, gather_work, div,
     resid) = carry
    k, pushes = list(k), list(pushes)
    switching = fx.idempotent and len(fx.use) == 2
    while True:
        if switching and fx.switch_k is not None:
            n_act, e_frontier = torch.stack(
                [active.sum(1), (active * fx.out_deg_raw).sum(1)]).tolist()
        elif switching:
            n_act = active.sum(1).tolist()
        else:
            n_act = active.any(1).tolist()
        live = [b for b, a in enumerate(n_act) if a and k[b] < fx.max_iter]
        if not live:
            break
        if not switching:
            groups = ((fx.use[0], live),)
        else:
            if fx.switch_k is not None:
                push = [e_frontier[b] <= fx.num_edges / fx.switch_k
                        for b in live]
            else:
                push = [n_act[b] / fx.g.n <= fx.dense_threshold
                        for b in live]
            groups = (("pull", [b for b, p in zip(live, push) if not p]),
                      ("push", [b for b, p in zip(live, push) if p]))
        for d, rows in groups:
            if not rows:
                continue
            (state, active, work, res_work, gather_work, div,
             resid) = _batch_step(fx, d, rows, state, active, work,
                                  res_work, gather_work, div, resid)
            for b in rows:
                pushes[b] += d == "push"
        for b in live:
            k[b] += 1
    return (state, active, k, work, pushes, res_work, gather_work, div,
            resid)


def _batch_step(fx: _Fixpoint, d: str, rows, state, active, work, res_work,
                gather_work, div, resid) -> tuple:
    """One iteration of the slots ``rows``, all in direction ``d``: one
    sweep launch (pull, or push then resolve) over their rows, then the
    solo loop body's merge, change, sentinel and counters per slot, written
    back into those rows.  Every other slot's carry stays as it was."""
    comps, dev = fx.comps, active.device
    whole = len(rows) == active.shape[0]
    idx = None if whole else torch.tensor(rows, device=dev)

    def take(t):
        return t if whole else t.index_select(0, idx)

    def put(t, part):
        return part if whole else t.index_copy(0, idx, part)

    def add(t, inc):
        inc = torch.as_tensor(inc, dtype=torch.int64, device=dev) \
            .expand(len(rows))
        return t + inc if whole else t.index_add(0, idx, inc.contiguous())

    st = tuple(take(s) for s in state)
    state_d = {cr.idx: st[i] for i, cr in enumerate(comps)}
    if fx.idempotent:
        active_i32 = take(active).to(torch.int32)
        e = fx.ell[d]
        if d == "pull":
            # the kernel derives each slot's frontier tile activity
            with _step_range("pull"):
                red, tile_act = _er.fused_ell_sweep_frontier(
                    fx.rnd, e.nbrs, e.weight, e.capacity, e.mask,
                    e.tiles_static, state_d, active_i32, fx.out_deg_pad,
                    fx.wdeg_pad, fx.nv)
            res_w = gat_w = 0
        else:
            with _step_range("push"):
                tile_act = _er.tile_activity_push(e.tile_nnz, active_i32)
                red, _hp, res_w, gat_w = _sweep(fx, d, state_d, active_i32,
                                                tile_act, False)
        w = (e.tile_nnz.to(torch.int64) * tile_act).sum((-2, -1))
        new_d = {}
        for p in fx.plans:
            new_d.update(iterate.plan_merge(p, state_d, red,
                                            fx.comps_by_idx))
    else:
        w = fx.num_edges
        with _step_range(d):
            red, hp, res_w, gat_w = _sweep(fx, d, state_d, fx.ones_act,
                                           fx.tiles_static, True)
        red = iterate._apply_epilogue(comps, red)
        new_d = iterate._recompute_merge(fx.plans, fx.comps_by_idx, state_d,
                                         red, hp)
    new = tuple(new_d[cr.idx] for cr in comps)
    ch = iterate._changed(comps, new, st, fx.tol)
    dv, rs = take(div), take(resid)
    if fx.sentinel:
        dv = dv | iterate._divergence(comps, new)
        rs = iterate._residual(comps, new, st)
        ch = ch & ~dv[:, None]
    return (tuple(put(s, n) for s, n in zip(state, new)), put(active, ch),
            add(work, w), add(res_work, res_w), add(gather_work, gat_w),
            put(div, dv), put(resid, rs))


def _finish_batch(fx: _Fixpoint, carry) -> iterate.IterationResult:
    (state, active, k, work, pushes, res_work, gather_work, div,
     resid) = carry
    n = fx.g.n
    act_n, work, res_work, gather_work, div = torch.stack(
        [active[:, :n].sum(1), work, res_work, gather_work,
         div.to(torch.int64)]).tolist()
    out = iterate.IterationResult(
        state=tuple(s[:, :n] for s in state), iterations=list(k),
        edge_work=work,
        converged=[not d and a == 0 for d, a in zip(div, act_n)],
        diverged=[bool(d) for d in div], active_count=act_n,
        residual=resid.tolist())
    out.push_iters = list(pushes)
    out.pull_iters = [a - p for a, p in zip(k, pushes)]
    out.resolve_work = res_work
    out.gather_work = gather_work
    return out
