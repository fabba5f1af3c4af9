"""The single-device fixpoint of the ``cuda`` engine.

The port of ``repro.kernels.ops.iterate_pallas`` (single-device, unbatched,
unchunked): the same fixpoint semantics as ``iterate.iterate_graph``, with
every edge sweep executed by the hand-written CUDA kernels of
``edge_reduce``.  One iteration launches either the pull kernel or the
push kernel followed by the sorted-resolution kernel.

``lax.while_loop`` becomes a host loop that reads the frontier once per
iteration (together with the frontier's edge mass when the direction
switch needs it); ``lax.cond`` becomes a Python branch on the Gemini rule
— push while Σ out_deg(frontier) ≤ |E|/k, ``SWITCH_K`` = 20 by default,
``switch_k=None`` falling back to the ``DENSE_FRONTIER`` vertex fraction.
Non-idempotent rounds run the pull− recompute with the fused has-pred
probe, or push− with sorted resolution under ``model="push"``.

The carry is the reference's nine fields: state, active, k, work, pushes,
resolve work, gather work, divergence, residual.  The work counters are
int64 on the device (the reference accumulates them in float32, exact only
below 2²⁴) and are read once, at the end.  Checkpointed and warm-started
fixpoints, ``delta=`` seeding and batches belong to later slices.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import iterate
from repro_torch.core.plan import (DENSE_FRONTIER, PUSH_RESOLUTION,
                                   _check_resolution, _normalize_switch_k,
                                   _plan_levels, assert_normalized)
from repro_torch.graph.structure import (Graph, blocked_ell_cached,
                                         push_resolution_cached, w_out_deg)
from repro_torch.kernels import edge_reduce as _er


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


def iterate_cuda(g: Graph, comps, plans, max_iter: Optional[int] = None,
                 tol: float = 0.0, direction: str = "auto",
                 dense_threshold: float = DENSE_FRONTIER,
                 switch_k="auto", push_resolution: str = PUSH_RESOLUTION,
                 sources: Optional[dict] = None,
                 divergence_sentinel: bool = True,
                 plan=None) -> iterate.IterationResult:
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
    ``IterationResult``."""
    n = g.n
    dev = g.device
    max_iter = max_iter if max_iter is not None else 2 * n + 4
    idempotent = all(iterate.plan_idempotent(p) for p in plans)
    if plan is not None:
        assert_normalized(plan)
        direction, dense_threshold = plan.direction, plan.dense_threshold
        switch_k, push_resolution = plan.switch_k, plan.push_resolution
        divergence_sentinel = plan.divergence_sentinel
        use = _directions_used(direction, idempotent)
    else:
        use = _directions_used(direction, idempotent)
        switch_k = _normalize_switch_k(
            switch_k, dense_threshold if len(use) == 2 else DENSE_FRONTIER)
        push_resolution = _check_resolution(push_resolution)
    rnd = sweep_round(comps, plans)
    comps_by_idx = {cr.idx: cr for cr in comps}
    ell = {"pull": blocked_ell_cached(g, direction="in") if "pull" in use
           else None,
           "push": blocked_ell_cached(g, direction="out") if "push" in use
           else None}
    sorted_res = push_resolution == "sorted" and "push" in use
    res = push_resolution_cached(g) if sorted_res else None
    first = ell[use[0]]
    n_pad = first.n_pad
    out_deg = g.out_deg
    out_deg_pad = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    out_deg_pad[:n] = out_deg.clamp(min=1).to(torch.float32)
    # unclamped degrees for the Gemini |E_frontier| estimate (exact int64)
    out_deg_raw = torch.zeros(n_pad, dtype=torch.int64, device=dev)
    out_deg_raw[:n] = out_deg.to(torch.int64)
    wdeg_pad = torch.ones(n_pad, dtype=torch.float32, device=dev)
    wdeg_pad[:n] = w_out_deg(g)
    num_edges = int(first.tile_nnz.sum())
    nv = float(n)

    tiles_static = (first.tile_nnz > 0).to(torch.int32)
    # A non-idempotent round sweeps every tile each iteration, so under
    # sorted resolution its resolution-tile activity and the has-pred
    # probe's source rows are the same every iteration: computed once here.
    res_static, res_src_row = None, None
    if sorted_res and not idempotent:
        res_static = _er.resolution_tile_activity(res.contrib, tiles_static,
                                                  res.tile_nnz)
        res_src_row = torch.div(res.in2out, ell["push"].width,
                                rounding_mode="floor")

    def sweep(d, state_d, active_i32, tile_act, need_hp):
        """One sweep + its resolution → (red, hp, resolve work, gather
        work)."""
        e = ell[d]
        args = (e.nbrs, e.weight, e.capacity, e.mask, tile_act, state_d,
                active_i32, out_deg_pad, wdeg_pad, nv, need_hp)
        if d == "pull":
            red, hp = _er.fused_ell_sweep(rnd, *args)
            return red, hp, 0, 0
        if sorted_res:
            res_act = res_static if res_static is not None else \
                _er.resolution_tile_activity(res.contrib, tile_act,
                                             res.tile_nnz)
            red, hp = _er.fused_ell_push_sweep(
                rnd, *args, resolution="sorted",
                res=(res.in2out, res.valid, res_act),
                res_src_row=res_src_row)
            res_w = (res.tile_nnz.to(torch.int64) * res_act).sum()
            return red, hp, res_w, res_w
        red, hp = _er.fused_ell_push_sweep(rnd, *args, resolution="scatter")
        return red, hp, e.nbrs.numel(), 0

    state = _padded_init_state(comps, n, n_pad, sources, dev)
    active = torch.ones(n_pad, dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    work, res_work, gather_work = zero, zero, zero
    div = torch.zeros((), dtype=torch.bool, device=dev)
    resid = torch.zeros((), dtype=torch.float32, device=dev)
    ones_act = torch.ones(n_pad, dtype=torch.int32, device=dev)
    k = pushes = 0
    while k < max_iter:
        switching = idempotent and len(use) == 2
        if switching and switch_k is not None:
            # one host read per iteration: frontier non-empty + edge mass
            n_act, e_frontier = torch.stack(
                [active.sum(), (active * out_deg_raw).sum()]).tolist()
            use_push = e_frontier <= num_edges / switch_k
        elif switching:
            # the reference's frontier fraction: the padded frontier over n
            n_act = int(active.sum())
            use_push = n_act / n <= dense_threshold
        else:
            n_act = int(active.any())
        if n_act == 0:
            break
        state_d = {cr.idx: state[i] for i, cr in enumerate(comps)}
        if idempotent:
            active_i32 = active.to(torch.int32)
            d = ("push" if use_push else "pull") if switching else use[0]
            e = ell[d]
            if d == "pull":
                tile_act = _er.tile_activity(e.nbrs, e.mask, e.tile_nnz,
                                             active_i32)
            else:
                tile_act = _er.tile_activity_push(e.tile_nnz, active_i32)
            red, _hp, res_w, gat_w = sweep(d, state_d, active_i32, tile_act,
                                           False)
            work = work + (e.tile_nnz.to(torch.int64) * tile_act).sum()
            new_d = {}
            for p in plans:
                new_d.update(iterate.plan_merge(p, state_d, red,
                                                comps_by_idx))
        else:
            d = use[0]
            work = work + num_edges
            red, hp, res_w, gat_w = sweep(d, state_d, ones_act, tiles_static,
                                          True)
            red = iterate._apply_epilogue(comps, red)
            new_d = iterate._recompute_merge(plans, comps_by_idx, state_d,
                                             red, hp)
        pushes += d == "push"
        res_work = res_work + res_w
        gather_work = gather_work + gat_w
        new = tuple(new_d[cr.idx] for cr in comps)
        ch = iterate._changed(comps, new, state, tol)
        if divergence_sentinel:
            div = div | iterate._divergence(comps, new)
            resid = iterate._residual(comps, new, state)
            ch = ch & ~div
        state, active = new, ch
        k += 1
    out = iterate._finish(comps, tuple(s[:n] for s in state), active[:n], k,
                          work, div, resid)
    out.push_iters = pushes
    out.pull_iters = k - pushes
    out.resolve_work = int(res_work)
    out.gather_work = int(gather_work)
    return out
