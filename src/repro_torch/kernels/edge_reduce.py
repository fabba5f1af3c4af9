"""Blocked-ELL edge sweeps of a fused round: CUDA kernels and plain versions.

The port of ``repro.kernels.edge_reduce``.  Three tile passes carry the
fixpoint, each a hand-written CUDA kernel (``csrc/edge_sweep.cuh``,
instantiated per fused round from the round's synthesized P expressions by
``synthesis.emit_cuda_round`` and built by ``kernels/build.py``):

``pull_sweep``    — the pull sweep (replaces ``_fused_kernel``): per (8 × 128)
                    tile, gather each component's state once, apply every P
                    with the C3 guard, run each plan's lexicographic chain and
                    write one candidate per (row, slot tile) per level, plus
                    the fused has-pred probe; ``pull_sweep_frontier`` is the
                    same kernel deriving the frontier's tile activity itself
                    (an output) from the layout's static tiles.
``push_sweep``    — the push sweep (replaces ``_push_kernel``): per-edge
                    candidates over the out-layout, written on the card only
                    into the tiles the frontier keeps.
``resolve_sweep`` — the dst-sorted push resolution (replaces
                    ``_resolve_kernel``): gather candidates through
                    ``in2out`` inside the tile skip, only from out-tiles the
                    push sweep ran, then the pull sweep's lex chain, plus the
                    fused has-pred probe of the push− models.

The three kernels walk only their live tiles: a grid sized to the card
deals the tiles to its blocks in turn, each block reads its tiles'
activity words and a ballot hands it the active ones, so an iteration
moves its live tiles and not the whole rectangle.  The pull kernel's
derived mode walks the layout's static non-empty tiles and decides per
tile, by a vote of the whole block, whether a real slot has an active
source; the frontier's pull tile activity then needs no torch gather over
the rectangle.

Batched queries: the three sweeps take a leading slot axis.  With [S,
n_pad] states a call sweeps S queries over the one shared layout in one
launch, each slot with its own frontier, tile activity and outputs (or
one every slot shares), and each slot's outputs are the bits of its solo
sweep; the plain version of a batch is the solo plain version per slot,
stacked.

``ell_level_reduce`` (replaces ``_level_kernel``) is the per-level reference
sweep outside the main path: one lex level per call into a [n_pad]
vector, its kernels generated per (P expressions, monoid, mode) by
``synthesis.emit_cuda_level`` from ``csrc/edge_level.cuh``.  Its walk
visits, on the same grid as the sweeps, the tiles that the layout's
``tile_nnz`` counts non-empty and writes one partial per (row, slot tile);
a combine kernel folds each row's partials in slot-tile order.  The plain
version combines every tile, and the two agree bitwise all the same.

Each wrapper launches its kernel for CUDA tensors (checking device, dtype,
shape, contiguity and the launch status) and counts the launch in
``LAUNCHES``; for CPU tensors it runs the kernel's plain PyTorch version,
which repeats the kernel's arithmetic and its fixed reduction order
(each lane's 4 slots in order, then a halving tree over the 32 lanes), so
kernel and plain version agree bitwise on the card.  There is no fallback
from a CUDA tensor to the plain version.

``fused_ell_sweep`` / ``fused_ell_sweep_frontier`` / ``fused_ell_push_sweep``
wrap the tile passes with the cross-tile fold (``_fold_tile_candidates``,
torch, shared by pull and sorted push so push(sorted) ≡ pull bitwise) and
the push resolutions; the other tile-activity helpers are torch ops
(``tile_activity`` stays as the derived mode's plain version).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.core.guard import KernelBuildError
from repro_torch.core.iterate import cast_like
from repro_torch.graph import segment
from repro_torch.kernels.launch import check as _check
from repro_torch.kernels.launch import raise_on as _raise_on
from repro_torch.kernels.launch import stream as _stream

BLOCK_V = 8
BLOCK_E = 128
_LANES = 32
_SLOTS = BLOCK_E // _LANES
_MAX_PTRS = 16                   # pointers in a kernel's Ptrs argument ...
_PTRS_CAP = 64                   # ... widened per round unit up to this
_PLAIN_CHUNK = 1 << 24           # slots per plain-version chunk (memory cap)
# A batched launch walks its (tile, slot) items tile-major, so that a
# layout tile comes from device memory once for all its query slots, unless
# the slots' vertex words (each component's state and one more vector, the
# frontier or the push activity; the words the slots gather at random grow
# with them) exceed half the card's L2 together: then slot-major, one
# slot's words in L2 at a time.  On an H100 (50 MB of L2) with the 2^21-
# vertex uniform graph (8 slots of 24 MB), tile-major took the batched BFS
# pull 2.5 times as long as 8 solo launches, slot-major 1.1 to 1.2 times;
# on rmat_graph(65536, 1048576) (8 slots of 0.8 MB) tile-major was the
# faster order for every kernel (benchmarks/torch_batch_probe.py, PERF.md
# §6).  Where the crossover lies between those two points was not
# measured; half the L2 is a guess inside that range.
# Tests and probes force an order: "tile" or "slot"; None decides by size.
_SLOT_ORDER: Optional[str] = None

# boolean monoids run as int32 min/max inside the kernels
_INT_OP = {"or": "max", "and": "min"}

# Runtime launch counts of the four kernels: each wrapper adds one where it
# launches its kernel on the card, and nowhere else.
LAUNCHES = {"pull": 0, "push": 0, "resolve": 0, "level": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def comps_in_plan_order(plans):
    """Component ids in first-appearance order over the static plan specs
    ((comp, op) lex levels, primary first) — the kernels' component order."""
    order = []
    for spec in plans:
        for c, _op in spec:
            if c not in order:
                order.append(c)
    return order


class SweepRound:
    """The static shape of one fused round as the sweeps see it: component
    order, state dtypes, identities, P (as closures for the plain versions
    and as ``Expr``s for the generated kernels) and the plans' lex levels in
    kernel form.  ``library()`` builds (on first use) and loads the round's
    CUDA library."""

    def __init__(self, plans, dtypes: dict, idents: dict, p_fns: dict,
                 p_exprs: Optional[dict] = None):
        self.plans = tuple(tuple(spec) for spec in plans)
        self.comps_order = comps_in_plan_order(self.plans)
        pos_of = {c: k for k, c in enumerate(self.comps_order)}
        self.plan_specs = tuple(
            tuple((pos_of[c], _INT_OP.get(op, op)) for c, op in spec)
            for spec in self.plans)
        self.dtypes = [dtypes[c] for c in self.comps_order]
        self.idents = [_scalar(idents[c], dtypes[c])
                       for c in self.comps_order]
        self.p_fns = [p_fns[c] for c in self.comps_order]
        self.p_exprs = None if p_exprs is None else \
            [p_exprs.get(c) for c in self.comps_order]
        self.n_levels = sum(len(s) for s in self.plan_specs)
        # a wide round (more outputs than the default Ptrs holds) gets its
        # own wider Ptrs; every other round keeps the default, and with it
        # its unit's source and library
        need = self.n_levels + len(self.comps_order)
        self.max_ptrs = max(_MAX_PTRS, -(-need // _MAX_PTRS) * _MAX_PTRS)
        self._lib = None

    def source(self) -> str:
        from repro_torch.core.synthesis import emit_cuda_round
        if self.p_exprs is None or any(e is None for e in self.p_exprs):
            raise KernelBuildError(
                "this round has no P expression for every component, so no "
                "CUDA kernel can be generated for it")
        if self.max_ptrs > _PTRS_CAP:
            raise KernelBuildError(f"round too wide for the sweep kernels: "
                                   f"{self.n_levels} levels + "
                                   f"{len(self.comps_order)} components > "
                                   f"{_PTRS_CAP} outputs")
        src = emit_cuda_round(
            self.p_exprs,
            ["float" if d == torch.float32 else "int" for d in self.dtypes],
            self.idents, self.plan_specs)
        if self.max_ptrs > _MAX_PTRS:
            src = f"#define GRAFS_MAX_PTRS {self.max_ptrs}\n" + src
        return src

    def library(self):
        if self._lib is None:
            from repro_torch.kernels import build
            self._lib = build.round_library(self.source())
        return self._lib

    def walk_attributes(self) -> dict:
        """Registers per thread and grid (blocks) of the kernels that walk
        their tiles on a grid sized to the card: push, resolve, and pull
        with the given and with the derived activity, solo and batched
        (needs the card)."""
        out = (ctypes.c_int * 16)()
        _raise_on(self.library().grafs_walk_attributes(out), "attributes")
        names = ("push", "resolve", "pull", "pull_derived")
        names += tuple(f"batched_{k}" for k in names)
        return {f"{k}_{what}": out[2 * i + w] for i, k in enumerate(names)
                for w, what in enumerate(("registers", "grid"))}


def _scalar(ident, dtype):
    return float(ident) if dtype.is_floating_point else int(ident)


# ---------------------------------------------------------------------------
# Shared pieces of the plain versions.
# ---------------------------------------------------------------------------

def _combine(op: str, a, b):
    if op == "min":
        return torch.minimum(a, b)
    if op == "max":
        return torch.maximum(a, b)
    if op == "sum":
        return a + b
    return a * b


def _tile_reduce(op: str, vals):
    """[R, width] → [R, width/128]: the kernels' reduction order — each
    lane's 4 contiguous slots folded in order, then the warp's halving tree
    over offsets 16..1 (lane i combines with lane i + offset)."""
    r, width = vals.shape
    v = vals.reshape(r, width // BLOCK_E, _LANES, _SLOTS)
    acc = v[..., 0]
    for s in range(1, _SLOTS):
        acc = _combine(op, acc, v[..., s])
    off = _LANES // 2
    while off >= 1:
        acc = _combine(op, acc[..., :off], acc[..., off:2 * off])
        off //= 2
    return acc[..., 0]


def _lex_chain(rnd: SweepRound, vals, mask):
    """The kernels' lex chain over [R, width] values: per plan, tie starts
    at ``mask``; every level reduces over the tied slots and narrows tie to
    the slots equal to its best.  Returns one [R, n_j] array per level."""
    outs = []
    for spec in rnd.plan_specs:
        tie = mask
        for li, (pos, op) in enumerate(spec):
            ident = rnd.idents[pos]
            masked = torch.where(tie, vals[pos], ident)
            best = _tile_reduce(op, masked)
            outs.append(best)
            if li + 1 < len(spec):
                rep = best.repeat_interleave(BLOCK_E, dim=1)
                tie = tie & (vals[pos] == rep)
    return outs


def _row_chunks(n_pad: int, width: int):
    rows = max(BLOCK_V, (_PLAIN_CHUNK // max(width, 1)) // BLOCK_V * BLOCK_V)
    for r0 in range(0, n_pad, rows):
        yield r0, min(n_pad, r0 + rows)


def _tiles_to_rows(tile_act):
    return tile_act.repeat_interleave(BLOCK_V, dim=0) != 0


# ---------------------------------------------------------------------------
# Kernel launch plumbing.
# ---------------------------------------------------------------------------

def _ptrs(tensors):
    arr = (ctypes.c_void_p * max(_MAX_PTRS, len(tensors)))()
    for k, t in enumerate(tensors):
        arr[k] = t.data_ptr()
    return arr


def _check_layout(rect, tile_act, lead=()):
    """Check a layout rectangle and the tile activity walked over it
    (shared, or one per query slot when ``lead`` is the slot axis); returns
    the activity's slot stride."""
    n_pad, width = rect.shape
    if n_pad % BLOCK_V or width % BLOCK_E:
        raise ValueError(f"layout {n_pad}×{width} is not a whole number of "
                         f"({BLOCK_V}, {BLOCK_E}) tiles")
    if n_pad * width >= 2 ** 31:
        raise ValueError(f"layout {n_pad}×{width} overflows int32 indexing")
    return _slot_stride("tile_act", tile_act, torch.int32,
                        (n_pad // BLOCK_V, width // BLOCK_E), lead)


# ---------------------------------------------------------------------------
# The slot axis of batched sweeps.  A batched sweep takes its states with a
# leading axis of S query slots (one [S, n_pad] array per component) and
# returns its outputs with that axis; each per-slot input (frontier, tile
# activity, candidates) comes with the axis, or without it when every slot
# shares it.  The layout is always shared.  On the card one launch covers
# every slot; the plain version is the solo plain version per slot,
# stacked.
# ---------------------------------------------------------------------------

def _lead(states):
    """The slot axis of a sweep: ``(S,)`` for [S, n_pad] states, ``()``
    for a solo sweep's [n_pad] states."""
    return tuple(states[0].shape[:1]) if states and states[0].dim() == 2 \
        else ()


def _slot(t, solo_ndim: int, s: int):
    """Slot ``s``'s part of a per-slot input, which may be shared (it then
    has its solo number of axes, ``solo_ndim``)."""
    return t[s] if t.dim() == solo_ndim + 1 else t


def _slot_stride(name, t, dtype, shape, lead) -> int:
    """Check a per-slot card input, ``lead + shape`` (one array per slot)
    or ``shape`` (one array every slot shares); its slot stride in
    elements, 0 when shared."""
    shape = tuple(shape)
    if lead and t.dim() == len(shape) + 1:
        _check(name, t, dtype, lead + shape)
        return math.prod(shape)
    _check(name, t, dtype, shape)
    return 0


def _slots(lead, device, gathered=0, tiles=0, act_out=0, active=0, state=0,
           out=0, push_act=0, cand=0):
    """A launch's slot count, its item order and its per-slot strides, in
    the order of ``struct Slots`` (csrc/edge_sweep.cuh).  ``gathered`` is
    one slot's vertex words (its states and frontier or push activity):
    the walk goes slot-major where the slots' together exceed half the L2
    of ``device``."""
    n = lead[0] if lead else 1
    strides = (ctypes.c_longlong * 7)(tiles, act_out, active, state, out,
                                      push_act, cand)
    if _SLOT_ORDER is not None:
        slot_major = _SLOT_ORDER == "slot"
    else:
        slot_major = n > 1 and n * gathered > _l2_bytes(device) // 2
    return n, int(slot_major), strides


@functools.lru_cache(maxsize=None)
def _l2_bytes(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).L2_cache_size


def _stack_slots(solo, n: int):
    """The batched form of a plain version: ``solo(s)`` (a list of arrays)
    for each of the ``n`` slots, stacked array by array."""
    per = [solo(s) for s in range(n)]
    return [torch.stack(cols) for cols in zip(*per)]


# ---------------------------------------------------------------------------
# The pull sweep (replaces edge_reduce.py::_fused_kernel).
# ---------------------------------------------------------------------------

def pull_sweep(rnd: SweepRound, tile_act, srcs, weight, capacity, mask,
               active, outdeg, wdeg, states, nv: float,
               need_hp: bool = False, out=None):
    """Per-tile candidates of the pull sweep with the given tile activity:
    a list with one [n_pad, n_j] array per lex level (plan order), then,
    with ``need_hp``, one int32 [n_pad, n_j] has-pred array per component.
    ``states`` lists the [n_pad] state vectors in ``rnd.comps_order``;
    ``active`` is int32.  A tile that ``tile_act`` skips holds the
    identities (has-pred 0).  ``out``, preallocated arrays of those shapes
    and dtypes, receives the result.

    Batched: with [S, n_pad] states the sweep runs S query slots in one
    launch and every output gains the leading slot axis; ``active`` is
    [S, n_pad] and ``tile_act`` [S, n_i, n_j], or either without the axis
    when the slots share it."""
    return _pull(rnd, tile_act, False, srcs, weight, capacity, mask, active,
                 outdeg, wdeg, states, nv, need_hp, out)[0]


def pull_sweep_frontier(rnd: SweepRound, tiles_static, srcs, weight,
                        capacity, mask, active, outdeg, wdeg, states,
                        nv: float, need_hp: bool = False, out=None):
    """The pull sweep with the frontier's tile activity derived inside the
    kernel.  ``tiles_static`` is the layout's static tile list
    (``BlockedELL.tiles_static``, int32 ``tile_nnz > 0``).  Returns ``(outs,
    tile_act)``: ``tile_act`` is the int32 [n_i, n_j] frontier tile
    activity, bitwise ``tile_activity(srcs, mask, tile_nnz, active)``, and
    ``outs`` what ``pull_sweep`` returns for it.  ``out`` lists
    preallocated arrays for ``outs`` followed by one for ``tile_act``.
    Batched as ``pull_sweep`` (``tile_act`` per slot, ``tiles_static``
    shared)."""
    return _pull(rnd, tiles_static, True, srcs, weight, capacity, mask,
                 active, outdeg, wdeg, states, nv, need_hp, out)


def _pull(rnd, tiles, derive, srcs, weight, capacity, mask, active, outdeg,
          wdeg, states, nv, need_hp, out):
    """Both pull modes: ``tiles`` is the tile activity (``derive`` False)
    or the static tile list (``derive`` True).  Returns (outs, derived
    activity or None)."""
    n_pad, width = srcs.shape
    n_i, n_j = n_pad // BLOCK_V, width // BLOCK_E
    lead = _lead(states)
    name = "tiles_static" if derive else "tile_act"
    per_slot = bool(lead) and not derive and tiles.dim() == 3
    if tuple(tiles.shape[per_slot:]) != (n_i, n_j) or \
            tiles.dtype != torch.int32 or \
            (per_slot and tuple(tiles.shape[:1]) != lead):
        raise ValueError(f"{name} must be int32 of the layout's tile grid "
                         f"{(n_i, n_j)}, got {tiles.dtype} "
                         f"{tuple(tiles.shape)}")
    dtypes = [rnd.dtypes[pos] for spec in rnd.plan_specs
              for pos, _op in spec] + [torch.int32] * (len(states) * need_hp)
    n_out = len(dtypes) + derive
    if out is not None and len(out) != n_out:
        raise ValueError(f"out needs {n_out} arrays, got {len(out)}")
    if not srcs.is_cuda:
        act = tile_activity(srcs, mask, tiles, active) if derive else tiles
        got = _pull_plain(rnd, act, srcs, weight, capacity, mask, active,
                          outdeg, wdeg, states, nv, need_hp)
        if derive:
            got.append(act)
        if out is not None:
            for o, g in zip(out, got):
                o.copy_(g)
            got = list(out)
        return (got[:-1], got[-1]) if derive else (got, None)
    t_stride = _check_layout(srcs, tiles, lead)
    for nm, t, dt in (("srcs", srcs, torch.int32),
                      ("weight", weight, torch.float32),
                      ("capacity", capacity, torch.float32),
                      ("mask", mask, torch.bool)):
        _check(nm, t, dt, (n_pad, width))
    a_stride = _slot_stride("active", active, torch.int32, (n_pad,), lead)
    _check("outdeg", outdeg, torch.float32, (n_pad,))
    _check("wdeg", wdeg, torch.float32, (n_pad,))
    for k, (st, dt) in enumerate(zip(states, rnd.dtypes)):
        _check(f"state[{k}]", st, dt, lead + (n_pad,))
    if out is None:
        out = [torch.empty(lead + (n_pad, n_j), dtype=dt, device=srcs.device)
               for dt in dtypes]
        if derive:
            out.append(torch.empty(lead + (n_i, n_j), dtype=torch.int32,
                                   device=srcs.device))
    for k, o in enumerate(out):
        if k < len(dtypes):
            _check(f"out[{k}]", o, dtypes[k], lead + (n_pad, n_j))
        else:
            _check(f"out[{k}]", o, torch.int32, lead + (n_i, n_j))
    outs, act_out = (list(out[:-1]), out[-1]) if derive \
        else (list(out), None)
    lib = rnd.library()
    status = lib.grafs_pull(
        tiles.data_ptr(), None if act_out is None else act_out.data_ptr(),
        srcs.data_ptr(), weight.data_ptr(), capacity.data_ptr(),
        mask.data_ptr(), active.data_ptr(), outdeg.data_ptr(),
        wdeg.data_ptr(), _ptrs(states), _ptrs(outs), n_i * n_j, n_j, width,
        float(nv), int(need_hp),
        *_slots(lead, srcs.device, gathered=n_pad * 4 * (len(states) + 1),
                tiles=t_stride, act_out=n_i * n_j, active=a_stride,
                state=n_pad, out=n_pad * n_j), _stream(srcs))
    _raise_on(status, "pull")
    LAUNCHES["pull"] += 1
    return outs, act_out


def _pull_plain(rnd, tile_act, srcs, weight, capacity, mask, active, outdeg,
                wdeg, states, nv, need_hp):
    lead = _lead(states)
    if lead:
        return _stack_slots(lambda s: _pull_plain(
            rnd, _slot(tile_act, 2, s), srcs, weight, capacity, mask,
            _slot(active, 1, s), outdeg, wdeg, [st[s] for st in states], nv,
            need_hp), lead[0])
    n_pad, width = srcs.shape
    nv_t = torch.tensor(float(nv), dtype=torch.float32, device=srcs.device)
    parts = []
    for r0, r1 in _row_chunks(n_pad, width):
        s = srcs[r0:r1]
        s_l = s.long()
        raw = mask[r0:r1]
        act = raw & (active[s_l] != 0)
        rows = torch.arange(r0, r1, dtype=torch.int32, device=srcs.device)
        env = {"w": weight[r0:r1], "c": capacity[r0:r1], "esrc": s,
               "edst": rows[:, None].expand(r1 - r0, width),
               "outdeg": outdeg[s_l], "wdeg": wdeg[s_l], "nv": nv_t}
        gathered, props = [], []
        for st, dt, ident, p_fn in zip(states, rnd.dtypes, rnd.idents,
                                       rnd.p_fns):
            nvals = st[s_l]
            p = cast_like(p_fn({"n": nvals, **env}), dt, nvals)
            gathered.append(nvals)
            props.append(torch.where(nvals == ident, ident, p))
        outs = _lex_chain(rnd, props, act)
        if need_hp:
            for g, ident in zip(gathered, rnd.idents):
                nb = (raw & (g != ident)).to(torch.int32)
                outs.append(_tile_reduce("max", nb))
        live = _tiles_to_rows(tile_act[r0 // BLOCK_V:r1 // BLOCK_V])
        idents = [rnd.idents[pos] for spec in rnd.plan_specs
                  for pos, _op in spec] + [0] * (len(outs) - rnd.n_levels)
        parts.append([torch.where(live, o, i) for o, i in zip(outs, idents)])
    return [torch.cat(cols) for cols in zip(*parts)]


# ---------------------------------------------------------------------------
# The push sweep (replaces edge_reduce.py::_push_kernel).
# ---------------------------------------------------------------------------

def push_sweep(rnd: SweepRound, tile_act, dsts, weight, capacity, mask,
               active, outdeg, wdeg, states, nv: float, out=None):
    """Per-edge candidates of the push sweep over the out-layout: one
    [n_pad, width] array per component (``rnd.comps_order``).  On every tile
    that ``tile_act`` keeps, a slot holds its P value, or the identity where
    the slot is padding or the source row inactive.

    On the card the kernel writes nothing to a skipped tile: its candidates
    are undefined (whatever ``out`` held, or the fresh allocation's bytes),
    and a reader must go through ``tile_act`` as ``resolve_sweep`` does.
    ``out``, one preallocated [n_pad, width] array per component, receives
    the candidates; a caller that reads the whole rectangle passes it
    identity-filled.  The plain version fills skipped tiles with
    identities.  Batched as ``pull_sweep``: [S, n_pad] states give [S,
    n_pad, width] candidates."""
    lead = _lead(states)
    if not dsts.is_cuda:
        got = _push_plain(rnd, tile_act, dsts, weight, capacity, mask,
                          active, outdeg, wdeg, states, nv)
        if out is None:
            return got
        for o, g in zip(out, got):
            o.copy_(g)
        return list(out)
    n_pad, width = dsts.shape
    t_stride = _check_layout(dsts, tile_act, lead)
    for name, t, dt in (("dsts", dsts, torch.int32),
                        ("weight", weight, torch.float32),
                        ("capacity", capacity, torch.float32),
                        ("mask", mask, torch.bool)):
        _check(name, t, dt, (n_pad, width))
    a_stride = _slot_stride("active", active, torch.int32, (n_pad,), lead)
    _check("outdeg", outdeg, torch.float32, (n_pad,))
    _check("wdeg", wdeg, torch.float32, (n_pad,))
    for k, (st, dt) in enumerate(zip(states, rnd.dtypes)):
        _check(f"state[{k}]", st, dt, lead + (n_pad,))
    if out is None:
        out = [torch.empty(lead + (n_pad, width), dtype=dt,
                           device=dsts.device) for dt in rnd.dtypes]
    elif len(out) != len(rnd.dtypes):
        raise ValueError(f"out needs {len(rnd.dtypes)} arrays, got "
                         f"{len(out)}")
    for k, (o, dt) in enumerate(zip(out, rnd.dtypes)):
        _check(f"out[{k}]", o, dt, lead + (n_pad, width))
    lib = rnd.library()
    n_i, n_j = n_pad // BLOCK_V, width // BLOCK_E
    status = lib.grafs_push(
        tile_act.data_ptr(), dsts.data_ptr(), weight.data_ptr(),
        capacity.data_ptr(), mask.data_ptr(), active.data_ptr(),
        outdeg.data_ptr(), wdeg.data_ptr(), _ptrs(states), _ptrs(out),
        n_i * n_j, n_j, width, float(nv),
        *_slots(lead, dsts.device, tiles=t_stride, active=a_stride,
                state=n_pad, out=n_pad * width), _stream(dsts))
    _raise_on(status, "push")
    LAUNCHES["push"] += 1
    return list(out)


def _push_plain(rnd, tile_act, dsts, weight, capacity, mask, active, outdeg,
                wdeg, states, nv):
    lead = _lead(states)
    if lead:
        return _stack_slots(lambda s: _push_plain(
            rnd, _slot(tile_act, 2, s), dsts, weight, capacity, mask,
            _slot(active, 1, s), outdeg, wdeg, [st[s] for st in states],
            nv), lead[0])
    n_pad, width = dsts.shape
    nv_t = torch.tensor(float(nv), dtype=torch.float32, device=dsts.device)
    parts = []
    for r0, r1 in _row_chunks(n_pad, width):
        shape = (r1 - r0, width)
        rows = torch.arange(r0, r1, dtype=torch.int32, device=dsts.device)
        live = mask[r0:r1] & (active[r0:r1] != 0)[:, None]
        live = live & _tiles_to_rows(tile_act[r0 // BLOCK_V:r1 // BLOCK_V]) \
            .repeat_interleave(BLOCK_E, dim=1)
        env = {"w": weight[r0:r1], "c": capacity[r0:r1],
               "esrc": rows[:, None].expand(shape), "edst": dsts[r0:r1],
               "outdeg": outdeg[r0:r1, None].expand(shape),
               "wdeg": wdeg[r0:r1, None].expand(shape), "nv": nv_t}
        cols = []
        for st, dt, ident, p_fn in zip(states, rnd.dtypes, rnd.idents,
                                       rnd.p_fns):
            nvals = st[r0:r1, None].expand(shape)
            p = cast_like(p_fn({"n": nvals, **env}), dt, nvals)
            p = torch.where(nvals == ident, ident, p)
            cols.append(torch.where(live, p, ident))
        parts.append(cols)
    return [torch.cat(cols) for cols in zip(*parts)]


# ---------------------------------------------------------------------------
# The dst-sorted push resolution (replaces edge_reduce.py::_resolve_kernel).
# ---------------------------------------------------------------------------

def _check_out_layout(cands, push_tile_act, width_out, states, need_hp,
                      lead=()):
    """The out-layout that ``in2out`` indexes: every candidate array is
    [n_pad_out, width_out] (per slot, under ``lead``) and ``push_tile_act``
    its (8, 128) tile grid."""
    if width_out <= 0 or width_out % BLOCK_E:
        raise ValueError(f"width_out {width_out} is not a positive multiple "
                         f"of {BLOCK_E}")
    n_out = cands[0].shape[-2]
    for k, c in enumerate(cands):
        if tuple(c.shape) != lead + (n_out, width_out):
            raise ValueError(f"cands[{k}] has shape {tuple(c.shape)}, not "
                             f"(n_pad, width_out) = ({n_out}, {width_out})"
                             + (f" per slot of {lead[0]}" if lead else ""))
    want = (n_out // BLOCK_V, width_out // BLOCK_E)
    got = tuple(push_tile_act.shape)
    if got not in (want, lead + want):
        raise ValueError(f"push_tile_act has shape {got}, but the "
                         f"out-layout {n_out}×{width_out} has {want} tiles")
    if need_hp:
        for k, st in enumerate(states):
            if tuple(st.shape) != lead + (n_out,):
                raise ValueError(f"state[{k}] must have shape "
                                 f"{lead + (n_out,)}, got {tuple(st.shape)}")


def resolve_sweep(rnd: SweepRound, tile_act, valid, in2out, cands,
                  push_tile_act, width_out: int, states=(),
                  need_hp: bool = False):
    """Per-tile candidates of the sorted resolution over the dst-major
    rectangle: on each tile that ``tile_act`` keeps, every ``valid`` slot
    gathers ``cands[k].flat[in2out]`` where the out-tile holding that index
    ran (``push_tile_act`` over the [n_pad, width_out] out-layout) and takes
    the identity elsewhere, then the pull sweep's lex chain.  Returns one
    [n_pad, n_j] array per lex level, exactly like ``pull_sweep``; with
    ``need_hp``, then one int32 [n_pad, n_j] has-pred array per component:
    1 where a valid slot's source row (``in2out // width_out``) holds a
    non-⊥ state in ``states`` (``rnd.comps_order``).  The probe covers the
    tiles ``tile_act`` keeps (a skipped tile's cells are 0), so a caller
    wanting the reference's booleans passes every live tile.

    Batched: [S, n_pad_out, width_out] candidates (and [S, n_pad_out]
    states) run S query slots in one launch and every output gains the
    leading slot axis; ``tile_act`` and ``push_tile_act`` come per slot or
    shared."""
    if len(cands) != len(rnd.dtypes) or (need_hp and
                                         len(states) != len(rnd.dtypes)):
        raise ValueError(f"resolve_sweep needs {len(rnd.dtypes)} candidate "
                         f"arrays (and states with need_hp), got "
                         f"{len(cands)} and {len(states)}")
    lead = tuple(cands[0].shape[:1]) if cands[0].dim() == 3 else ()
    _check_out_layout(cands, push_tile_act, width_out, states, need_hp, lead)
    if not valid.is_cuda:
        return _resolve_plain(rnd, tile_act, valid, in2out, cands,
                              push_tile_act, width_out, states, need_hp)
    n_pad, width = valid.shape
    t_stride = _check_layout(valid, tile_act, lead)
    _check("valid", valid, torch.bool, (n_pad, width))
    _check("in2out", in2out, torch.int32, (n_pad, width))
    n_out = cands[0].shape[-2]
    p_stride = _slot_stride("push_tile_act", push_tile_act, torch.int32,
                            (n_out // BLOCK_V, width_out // BLOCK_E), lead)
    for k, (c, dt) in enumerate(zip(cands, rnd.dtypes)):
        _check(f"cands[{k}]", c, dt)
    if need_hp:
        for k, (st, dt) in enumerate(zip(states, rnd.dtypes)):
            _check(f"state[{k}]", st, dt)
    lib = rnd.library()
    n_i, n_j = n_pad // BLOCK_V, width // BLOCK_E
    outs = [torch.empty(lead + (n_pad, n_j), dtype=rnd.dtypes[pos],
                        device=valid.device)
            for spec in rnd.plan_specs for pos, _op in spec]
    if need_hp:
        outs += [torch.empty(lead + (n_pad, n_j), dtype=torch.int32,
                             device=valid.device) for _ in states]
    status = lib.grafs_resolve(
        tile_act.data_ptr(), valid.data_ptr(), in2out.data_ptr(),
        push_tile_act.data_ptr(), _ptrs(cands),
        _ptrs(states if need_hp else ()), _ptrs(outs), n_i * n_j, n_j,
        width, int(width_out), int(need_hp),
        *_slots(lead, valid.device, gathered=n_out * 4 * (len(cands) + 1),
                tiles=t_stride, state=n_out, out=n_pad * n_j,
                push_act=p_stride, cand=n_out * width_out), _stream(valid))
    _raise_on(status, "resolve")
    LAUNCHES["resolve"] += 1
    return outs


def _resolve_plain(rnd, tile_act, valid, in2out, cands, push_tile_act,
                   width_out, states=(), need_hp=False):
    if cands[0].dim() == 3:
        return _stack_slots(lambda s: _resolve_plain(
            rnd, _slot(tile_act, 2, s), valid, in2out, [c[s] for c in cands],
            _slot(push_tile_act, 2, s), width_out,
            [st[s] for st in states] if need_hp else (), need_hp),
            cands[0].shape[0])
    n_pad, width = valid.shape
    flat = [c.reshape(-1) for c in cands]
    ran_tiles = push_tile_act.reshape(-1) != 0
    n_j_out = width_out // BLOCK_E
    parts = []
    for r0, r1 in _row_chunks(n_pad, width):
        ok = valid[r0:r1]
        idx = in2out[r0:r1].long()
        src = torch.div(idx, width_out, rounding_mode="floor")
        out_tile = (torch.div(src, BLOCK_V, rounding_mode="floor") * n_j_out
                    + torch.div(idx - src * width_out, BLOCK_E,
                                rounding_mode="floor"))
        ran = ok & ran_tiles[out_tile]
        vals = [torch.where(ran, f[idx], ident)
                for f, ident in zip(flat, rnd.idents)]
        outs = _lex_chain(rnd, vals, ok)
        if need_hp:
            for st, ident in zip(states, rnd.idents):
                nb = (ok & (st[src] != ident)).to(torch.int32)
                outs.append(_tile_reduce("max", nb))
        live = _tiles_to_rows(tile_act[r0 // BLOCK_V:r1 // BLOCK_V])
        idents = [rnd.idents[pos] for spec in rnd.plan_specs
                  for pos, _op in spec] + [0] * (len(outs) - rnd.n_levels)
        parts.append([torch.where(live, o, i) for o, i in zip(outs, idents)])
    return [torch.cat(cols) for cols in zip(*parts)]


# ---------------------------------------------------------------------------
# One lex level per launch (replaces edge_reduce.py::_level_kernel).
# ---------------------------------------------------------------------------

_LEVEL_SOURCES: dict = {}        # (exprs, dtypes, idents, op, mode) → unit


def level_source(p_exprs, dtypes, idents, op: str, mode: str) -> str:
    """The generated CUDA unit of one level kernel (memoized)."""
    from repro_torch.core.synthesis import emit_cuda_level
    names = ["float" if d == torch.float32 else "int" for d in dtypes]
    key = (tuple(map(str, p_exprs)), tuple(names), tuple(map(repr, idents)),
           op, mode)
    if key not in _LEVEL_SOURCES:
        _LEVEL_SOURCES[key] = emit_cuda_level(p_exprs, names, idents, op,
                                              mode)
    return _LEVEL_SOURCES[key]


def ell_level_reduce(ell, op: str, p_exprs, states, idents, active, outdeg,
                     bests=(), mode: str = "value", wdeg=None):
    """Reduce one lex level over the blocked-ELL edges.

    ell       BlockedELL pull layout (``structure.to_blocked_ell``)
    op        monoid of the level being reduced
    p_exprs   propagation functions as ``kernel_lang.Expr``, one per level
              (priors first)
    states    [n_pad] per-vertex value vectors, one per level
    idents    reduction identities (= ⊥ sentinels), one per level
    active    [n_pad] frontier (bool or int); inactive sources contribute ⊥
    bests     [n_pad] best values of the PRIOR levels (len = len(states)-1)
    mode      "value" (reduce P values) | "nonbot" (int32 max of "the
              source's state is not ⊥")
    wdeg      [n_pad] weighted out-degrees (ones when None)

    Returns the [n_pad] per-vertex reduction: the last state's dtype in
    ``value`` mode, int32 in ``nonbot`` mode.  The layout may be tiled at
    any multiple of (8, 128).  On the card one call is two kernels: the
    walk deals the (8 × 128) tiles over a grid sized to the card, skips
    those whose layout tile ``ell.tile_nnz`` counts empty, and writes each
    row's partial of each visited slot tile into an [n_pad, width / 128]
    cell buffer where its row tile holds another such tile; the combine
    folds those rows' cells in slot-tile order."""
    n_levels = len(states)
    if n_levels == 0 or len(p_exprs) != n_levels or \
            len(idents) != n_levels or len(bests) != n_levels - 1:
        raise ValueError(f"{n_levels} states need as many P expressions "
                         f"and identities and {n_levels - 1} bests; got "
                         f"{len(p_exprs)}, {len(idents)} and {len(bests)}")
    if mode not in ("value", "nonbot"):
        raise ValueError(f"mode must be 'value' or 'nonbot', got {mode!r}")
    kop = _INT_OP.get(op, op) if mode == "value" else "max"
    if kop not in ("min", "max", "sum", "prod"):
        raise ValueError(f"unknown reduction {op!r}")
    dtypes = [s.dtype for s in states]
    idents = [_scalar(i, dt) for i, dt in zip(idents, dtypes)]
    srcs = ell.srcs
    n_pad, width = srcs.shape
    if wdeg is None:
        wdeg = torch.ones_like(outdeg)
    active = active.to(torch.int32)
    nv = float(ell.n)
    if not srcs.is_cuda:
        return _level_plain(kop, p_exprs, states, idents, srcs, ell.weight,
                            ell.capacity, ell.mask, active, outdeg, wdeg,
                            bests, mode, nv)
    bv, be = ell.block_v, ell.block_e
    if bv % BLOCK_V or be % BLOCK_E or n_pad % bv or width % be:
        raise ValueError(f"layout {n_pad}×{width} in ({bv}, {be}) tiles is "
                         f"not a whole number of ({BLOCK_V}, {BLOCK_E}) "
                         f"tiles")
    if n_levels > _MAX_PTRS:
        raise ValueError(f"{n_levels} levels exceed the kernel's {_MAX_PTRS}")
    _check("tile_nnz", ell.tile_nnz, torch.int32, (n_pad // bv, width // be))
    for name, t, dt in (("srcs", srcs, torch.int32),
                        ("weight", ell.weight, torch.float32),
                        ("capacity", ell.capacity, torch.float32),
                        ("mask", ell.mask, torch.bool)):
        _check(name, t, dt, (n_pad, width))
    _check("active", active, torch.int32, (n_pad,))
    _check("outdeg", outdeg, torch.float32, (n_pad,))
    _check("wdeg", wdeg, torch.float32, (n_pad,))
    for k, (st, dt) in enumerate(zip(states, dtypes)):
        if dt not in (torch.float32, torch.int32):
            raise ValueError(f"state[{k}] must be float32 or int32, got {dt}")
        _check(f"state[{k}]", st, dt, (n_pad,))
    for k, (b, dt) in enumerate(zip(bests, dtypes)):
        _check(f"bests[{k}]", b, dt, (n_pad,))
    if n_pad // BLOCK_V * (width // BLOCK_E) >= 2 ** 31:
        raise ValueError(f"layout {n_pad}×{width} has 2^31 or more "
                         f"({BLOCK_V}, {BLOCK_E}) tiles")
    from repro_torch.kernels import build
    lib = build.level_library(level_source(p_exprs, dtypes, idents, kop,
                                            mode))
    out_dtype = dtypes[-1] if mode == "value" else torch.int32
    tiles, counts, multi = ell.row_tile_walk
    out = torch.empty((n_pad,), dtype=out_dtype, device=srcs.device)
    cells = torch.empty((n_pad, width // BLOCK_E), dtype=torch.int32,
                        device=srcs.device)
    status = lib.grafs_level(
        tiles.data_ptr(), counts.data_ptr(), multi.data_ptr(), multi.numel(),
        srcs.data_ptr(), ell.weight.data_ptr(), ell.capacity.data_ptr(),
        ell.mask.data_ptr(), active.data_ptr(), outdeg.data_ptr(),
        wdeg.data_ptr(), _ptrs(states), _ptrs(bests), cells.data_ptr(),
        out.data_ptr(), n_pad // BLOCK_V, width, nv, _stream(srcs))
    _raise_on(status, "level")
    LAUNCHES["level"] += 1
    return out


def level_walk(ell, lib) -> dict:
    """The level walk's shape on ``ell`` for the level library ``lib``
    (needs the card): the walk kernel's registers per thread, its grid (the
    card's resident blocks, fewer where the tiles need fewer steps), the
    non-empty (8 × 128) tiles, the most of them in one row tile, the row
    tiles the combine takes and the bytes of their cells (where ⊥ is the
    monoid's identity)."""
    attrs = (ctypes.c_int * 2)()
    _raise_on(lib.grafs_level_attributes(attrs), "level attributes")
    n_pad, width = ell.nbrs.shape
    n_j = width // BLOCK_E
    steps = -(-(n_pad // BLOCK_V * n_j) // (BLOCK_V * _LANES))
    tiles, counts, multi = ell.row_tile_walk
    return {"registers": attrs[0], "resident_blocks": attrs[1],
            "grid": max(1, min(steps, attrs[1])),
            "tiles_non_empty": int(tiles.sum()),
            "max_tiles_per_row_tile": int(counts.max()),
            "row_tiles_combined": multi.numel(),
            "cell_bytes": multi.numel() * BLOCK_V * n_j * 4}


def _level_plain(kop, p_exprs, states, idents, srcs, weight, capacity, mask,
                 active, outdeg, wdeg, bests, mode, nv):
    """The level kernel's arithmetic in torch: per 128-slot tile the lanes'
    4-slot folds and the halving tree (``_tile_reduce``), then the tiles
    combined in order into a running value that starts at the identity."""
    from repro_torch.core.kernel_lang import compile_expr
    p_fns = [compile_expr(e) for e in p_exprs]
    n_pad, width = srcs.shape
    last = len(states) - 1
    if mode == "value":
        out_dtype, out_ident = states[last].dtype, idents[last]
    else:
        out_dtype, out_ident = torch.int32, 0
    out = torch.full((n_pad,), out_ident, dtype=out_dtype, device=srcs.device)
    nv_t = torch.tensor(nv, dtype=torch.float32, device=srcs.device)
    for r0, r1 in _row_chunks(n_pad, width):
        s = srcs[r0:r1]
        s_l = s.long()
        live = mask[r0:r1] & (active[s_l] != 0)
        rows = torch.arange(r0, r1, dtype=torch.int32, device=srcs.device)
        env = {"w": weight[r0:r1], "c": capacity[r0:r1], "esrc": s,
               "edst": rows[:, None].expand(r1 - r0, width),
               "outdeg": outdeg[s_l], "wdeg": wdeg[s_l], "nv": nv_t}

        def prop(lvl):
            nvals = states[lvl][s_l]
            p = cast_like(p_fns[lvl]({"n": nvals, **env}), nvals.dtype, nvals)
            return torch.where(nvals == idents[lvl], idents[lvl], p), nvals

        for lvl in range(last):                # tie masks of prior levels
            pv, _ = prop(lvl)
            live = live & (pv == bests[lvl][r0:r1, None])
        if mode == "nonbot":
            vals = (states[last][s_l] != idents[last]).to(torch.int32)
        else:
            vals, _ = prop(last)
        part = _tile_reduce(kop, torch.where(live, vals, out_ident))
        acc = out[r0:r1]
        for j in range(part.shape[1]):
            acc = _combine(kop, acc, part[:, j])
        out[r0:r1] = acc
    return out


# ---------------------------------------------------------------------------
# Torch helpers around the kernels (the reference's XLA-side code).
# ---------------------------------------------------------------------------

def _fold_tile_candidates(rnd: SweepRound, outs):
    """Cross-tile lexicographic resolution of per-tile candidates
    ``outs[level][..., n_pad, n_tiles]``: the ``plan_merge`` recurrence over
    the tile axis, shared by the pull sweep and the sorted push resolution
    so both directions reduce with the identical tree.  A batch folds on
    its [S·n_pad, n_tiles] view, so every row reduces as a solo fold
    does.  Returns ({comp: [..., n_pad] reduction}, levels consumed)."""
    red, oi = {}, 0
    lead, n_t = outs[0].shape[:-1], outs[0].shape[-1]
    for spec, mapped in zip(rnd.plans, rnd.plan_specs):
        tie = torch.ones((math.prod(lead), n_t), dtype=torch.bool,
                         device=outs[oi].device)
        for (c, _op), (pos, op) in zip(spec, mapped):
            vals = torch.where(tie, outs[oi].reshape(-1, n_t),
                               rnd.idents[pos])
            if op == "min":
                best = vals.amin(dim=1)
            elif op == "max":
                best = vals.amax(dim=1)
            elif op == "sum":
                best = vals.sum(dim=1, dtype=vals.dtype)
            else:
                best = vals.prod(dim=1, dtype=vals.dtype)
            red[c] = best.reshape(lead)
            tie = tie & (vals == best[:, None])
            oi += 1
    return red, oi


def tile_activity(srcs, mask, tile_nnz, active_i32, block_v: int = BLOCK_V,
                  block_e: int = BLOCK_E):
    """Pull-side tile activity: a tile runs iff it has real slots AND at
    least one frontier-active source.  An [S, n_pad] frontier gives one
    activity per slot."""
    if active_i32.dim() == 2:
        return torch.stack([tile_activity(srcs, mask, tile_nnz, a, block_v,
                                          block_e) for a in active_i32])
    n_i, n_j = tile_nnz.shape
    act = (active_i32.index_select(0, srcs.reshape(-1)) != 0) \
        .reshape(srcs.shape) & mask
    any_act = act.reshape(n_i, block_v, n_j, block_e).any(dim=3).any(dim=1)
    return ((tile_nnz > 0) & any_act).to(torch.int32)


def tile_activity_push(tile_nnz, active_i32, block_v: int = BLOCK_V):
    """Push-side tile activity over the out-layout: a tile is active iff its
    row block holds a frontier-active source (no gather).  An [S, n_pad]
    frontier gives one activity per slot."""
    n_i, _n_j = tile_nnz.shape
    lead = active_i32.shape[:-1]
    row_act = (active_i32.reshape(*lead, n_i, block_v) != 0).any(dim=-1)
    return ((tile_nnz > 0) & row_act[..., None]).to(torch.int32)


def resolution_tile_activity(res_contrib, push_tile_act, res_tile_nnz):
    """Resolution-tile activity: a tile runs iff it has real slots and one
    of its contributing out-tiles (``PushResolution.contrib``) ran.  An
    [S, n_i, n_j] push activity gives one activity per slot."""
    n_i, n_j = res_tile_nnz.shape
    lead = push_tile_act.shape[:-2]
    flat_act = push_tile_act.reshape(*lead, -1)
    idx = res_contrib.clamp(0, flat_act.shape[-1] - 1).long()
    hit = (res_contrib >= 0) & (flat_act[..., idx] != 0)
    any_act = hit.any(dim=-1).reshape(*lead, n_i, n_j)
    return ((res_tile_nnz > 0) & any_act).to(torch.int32)


def fused_ell_sweep(rnd: SweepRound, srcs, weight, capacity, mask, tile_act,
                    states: dict, active, outdeg, wdeg, nv: float,
                    need_haspred: bool = False, return_candidates=False):
    """The pull sweep plus its cross-tile fold: ``(red, hp)`` with
    ``red[comp]`` the [n_pad] reduction of each level and ``hp[comp]`` the
    bool has-pred vectors (empty unless ``need_haspred``); with
    ``return_candidates`` the per-tile candidate arrays are appended."""
    st = [states[c] for c in rnd.comps_order]
    outs = pull_sweep(rnd, tile_act, srcs, weight, capacity, mask,
                      active.to(torch.int32), outdeg, wdeg, st, nv,
                      need_haspred)
    red, oi = _fold_tile_candidates(rnd, outs)
    hp = {}
    if need_haspred:
        for k, c in enumerate(rnd.comps_order):
            hp[c] = outs[oi + k].amax(dim=-1) > 0
    if return_candidates:
        return red, hp, outs
    return red, hp


def fused_ell_sweep_frontier(rnd: SweepRound, srcs, weight, capacity, mask,
                             tiles_static, states: dict, active, outdeg,
                             wdeg, nv: float):
    """The pull sweep of an idempotent round with the frontier's tile
    activity derived in the kernel (``pull_sweep_frontier``), plus the
    cross-tile fold: ``(red, tile_act)``."""
    st = [states[c] for c in rnd.comps_order]
    outs, tile_act = pull_sweep_frontier(rnd, tiles_static, srcs, weight,
                                         capacity, mask,
                                         active.to(torch.int32), outdeg,
                                         wdeg, st, nv)
    red, _ = _fold_tile_candidates(rnd, outs)
    return red, tile_act


def fused_ell_push_sweep(rnd: SweepRound, dsts, weight, capacity, mask,
                         tile_act, states: dict, active, outdeg, wdeg,
                         nv: float, need_haspred: bool = False,
                         resolution: str = "sorted", res=None,
                         return_candidates=False):
    """The push sweep plus its dst-keyed resolution: ``"sorted"`` (``res``
    = ``(in2out, valid, res_tile_act)``) runs the resolve kernel and the
    pull sweep's fold; ``"scatter"`` is the reference full-rectangle
    scatter in torch.  Returns ``(red, hp)`` like ``fused_ell_sweep``.

    Under ``"sorted"`` the has-pred probe is the resolve kernel's: it covers
    the resolution tiles ``res_tile_act`` keeps, so the push− path passes
    the static activity (every live tile) and gets the reference's
    booleans.  ``"scatter"`` reads every candidate, so its push buffers
    start identity-filled; its has-pred is a scatter-OR in torch.  With
    ``return_candidates`` the [n_pad, width] candidates are appended; under
    ``"sorted"`` on the card a skipped tile's are undefined."""
    if resolution not in ("scatter", "sorted"):
        raise ValueError(f"resolution must be 'scatter' or 'sorted', "
                         f"got {resolution!r}")
    if resolution == "sorted" and res is None:
        raise ValueError("resolution='sorted' needs res=(in2out, valid, "
                         "res_tile_act) from structure.PushResolution")
    n_pad, width = dsts.shape
    st = [states[c] for c in rnd.comps_order]
    lead = _lead(st)
    filled = None
    if resolution == "scatter":
        filled = [torch.full(lead + (n_pad, width), ident, dtype=dt,
                             device=dsts.device)
                  for dt, ident in zip(rnd.dtypes, rnd.idents)]
    cands = push_sweep(rnd, tile_act, dsts, weight, capacity, mask,
                       active.to(torch.int32), outdeg, wdeg, st, nv,
                       out=filled)
    hp = {}
    if resolution == "sorted":
        in2out, valid, res_tile_act = res
        outs = resolve_sweep(rnd, res_tile_act, valid, in2out, cands,
                             tile_act, width, st, need_haspred)
        red, oi = _fold_tile_candidates(rnd, outs)
        if need_haspred:
            for k, c in enumerate(rnd.comps_order):
                hp[c] = outs[oi + k].amax(dim=-1) > 0
    elif lead:
        per = [_scatter_resolve(rnd, dsts, mask, [c[s] for c in cands],
                                [x[s] for x in st], need_haspred)
               for s in range(lead[0])]
        red = {c: torch.stack([r[c] for r, _h in per]) for c in per[0][0]}
        hp = {c: torch.stack([h[c] for _r, h in per]) for c in per[0][1]}
    else:
        red, hp = _scatter_resolve(rnd, dsts, mask, cands, st, need_haspred)
    if return_candidates:
        return red, hp, cands
    return red, hp


def _scatter_resolve(rnd: SweepRound, dsts, mask, cands, st, need_haspred):
    """One query's ``"scatter"`` resolution of its [n_pad, width] push
    candidates, and its has-pred as a scatter-OR: ``(red, hp)``."""
    n_pad = dsts.shape[0]
    flat_dst = dsts.reshape(-1)
    red, hp = {}, {}
    for spec in rnd.plans:
        tie = torch.ones(flat_dst.shape, dtype=torch.bool,
                         device=dsts.device)
        for li, (c, op) in enumerate(spec):
            pos = rnd.comps_order.index(c)
            ident = rnd.idents[pos]
            flat = cands[pos].reshape(-1)
            init = torch.full((n_pad,), ident, dtype=flat.dtype,
                              device=dsts.device)
            vals = torch.where(tie, flat, ident)
            prim = segment.scatter_reduce(op, init, vals, flat_dst)
            red[c] = prim
            if li + 1 < len(spec):
                tie = tie & (vals == prim[flat_dst.long()])
    if need_haspred:
        # Def. 4's CPreds ≠ ∅ probe from "source state non-⊥" over real
        # out-edges, as a scatter-OR in torch.
        for k, c in enumerate(rnd.comps_order):
            nonbot = (mask & (st[k][:, None] != rnd.idents[k])) \
                .to(torch.int32)
            hp[c] = segment.scatter_reduce(
                "or", torch.zeros((n_pad,), dtype=torch.int32,
                                  device=dsts.device),
                nonbot.reshape(-1), dsts.reshape(-1)) > 0
    return red, hp
