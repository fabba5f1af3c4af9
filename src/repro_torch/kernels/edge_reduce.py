"""Blocked-ELL edge sweeps of a fused round: CUDA kernels and plain versions.

The port of ``repro.kernels.edge_reduce``.  Three tile passes carry the
fixpoint, each a hand-written CUDA kernel (``csrc/edge_sweep.cuh``,
instantiated per fused round from the round's synthesized P expressions by
``synthesis.emit_cuda_round`` and built by ``kernels/build.py``):

``pull_sweep``    — the pull sweep (replaces ``_fused_kernel``): per (8 × 128)
                    tile, gather each component's state once, apply every P
                    with the C3 guard, run each plan's lexicographic chain and
                    write one candidate per (row, slot tile) per level, plus
                    the fused has-pred probe.
``push_sweep``    — the push sweep (replaces ``_push_kernel``): identity-filled
                    per-edge candidates over the out-layout.
``resolve_sweep`` — the dst-sorted push resolution (replaces
                    ``_resolve_kernel``): gather candidates through ``in2out``
                    inside the tile skip, then the pull sweep's lex chain.

Each wrapper launches its kernel for CUDA tensors (checking device, dtype,
shape, contiguity and the launch status) and counts the launch in
``LAUNCHES``; for CPU tensors it runs the kernel's plain PyTorch version,
which repeats the kernel's arithmetic and its fixed reduction order
(each lane's 4 slots in order, then a halving tree over the 32 lanes), so
kernel and plain version agree bitwise on the card.  There is no fallback
from a CUDA tensor to the plain version.

``fused_ell_sweep`` / ``fused_ell_push_sweep`` wrap the tile passes with the
cross-tile fold (``_fold_tile_candidates``, torch, shared by pull and sorted
push so push(sorted) ≡ pull bitwise) and the push resolutions; the frontier
tile-activity helpers are torch ops.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.iterate import cast_like
from repro_torch.graph import segment

BLOCK_V = 8
BLOCK_E = 128
_LANES = 32
_SLOTS = BLOCK_E // _LANES
_MAX_PTRS = 16
_PLAIN_CHUNK = 1 << 24           # slots per plain-version chunk (memory cap)

# boolean monoids run as int32 min/max inside the kernels
_INT_OP = {"or": "max", "and": "min"}

# Runtime launch counts of the three kernels: each wrapper adds one where it
# launches its kernel on the card, and nowhere else.
LAUNCHES = {"pull": 0, "push": 0, "resolve": 0}


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
        self._lib = None

    def source(self) -> str:
        from repro_torch.core.synthesis import emit_cuda_round
        if self.p_exprs is None or any(e is None for e in self.p_exprs):
            raise RuntimeError(
                "this round has no P expression for every component, so no "
                "CUDA kernel can be generated for it")
        if self.n_levels + len(self.comps_order) > _MAX_PTRS:
            raise RuntimeError(f"round too wide for the sweep kernels: "
                               f"{self.n_levels} levels + "
                               f"{len(self.comps_order)} components > "
                               f"{_MAX_PTRS} outputs")
        return emit_cuda_round(
            self.p_exprs,
            ["float" if d == torch.float32 else "int" for d in self.dtypes],
            self.idents, self.plan_specs)

    def library(self):
        if self._lib is None:
            from repro_torch.kernels import build
            self._lib = build.round_library(self.source())
        return self._lib


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
    arr = (ctypes.c_void_p * _MAX_PTRS)()
    for k, t in enumerate(tensors):
        arr[k] = t.data_ptr()
    return arr


def _check(name: str, t, dtype, shape=None):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_layout(rect, tile_act):
    n_pad, width = rect.shape
    if n_pad % BLOCK_V or width % BLOCK_E:
        raise ValueError(f"layout {n_pad}×{width} is not a whole number of "
                         f"({BLOCK_V}, {BLOCK_E}) tiles")
    if n_pad * width >= 2 ** 31:
        raise ValueError(f"layout {n_pad}×{width} overflows int32 indexing")
    _check("tile_act", tile_act, torch.int32,
           (n_pad // BLOCK_V, width // BLOCK_E))


def _raise_on(status: int, kernel: str):
    if status != 0:
        raise RuntimeError(f"CUDA {kernel} kernel launch failed: "
                           f"cudaError {status}")


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


# ---------------------------------------------------------------------------
# The pull sweep (replaces edge_reduce.py::_fused_kernel).
# ---------------------------------------------------------------------------

def pull_sweep(rnd: SweepRound, tile_act, srcs, weight, capacity, mask,
               active, outdeg, wdeg, states, nv: float,
               need_hp: bool = False):
    """Per-tile candidates of the pull sweep: a list with one [n_pad, n_j]
    array per lex level (plan order), then, with ``need_hp``, one int32
    [n_pad, n_j] has-pred array per component.  ``states`` lists the
    [n_pad] state vectors in ``rnd.comps_order``; ``active`` is int32."""
    if not srcs.is_cuda:
        return _pull_plain(rnd, tile_act, srcs, weight, capacity, mask,
                           active, outdeg, wdeg, states, nv, need_hp)
    n_pad, width = srcs.shape
    _check_layout(srcs, tile_act)
    for name, t, dt in (("srcs", srcs, torch.int32),
                        ("weight", weight, torch.float32),
                        ("capacity", capacity, torch.float32),
                        ("mask", mask, torch.bool)):
        _check(name, t, dt, (n_pad, width))
    _check("active", active, torch.int32, (n_pad,))
    _check("outdeg", outdeg, torch.float32, (n_pad,))
    _check("wdeg", wdeg, torch.float32, (n_pad,))
    for k, (st, dt) in enumerate(zip(states, rnd.dtypes)):
        _check(f"state[{k}]", st, dt, (n_pad,))
    lib = rnd.library()
    n_i, n_j = n_pad // BLOCK_V, width // BLOCK_E
    outs = [torch.empty((n_pad, n_j), dtype=rnd.dtypes[pos], device=srcs.device)
            for spec in rnd.plan_specs for pos, _op in spec]
    if need_hp:
        outs += [torch.empty((n_pad, n_j), dtype=torch.int32,
                             device=srcs.device) for _ in states]
    status = lib.grafs_pull(
        tile_act.data_ptr(), srcs.data_ptr(), weight.data_ptr(),
        capacity.data_ptr(), mask.data_ptr(), active.data_ptr(),
        outdeg.data_ptr(), wdeg.data_ptr(), _ptrs(states), _ptrs(outs),
        n_i * n_j, n_j, width, float(nv), int(need_hp), _stream(srcs))
    _raise_on(status, "pull")
    LAUNCHES["pull"] += 1
    return outs


def _pull_plain(rnd, tile_act, srcs, weight, capacity, mask, active, outdeg,
                wdeg, states, nv, need_hp):
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
               active, outdeg, wdeg, states, nv: float):
    """Per-edge candidates of the push sweep over the out-layout: one
    [n_pad, width] array per component (``rnd.comps_order``), the identity
    wherever the slot is padding, the source row inactive, or the tile
    skipped."""
    if not dsts.is_cuda:
        return _push_plain(rnd, tile_act, dsts, weight, capacity, mask,
                           active, outdeg, wdeg, states, nv)
    n_pad, width = dsts.shape
    _check_layout(dsts, tile_act)
    for name, t, dt in (("dsts", dsts, torch.int32),
                        ("weight", weight, torch.float32),
                        ("capacity", capacity, torch.float32),
                        ("mask", mask, torch.bool)):
        _check(name, t, dt, (n_pad, width))
    _check("active", active, torch.int32, (n_pad,))
    _check("outdeg", outdeg, torch.float32, (n_pad,))
    _check("wdeg", wdeg, torch.float32, (n_pad,))
    for k, (st, dt) in enumerate(zip(states, rnd.dtypes)):
        _check(f"state[{k}]", st, dt, (n_pad,))
    lib = rnd.library()
    n_i, n_j = n_pad // BLOCK_V, width // BLOCK_E
    outs = [torch.empty((n_pad, width), dtype=dt, device=dsts.device)
            for dt in rnd.dtypes]
    status = lib.grafs_push(
        tile_act.data_ptr(), dsts.data_ptr(), weight.data_ptr(),
        capacity.data_ptr(), mask.data_ptr(), active.data_ptr(),
        outdeg.data_ptr(), wdeg.data_ptr(), _ptrs(states), _ptrs(outs),
        n_i * n_j, n_j, width, float(nv), _stream(dsts))
    _raise_on(status, "push")
    LAUNCHES["push"] += 1
    return outs


def _push_plain(rnd, tile_act, dsts, weight, capacity, mask, active, outdeg,
                wdeg, states, nv):
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

def resolve_sweep(rnd: SweepRound, tile_act, valid, in2out, cands):
    """Per-tile candidates of the sorted resolution over the dst-major
    rectangle: gathers ``cands[k].flat[in2out]`` where ``valid`` inside
    active tiles, then the pull sweep's lex chain.  Returns one [n_pad, n_j]
    array per lex level, exactly like ``pull_sweep``."""
    if not valid.is_cuda:
        return _resolve_plain(rnd, tile_act, valid, in2out, cands)
    n_pad, width = valid.shape
    _check_layout(valid, tile_act)
    _check("valid", valid, torch.bool, (n_pad, width))
    _check("in2out", in2out, torch.int32, (n_pad, width))
    for k, (c, dt) in enumerate(zip(cands, rnd.dtypes)):
        _check(f"cands[{k}]", c, dt)
    lib = rnd.library()
    n_i, n_j = n_pad // BLOCK_V, width // BLOCK_E
    outs = [torch.empty((n_pad, n_j), dtype=rnd.dtypes[pos],
                        device=valid.device)
            for spec in rnd.plan_specs for pos, _op in spec]
    status = lib.grafs_resolve(
        tile_act.data_ptr(), valid.data_ptr(), in2out.data_ptr(),
        _ptrs(cands), _ptrs(outs), n_i * n_j, n_j, width, _stream(valid))
    _raise_on(status, "resolve")
    LAUNCHES["resolve"] += 1
    return outs


def _resolve_plain(rnd, tile_act, valid, in2out, cands):
    n_pad, width = valid.shape
    flat = [c.reshape(-1) for c in cands]
    parts = []
    for r0, r1 in _row_chunks(n_pad, width):
        ok = valid[r0:r1]
        idx = in2out[r0:r1].long()
        vals = [torch.where(ok, f[idx], ident)
                for f, ident in zip(flat, rnd.idents)]
        outs = _lex_chain(rnd, vals, ok)
        live = _tiles_to_rows(tile_act[r0 // BLOCK_V:r1 // BLOCK_V])
        idents = [rnd.idents[pos] for spec in rnd.plan_specs
                  for pos, _op in spec]
        parts.append([torch.where(live, o, i) for o, i in zip(outs, idents)])
    return [torch.cat(cols) for cols in zip(*parts)]


# ---------------------------------------------------------------------------
# Torch helpers around the kernels (the reference's XLA-side code).
# ---------------------------------------------------------------------------

def _fold_tile_candidates(rnd: SweepRound, outs):
    """Cross-tile lexicographic resolution of per-tile candidates
    ``outs[level][n_pad, n_tiles]``: the ``plan_merge`` recurrence over the
    tile axis, shared by the pull sweep and the sorted push resolution so
    both directions reduce with the identical tree.  Returns ({comp: [n_pad]
    reduction}, levels consumed)."""
    red, oi = {}, 0
    for spec, mapped in zip(rnd.plans, rnd.plan_specs):
        tie = torch.ones(outs[oi].shape, dtype=torch.bool,
                         device=outs[oi].device)
        for (c, _op), (pos, op) in zip(spec, mapped):
            vals = torch.where(tie, outs[oi], rnd.idents[pos])
            if op == "min":
                best = vals.amin(dim=1)
            elif op == "max":
                best = vals.amax(dim=1)
            elif op == "sum":
                best = vals.sum(dim=1, dtype=vals.dtype)
            else:
                best = vals.prod(dim=1, dtype=vals.dtype)
            red[c] = best
            tie = tie & (vals == best[:, None])
            oi += 1
    return red, oi


def tile_activity(srcs, mask, tile_nnz, active_i32, block_v: int = BLOCK_V,
                  block_e: int = BLOCK_E):
    """Pull-side tile activity: a tile runs iff it has real slots AND at
    least one frontier-active source."""
    n_i, n_j = tile_nnz.shape
    act = (active_i32.index_select(0, srcs.reshape(-1)) != 0) \
        .reshape(srcs.shape) & mask
    any_act = act.reshape(n_i, block_v, n_j, block_e).any(dim=3).any(dim=1)
    return ((tile_nnz > 0) & any_act).to(torch.int32)


def tile_activity_push(tile_nnz, active_i32, block_v: int = BLOCK_V):
    """Push-side tile activity over the out-layout: a tile is active iff its
    row block holds a frontier-active source (no gather)."""
    n_i, _n_j = tile_nnz.shape
    row_act = (active_i32.reshape(n_i, block_v) != 0).any(dim=1)
    return ((tile_nnz > 0) & row_act[:, None]).to(torch.int32)


def resolution_tile_activity(res_contrib, push_tile_act, res_tile_nnz):
    """Resolution-tile activity: a tile runs iff it has real slots and one
    of its contributing out-tiles (``PushResolution.contrib``) ran."""
    n_i, n_j = res_tile_nnz.shape
    flat_act = push_tile_act.reshape(-1)
    hit = (res_contrib >= 0) & \
        (flat_act[res_contrib.clamp(0, flat_act.shape[0] - 1).long()] != 0)
    any_act = hit.any(dim=1).reshape(n_i, n_j)
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
            hp[c] = outs[oi + k].amax(dim=1) > 0
    if return_candidates:
        return red, hp, outs
    return red, hp


def fused_ell_push_sweep(rnd: SweepRound, dsts, weight, capacity, mask,
                         tile_act, states: dict, active, outdeg, wdeg,
                         nv: float, need_haspred: bool = False,
                         resolution: str = "sorted", res=None,
                         res_src_row=None, return_candidates=False):
    """The push sweep plus its dst-keyed resolution: ``"sorted"`` (``res``
    = ``(in2out, valid, res_tile_act)``) runs the resolve kernel and the
    pull sweep's fold; ``"scatter"`` is the reference full-rectangle
    scatter in torch.  ``res_src_row`` (``in2out // width``, the out-row of
    each resolution slot) may be passed in by a caller that sweeps one
    graph repeatedly; the sorted has-pred probe computes it otherwise.
    Returns ``(red, hp)`` like ``fused_ell_sweep``."""
    if resolution not in ("scatter", "sorted"):
        raise ValueError(f"resolution must be 'scatter' or 'sorted', "
                         f"got {resolution!r}")
    if resolution == "sorted" and res is None:
        raise ValueError("resolution='sorted' needs res=(in2out, valid, "
                         "res_tile_act) from structure.PushResolution")
    n_pad, width = dsts.shape
    st = [states[c] for c in rnd.comps_order]
    cands = push_sweep(rnd, tile_act, dsts, weight, capacity, mask,
                       active.to(torch.int32), outdeg, wdeg, st, nv)
    if resolution == "sorted":
        in2out, valid, res_tile_act = res
        outs = resolve_sweep(rnd, res_tile_act, valid, in2out, cands)
        red, _ = _fold_tile_candidates(rnd, outs)
    else:
        flat_dst = dsts.reshape(-1)
        red = {}
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
    hp = {}
    if need_haspred:
        # Def. 4's CPreds ≠ ∅ probe from "source state non-⊥" over real
        # out-edges, in torch on data already resident.
        for k, c in enumerate(rnd.comps_order):
            ident = rnd.idents[k]
            if resolution == "sorted":
                # the out-slot in2out[v, k] lies in row in2out // width: the
                # same booleans as gathering the rectangle's nonbot flags
                in2out, valid, _ = res
                if res_src_row is None:
                    res_src_row = torch.div(in2out, width,
                                            rounding_mode="floor")
                src_st = states[c].index_select(0, res_src_row.reshape(-1))
                hp[c] = (valid & (src_st.reshape(valid.shape) != ident)) \
                    .any(dim=1)
            else:
                nonbot = (mask & (states[c][:, None] != ident)) \
                    .to(torch.int32)
                hp[c] = segment.scatter_reduce(
                    "or", torch.zeros((n_pad,), dtype=torch.int32,
                                      device=dsts.device),
                    nonbot.reshape(-1), dsts.reshape(-1)) > 0
    if return_candidates:
        return red, hp, cands
    return red, hp
