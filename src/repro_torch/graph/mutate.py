"""Batched edge insert/delete with the blocked-ELL layouts patched on their
device.

The port's counterpart of ``repro.graph.mutate``.  A mutation produces a
NEW immutable ``Graph`` (every derived cache is identity-keyed, so a graph
mutated in place would serve stale layouts), and the derived structures
cached for the old graph — the pull and push blocked-ELL rectangles and the
dst-sorted push resolution — are carried over by a patch instead of a
rebuild whenever the edit fits the existing padding:

* **Deletes** clear the edge's slot (``mask`` False, ``nbrs`` 0, weight and
  capacity 0) and take one from the owning tile's ``tile_nnz``; the slot
  becomes reusable padding.
* **Inserts** take the first free slot of their row, in batch order.  A row
  whose free slots run out overflows the layout's padded width: that layout
  goes to a **counted rebuild** (no patched entry is installed, so the
  canonical lazy build runs for the new graph).

Slot choice, and every patched array, is bitwise the reference's; only
the place the work is done differs.  The reference copies each whole
layout to the host and back and places inserts in a Python loop.  Here
the layout is cloned on its device, the deleted slots are cleared and
the inserts written with index operations, and each insert gets its slot
without a loop: the j-th insert of a row (in batch order) takes the
row's j-th free slot, the slot the reference's ``pop(0)`` gives it,
found by a running count of free slots over the insert rows' masks.  The
per-edge work of the slot maps and of the resolution (stable sorts,
ranks, tile ids) runs on the device too, over the graphs' dst-sorted
edge tensors; the host keeps the validation and the merge of the edge
lists.  The old graph's tensors are never written, so it and
its cached layouts keep giving the old answers.

Patched layouts are *non-canonical*: an edge's slot is wherever a free slot
was.  The push resolution can then never be rebuilt canonically against a
patched out rectangle (its ``in2out`` would address the wrong slots).  The
coupling rule: whenever either direction is patched, a resolution built
from the ACTUAL slots of both directions is installed alongside
(``structure._resolution_from_slots``, the builder ``to_push_resolution``
calls with the fill order), and the per-edge slot maps are recorded in
``structure._SLOT_CACHE``, so chained mutations patch from the real
positions.

``MutationDelta.touched`` is the unique endpoint set of every inserted and
deleted edge: the frontier seed of the delta-seeded fixpoint
(``engine.run_program(..., delta=...)``), sound for warm-started
idempotent rounds over insert-only edits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.guard import GraphValidationError
from repro_torch.graph import structure
from repro_torch.graph.structure import (
    BlockedELL, Graph, _check_edge_arrays, _fill_order_slots, _install,
    _lookup, _padded_width, _resolution_from_slots, _tile_nnz, _to,
    from_edges)

# Global patch/rebuild accounting (tests and the smoke; cleared with the
# program caches).
MUTATION_STATS = {
    "mutations": 0,          # mutate_edges calls
    "patched_layouts": 0,    # cached layouts carried over by a patch
    "rebuilt_layouts": 0,    # cached layouts dropped to a counted rebuild
}


def reset_mutation_stats() -> None:
    for k in MUTATION_STATS:
        MUTATION_STATS[k] = 0


@dataclasses.dataclass(frozen=True)
class MutationDelta:
    """Summary of one ``mutate_edges`` batch: the planner's mutation-size
    statistics (``plan_execution(mutation=...)``) and the delta fixpoint's
    frontier seed (``touched``)."""
    inserted: int            # edges added (after the policies' filtering)
    deleted: int             # edges removed (the batch + policy drops)
    touched: np.ndarray      # unique int64 endpoint ids of every edit
    has_deletes: bool        # deletions retract support: idempotent rounds
                             # cannot warm-start over them
    patched_layouts: int     # cached layouts patched this batch
    rebuilt_layouts: int     # cached layouts that overflowed to a rebuild


def _slot_maps(g: Graph, block_v: int, block_e: int):
    """(k_in, k_out) per edge, int64 tensors on the graph's device aligned
    to ``host_edges`` (dst-sorted) order: the recorded maps of a patched
    graph, or the canonical fill order (what ``to_blocked_ell`` /
    ``to_push_resolution`` assign) for a graph built from scratch."""
    maps = _lookup(structure._SLOT_CACHE, (id(g), block_v, block_e), g)
    if maps is not None:
        return maps
    return (_fill_order_slots(g.by_dst.dst, g.n),
            _fill_order_slots(g.by_dst.src, g.n))


def _insert_slots(ell: BlockedELL, r_del, k_del, row_ins):
    """The slot of each insert (int64 on the layout's device), or None when
    a row runs out of free slots.

    The j-th insert of a row, in batch order, takes the row's j-th free
    slot (ascending), the deletes of the row cleared first, as the
    reference clears them before it places an insert.  Over the mask rows
    of the rows that receive inserts, one running count of free slots and
    a binary search find each insert's slot on the device; only the
    inserts' rows and ranks are computed on the host."""
    dev = ell.mask.device
    n_ins = row_ins.shape[0]
    if n_ins == 0:
        return torch.empty(0, dtype=torch.int64, device=dev)
    rows, inv = np.unique(row_ins, return_inverse=True)
    # rank of each insert within its row, in batch order
    counts = np.bincount(inv, minlength=rows.size)
    order = np.argsort(inv, kind="stable")
    rank = np.empty(n_ins, dtype=np.int64)
    rank[order] = np.arange(n_ins) - (np.cumsum(counts) - counts)[inv[order]]
    rows_t, inv_t, rank_t = (_to(a, dev) for a in (rows, inv, rank))
    free = ~ell.mask.index_select(0, rows_t)
    if r_del.numel():
        hit = torch.isin(r_del, rows_t)
        free[torch.searchsorted(rows_t, r_del[hit]), k_del[hit]] = True
    n_free = free.sum(1)
    if bool((rank_t >= n_free[inv_t]).any()):
        return None
    # the target-th free slot of the flattened rows: the first position at
    # which the running count reaches target
    running = torch.cumsum(free.view(-1), 0)
    target = (torch.cumsum(n_free, 0) - n_free)[inv_t] + rank_t + 1
    return torch.searchsorted(running, target) - inv_t * ell.width


def _patch_ell(ell: BlockedELL, row_old, k_old, drop,
               row_ins, nbr_ins, w_ins, c_ins):
    """Patch one cached blocked-ELL layout on its device: free the deleted
    slots, place the inserts in free slots of their rows, ±1 the affected
    tiles' ``tile_nnz``.  ``row_old`` / ``k_old`` / ``drop`` are the old
    edges' rows, slots and delete flags (device tensors, ``host_edges``
    order); the inserts are host arrays.  Returns ``(patched_ell, k_ins)``
    with the inserted edges' slots (device int64), or None when an inserted
    row has no free slot left (overflow → counted rebuild)."""
    dev = ell.nbrs.device
    r_del = row_old[drop].long()
    k_del = k_old[drop]
    row_ins = np.asarray(row_ins, dtype=np.int64)
    k_ins = _insert_slots(ell, r_del, k_del, row_ins)
    if k_ins is None:
        return None
    nbrs, ws = ell.nbrs.clone(), ell.weight.clone()
    cs, mask = ell.capacity.clone(), ell.mask.clone()
    tile_nnz = ell.tile_nnz.clone()
    shape = (ell.n_pad, ell.width, ell.block_v, ell.block_e)
    if r_del.numel():
        at = (r_del, k_del)
        mask[at] = False
        nbrs[at] = 0
        ws[at] = 0.0
        cs[at] = 0.0
        tile_nnz -= _tile_nnz(r_del, k_del, *shape)
    if row_ins.size:
        rows = _to(row_ins, dev)
        at = (rows, k_ins)
        mask[at] = True
        nbrs[at] = _to(np.asarray(nbr_ins).astype(np.int32), dev)
        ws[at] = _to(np.asarray(w_ins, dtype=np.float32), dev)
        cs[at] = _to(np.asarray(c_ins, dtype=np.float32), dev)
        tile_nnz += _tile_nnz(rows, k_ins, *shape)
    patched = BlockedELL(
        n=ell.n, n_pad=ell.n_pad, width=ell.width, block_v=ell.block_v,
        block_e=ell.block_e, nbrs=nbrs, weight=ws, capacity=cs, mask=mask,
        tile_nnz=tile_nnz, direction=ell.direction)
    return patched, k_ins


def _delete_mask(src, dst, n, delete) -> np.ndarray:
    """The keep mask of the current edge list after the delete batch: the
    j-th request for one (src, dst) key consumes the j-th occurrence of that
    parallel edge; a request with no occurrence left raises."""
    keep = np.ones(src.shape[0], dtype=bool)
    if delete is None:
        return keep
    if len(tuple(delete)) != 2:
        raise ValueError("delete must be a (src, dst) pair of vectors")
    dsrc = np.asarray(delete[0])
    ddst = np.asarray(delete[1])
    if dsrc.size == 0:
        dsrc = dsrc.astype(np.int32)
        ddst = ddst.astype(np.int32)
    for name, a in (("src", dsrc), ("dst", ddst)):
        if a.ndim != 1 or not np.issubdtype(a.dtype, np.integer):
            raise GraphValidationError(
                f"delete {name} must be a 1-d integer vector, got "
                f"shape {a.shape} dtype {a.dtype}")
    if dsrc.shape != ddst.shape:
        raise GraphValidationError(
            f"delete src/dst length mismatch: {dsrc.shape[0]} vs "
            f"{ddst.shape[0]}")
    if not dsrc.size:
        return keep
    if (dsrc.min() < 0 or dsrc.max() >= n
            or ddst.min() < 0 or ddst.max() >= n):
        raise GraphValidationError(
            f"delete batch endpoints out of range [0, {n})")
    key = src.astype(np.int64) * n + dst
    dkey = dsrc.astype(np.int64) * n + ddst.astype(np.int64)
    order = np.argsort(key, kind="stable")
    skey = key[order]
    dorder = np.argsort(dkey, kind="stable")
    sdkey = dkey[dorder]
    rank = np.arange(sdkey.size) - np.searchsorted(sdkey, sdkey)
    lo = np.searchsorted(skey, sdkey, side="left")
    hi = np.searchsorted(skey, sdkey, side="right")
    missing = rank >= (hi - lo)
    if missing.any():
        i = int(dorder[np.flatnonzero(missing)[0]])
        raise GraphValidationError(
            f"delete batch names {int(missing.sum())} edge(s) not "
            f"present in the graph, first "
            f"({int(dsrc[i])} -> {int(ddst[i])})")
    keep[order[lo + rank]] = False
    return keep


def _insert_batch(insert):
    """``(src, dst, weight, capacity)`` of the insert batch, weight and
    capacity defaulting to 1.0."""
    if insert is None:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.float32), np.zeros(0, np.float32))
    parts = tuple(insert)
    if len(parts) < 2:
        raise ValueError(
            "insert must be (src, dst[, weight[, capacity]]) vectors")
    isrc = np.asarray(parts[0])
    idst = np.asarray(parts[1])
    if isrc.size == 0:
        isrc = isrc.astype(np.int32)
        idst = idst.astype(np.int32)
    n_req = isrc.shape[0] if isrc.ndim else 0
    iw = (np.asarray(parts[2], dtype=np.float32)
          if len(parts) > 2 and parts[2] is not None
          else np.ones(n_req, np.float32))
    ic = (np.asarray(parts[3], dtype=np.float32)
          if len(parts) > 3 and parts[3] is not None
          else np.ones(n_req, np.float32))
    return isrc, idst, iw, ic


def mutate_edges(g: Graph, insert=None, delete=None, *,
                 self_loops: str = "allow", duplicates: str = "allow"):
    """Apply one batched edge mutation; returns ``(new_graph, delta)``.

    ``insert`` is ``(src, dst[, weight[, capacity]])`` arrays (weight and
    capacity default to 1.0, as in ``from_edges``); ``delete`` is
    ``(src, dst)`` pairs that must all exist: a k-fold request consumes k
    occurrences of a parallel edge, and naming a missing edge raises
    ``GraphValidationError``.  The merged edge list is validated under the
    ``self_loops`` / ``duplicates`` policies of ``from_edges`` (a duplicate
    insert under ``duplicates="error"`` raises with the standard text;
    ``self_loops="drop"`` filters, and what it removes of the old edges
    counts as deleted).  The new graph lives on ``g``'s device.

    Every blocked-ELL layout and push resolution cached for ``g`` is carried
    to the new graph by a patch on its device when the edit fits the padded
    widths, and falls back to a counted rebuild per layout on row overflow
    (module docstring)."""
    if self_loops not in ("allow", "drop", "error"):
        raise ValueError(f"self_loops must be allow|drop|error, "
                         f"got {self_loops!r}")
    if duplicates not in ("allow", "error"):
        raise ValueError(f"duplicates must be allow|error, got {duplicates!r}")
    if insert is None and delete is None:
        raise ValueError("mutate_edges needs an insert batch, a delete "
                         "batch, or both")
    edges = g.host_edges()
    src, dst, w, c = edges
    n, e = g.n, int(src.shape[0])
    keep = _delete_mask(src, dst, n, delete)
    isrc, idst, iw, ic = _insert_batch(insert)

    # the merged edge list, validated under the caller's policies
    new_src = np.concatenate([src[keep], isrc])
    new_dst = np.concatenate([dst[keep], idst])
    new_w = np.concatenate([w[keep], iw]).astype(np.float32)
    new_c = np.concatenate([c[keep], ic]).astype(np.float32)
    fmask = _check_edge_arrays(n, new_src, new_dst, new_w, new_c,
                               self_loops, duplicates)
    if fmask is not None:            # self_loops="drop" filtered the merge
        kept_idx = np.flatnonzero(keep)
        keep[kept_idx[~fmask[:kept_idx.size]]] = False
        ins_keep = fmask[kept_idx.size:]
        isrc, idst = isrc[ins_keep], idst[ins_keep]
        iw, ic = iw[ins_keep], ic[ins_keep]
        new_src, new_dst = new_src[fmask], new_dst[fmask]
        new_w, new_c = new_w[fmask], new_c[fmask]
    new_src = new_src.astype(np.int32, copy=False)
    new_dst = new_dst.astype(np.int32, copy=False)

    new_g = from_edges(n, new_src, new_dst, new_w, new_c, validate=False,
                       device=g.device)
    n_ins = int(isrc.shape[0])
    n_del = e - int(keep.sum())
    touched = np.unique(np.concatenate([
        src[~keep].astype(np.int64), dst[~keep].astype(np.int64),
        isrc.astype(np.int64), idst.astype(np.int64)]))

    # carry the cached layouts over by a patch, or count the rebuild
    patched = rebuilt = 0
    shapes = set()
    for (gid, bv, be, _d), (ref, _ell) in list(structure._ELL_CACHE.items()):
        if gid == id(g) and ref() is g:
            shapes.add((bv, be))
    dev = g.device
    keep_t = _to(keep, dev)
    drop_t = ~keep_t
    # the new graph's host_edges order: from_edges' stable sort by dst
    perm_new = torch.argsort(torch.cat(
        [g.by_dst.dst[keep_t], _to(idst.astype(np.int32), dev)]),
        stable=True)
    new_e = new_g.by_dst
    for bv, be in sorted(shapes):
        k_in_old, k_out_old = _slot_maps(g, bv, be)
        ell_in = _lookup(structure._ELL_CACHE, (id(g), bv, be, "in"), g)
        ell_out = _lookup(structure._ELL_CACHE, (id(g), bv, be, "out"), g)
        res_old = _lookup(structure._RES_CACHE, (id(g), bv, be), g)
        in_patch = out_patch = None
        if ell_in is not None:
            in_patch = _patch_ell(ell_in, g.by_dst.dst, k_in_old, drop_t,
                                  idst, isrc, iw, ic)
            if in_patch is None:
                rebuilt += 1
        if ell_out is not None:
            out_patch = _patch_ell(ell_out, g.by_dst.src, k_out_old, drop_t,
                                   isrc, idst, iw, ic)
            if out_patch is None:
                rebuilt += 1
        if in_patch is None and out_patch is None:
            if res_old is not None:
                rebuilt += 1         # its layouts rebuild, it follows them
            continue
        # The new graph's per-edge slots, host_edges-aligned: the patched
        # positions where the patch held, the canonical fill order where
        # the layout falls back to a lazy rebuild.
        if in_patch is not None:
            new_in, k_in_ins = in_patch
            k_in_full = torch.cat([k_in_old[keep_t], k_in_ins])[perm_new]
            w_in_f = new_in.width
            _install(structure._ELL_CACHE, (id(new_g), bv, be, "in"),
                     new_g, new_in)
            patched += 1
        else:
            k_in_full = _fill_order_slots(new_e.dst, n)
            w_in_f = _padded_width(new_g.in_deg, be)
        if out_patch is not None:
            new_out, k_out_ins = out_patch
            k_out_full = torch.cat([k_out_old[keep_t], k_out_ins])[perm_new]
            w_out_f = new_out.width
            _install(structure._ELL_CACHE, (id(new_g), bv, be, "out"),
                     new_g, new_out)
            patched += 1
        else:
            k_out_full = _fill_order_slots(new_e.src, n)
            w_out_f = _padded_width(new_g.out_deg, be)
        # the resolution MUST match the actual slots of both directions
        res = _resolution_from_slots(n, new_e.src, new_e.dst, k_in_full,
                                     k_out_full, w_in_f, w_out_f, bv, be)
        _install(structure._RES_CACHE, (id(new_g), bv, be), new_g, res)
        if res_old is not None:
            patched += 1
        _install(structure._SLOT_CACHE, (id(new_g), bv, be),
                 new_g, (k_in_full, k_out_full))

    MUTATION_STATS["mutations"] += 1
    MUTATION_STATS["patched_layouts"] += patched
    MUTATION_STATS["rebuilt_layouts"] += rebuilt
    return new_g, MutationDelta(
        inserted=n_ins, deleted=n_del, touched=touched,
        has_deletes=bool(n_del), patched_layouts=patched,
        rebuilt_layouts=rebuilt)
