"""Graph containers and the blocked-ELL layouts of the CUDA edge sweeps.

The port's counterpart of ``repro.graph.structure`` (its non-sharded part).
Edges are stored twice, in destination-sorted order (pull: segment
reductions key on ``dst``) and in source-sorted order (push: scatters key on
``src``), as torch tensors on the graph's device.

The layout builders stay host numpy, exactly as in the reference, so every
layout is bitwise-equal to the reference's; each array moves to the
graph's device once per layout.  Entry points take ``device=None``, which
means the CUDA card; without one they raise unless the caller passed
``device="cpu"`` (``resolve_device``).
"""
from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Optional

import numpy as np
import torch

from repro_torch.core.guard import GraphValidationError


def resolve_device(device=None) -> torch.device:
    """``None`` → the CUDA card.  There is no silent CPU run: without a card
    the caller must ask for ``device="cpu"`` explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _to(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:        # e.g. a view of a JAX array's buffer
        a = a.copy()
    return torch.from_numpy(a).to(device)


@dataclasses.dataclass(frozen=True)
class EdgeOrder:
    """One ordering of the edge list plus its per-edge data."""
    src: torch.Tensor        # [E] int32
    dst: torch.Tensor        # [E] int32
    weight: torch.Tensor     # [E] float32
    capacity: torch.Tensor   # [E] float32


@dataclasses.dataclass(frozen=True, eq=False)
class Graph:
    n: int
    by_dst: EdgeOrder        # sorted by dst (pull engines)
    by_src: EdgeOrder        # sorted by src (push engines)
    in_deg: torch.Tensor     # [n] int32
    out_deg: torch.Tensor    # [n] int32
    w_out_deg: Optional[torch.Tensor] = None   # [n] float32 Σ outgoing weight

    @property
    def device(self) -> torch.device:
        return self.in_deg.device

    @property
    def num_edges(self) -> int:
        return int(self.by_dst.src.shape[0])

    def host_edges(self):
        """(src, dst, weight, capacity) as numpy, dst-sorted."""
        e = self.by_dst
        return (e.src.cpu().numpy(), e.dst.cpu().numpy(),
                e.weight.cpu().numpy(), e.capacity.cpu().numpy())


def _check_edge_arrays(n: int, src, dst, weight, capacity,
                       self_loops: str, duplicates: str):
    """Host-side structural validation of raw edge arrays.  Raises
    ``GraphValidationError``; returns a boolean keep-mask when
    ``self_loops="drop"`` asks for filtering, else None."""
    if n < 1:
        raise GraphValidationError(f"graph needs n >= 1 vertices, got {n}")
    for name, a in (("src", src), ("dst", dst)):
        if a.ndim != 1:
            raise GraphValidationError(
                f"{name} must be a 1-d index vector, got shape {a.shape}")
        if not np.issubdtype(a.dtype, np.integer):
            raise GraphValidationError(
                f"{name} must be an integer vector, got dtype {a.dtype}")
    if src.shape != dst.shape:
        raise GraphValidationError(
            f"src/dst length mismatch: {src.shape[0]} vs {dst.shape[0]}")
    if src.size and (src.min() < 0 or src.max() >= n or
                     dst.min() < 0 or dst.max() >= n):
        bad = np.flatnonzero((src < 0) | (src >= n) | (dst < 0) | (dst >= n))
        raise GraphValidationError(
            f"edge endpoints out of range [0, {n}): {bad.size} bad edges, "
            f"first at position {int(bad[0])} "
            f"({int(src[bad[0]])} -> {int(dst[bad[0]])})")
    for name, a in (("weight", weight), ("capacity", capacity)):
        if a.shape != src.shape:
            raise GraphValidationError(
                f"{name} length {a.shape} does not match edge count "
                f"{src.shape}")
        if a.size and not np.isfinite(a).all():
            bad = np.flatnonzero(~np.isfinite(a))
            raise GraphValidationError(
                f"{name} has {bad.size} non-finite entries (NaN/Inf), "
                f"first at edge {int(bad[0])}")
    loops = src == dst
    n_loops = int(loops.sum())
    if n_loops and self_loops == "error":
        raise GraphValidationError(
            f"graph has {n_loops} self-loops under self_loops='error' "
            f"policy, first at edge {int(np.flatnonzero(loops)[0])}")
    if duplicates == "error" and src.size:
        key = src.astype(np.int64) * n + dst
        n_dup = key.size - _sorted_unique(key).size
        if n_dup:
            raise GraphValidationError(
                f"graph has {n_dup} duplicate edges under "
                "duplicates='error' policy")
    if n_loops and self_loops == "drop":
        return ~loops
    return None


def from_edges(n: int, src, dst, weight=None, capacity=None,
               validate: bool = True, self_loops: str = "allow",
               duplicates: str = "allow", device=None) -> Graph:
    """Build a Graph from raw edge arrays on ``device``.

    ``validate`` (default on) runs the host-side structural checks — index
    bounds, dtypes, finite weights/capacities — and the ``self_loops``
    ("allow" | "drop" | "error") and ``duplicates`` ("allow" | "error")
    policies; violations raise ``GraphValidationError``."""
    dev = resolve_device(device)
    if self_loops not in ("allow", "drop", "error"):
        raise ValueError(f"self_loops must be allow|drop|error, "
                         f"got {self_loops!r}")
    if duplicates not in ("allow", "error"):
        raise ValueError(f"duplicates must be allow|error, got {duplicates!r}")
    src = np.asarray(src)
    dst = np.asarray(dst)
    if src.size == 0:
        src = src.astype(np.int32)
    if dst.size == 0:
        dst = dst.astype(np.int32)
    e = src.shape[0] if src.ndim else 0
    if weight is None:
        weight = np.ones((e,), dtype=np.float32)
    if capacity is None:
        capacity = np.ones((e,), dtype=np.float32)
    weight = np.asarray(weight, dtype=np.float32)
    capacity = np.asarray(capacity, dtype=np.float32)
    if validate:
        keep = _check_edge_arrays(n, src, dst, weight, capacity,
                                  self_loops, duplicates)
        if keep is not None:
            src, dst = src[keep], dst[keep]
            weight, capacity = weight[keep], capacity[keep]
    src = src.astype(np.int32, copy=False)
    dst = dst.astype(np.int32, copy=False)
    edges = [_to(a, dev) for a in (src, dst, weight, capacity)]

    def order(key):
        # a stable sort on the device: the permutation of the host's stable
        # argsort, so the order is bitwise the reference's
        perm = torch.argsort(key, stable=True)
        return EdgeOrder(*(a[perm] for a in edges))

    in_deg = np.bincount(dst, minlength=n).astype(np.int32)
    out_deg = np.bincount(src, minlength=n).astype(np.int32)
    w_out = np.bincount(src, weights=weight.astype(np.float64),
                        minlength=n).astype(np.float32)
    return Graph(n=n, by_dst=order(edges[1]), by_src=order(edges[0]),
                 in_deg=_to(in_deg, dev), out_deg=_to(out_deg, dev),
                 w_out_deg=_to(w_out, dev))


def from_arrays(n: int, src, dst, weight, capacity, device=None) -> Graph:
    """Carry a reference graph across: ``(src, dst, weight, capacity)`` are
    numpy arrays as the JAX package's ``Graph.host_edges()`` returns them
    (dst-sorted).  The dst-sorted order — the order every layout builder
    reads — is reproduced exactly, so the port's layouts of the returned
    graph are bitwise-equal to the reference's."""
    return from_edges(n, np.asarray(src), np.asarray(dst),
                      np.asarray(weight, np.float32),
                      np.asarray(capacity, np.float32), device=device)


@dataclasses.dataclass(frozen=True)
class GraphCheck:
    """Validation summary of one graph (value ranges for the termination
    precondition probe, loop/duplicate counts for diagnostics)."""
    n: int
    num_edges: int
    w_min: float
    w_max: float
    c_min: float
    c_max: float
    self_loops: int
    duplicates: int


def _sorted_unique(keys: np.ndarray) -> np.ndarray:
    """``np.unique(keys)`` by a stable (merge/radix) sort: the edge keys
    here come nearly sorted, which can push ``np.unique``'s introsort into
    its slow fallback on tens of millions of keys."""
    k = np.sort(keys, kind="stable")
    if k.size == 0:
        return k
    keep = np.empty(k.size, dtype=bool)
    keep[0] = True
    np.not_equal(k[1:], k[:-1], out=keep[1:])
    return k[keep]


def _lookup(cache: dict, key, g):
    """The entry of ``g`` under ``key``, or None: a weakref guards against
    id() reuse."""
    hit = cache.get(key)
    if hit is None:
        return None
    ref, val = hit
    return val if ref() is g else None


def _install(cache: dict, key, g, val) -> None:
    """Store ``val`` for ``g``; a finalizer drops the entry when the graph
    is garbage-collected."""
    cache[key] = (weakref.ref(g), val)
    weakref.finalize(g, cache.pop, key, None)


def _cached(cache: dict, key, g, build):
    """Identity-keyed memo over ``_lookup`` / ``_install``."""
    val = _lookup(cache, key, g)
    if val is None:
        val = build()
        _install(cache, key, g, val)
    return val


_VALID_CACHE: dict = {}


def validate_graph(g: Graph) -> GraphCheck:
    """Validate an already-built Graph and return its ``GraphCheck`` (one
    O(E) host scan per graph, memoized)."""
    def build():
        src, dst, w, c = g.host_edges()
        _check_edge_arrays(g.n, src, dst, w, c,
                           self_loops="allow", duplicates="allow")
        loops = int((src == dst).sum())
        if src.size:
            key64 = src.astype(np.int64) * g.n + dst
            dups = int(key64.size - _sorted_unique(key64).size)
        else:
            dups = 0
        return GraphCheck(
            n=g.n, num_edges=int(src.shape[0]),
            w_min=float(w.min()) if w.size else 0.0,
            w_max=float(w.max()) if w.size else 0.0,
            c_min=float(c.min()) if c.size else 0.0,
            c_max=float(c.max()) if c.size else 0.0,
            self_loops=loops, duplicates=dups)
    return _cached(_VALID_CACHE, id(g), g, build)


@dataclasses.dataclass(frozen=True)
class GraphStats:
    """Per-graph statistics the query planner resolves knobs from."""
    n: int
    num_edges: int
    avg_degree: float
    max_out_degree: int
    max_in_degree: int
    degree_skew: float
    weighted: bool
    w_min: float
    w_max: float
    device_count: int
    backend: str


_STATS_CACHE: dict = {}


def graph_stats(g: Graph) -> GraphStats:
    """Memoized per-graph statistics — the planner's input."""
    def build():
        out_deg = g.out_deg.cpu().numpy()
        in_deg = g.in_deg.cpu().numpy()
        w = g.by_dst.weight.cpu().numpy()
        e = int(w.shape[0])
        avg = e / g.n
        max_out = int(out_deg.max()) if out_deg.size else 0
        cuda = g.device.type == "cuda"
        return GraphStats(
            n=g.n, num_edges=e, avg_degree=avg, max_out_degree=max_out,
            max_in_degree=int(in_deg.max()) if in_deg.size else 0,
            degree_skew=(max_out / avg) if avg > 0 else 0.0,
            weighted=bool(e and np.any(w != 1.0)),
            w_min=float(w.min()) if e else 0.0,
            w_max=float(w.max()) if e else 0.0,
            device_count=torch.cuda.device_count() if cuda else 1,
            backend=g.device.type)
    return _cached(_STATS_CACHE, id(g), g, build)


_WDEG_CACHE: dict = {}


def w_out_deg(g: Graph) -> torch.Tensor:
    """Weighted out-degree (Σ outgoing edge weight per vertex), the P
    environment's ``wdeg``; vertices with no out-edges read 1.0.  Computed
    once per graph so every engine and both sweep directions divide by the
    bit-identical vector."""
    def build():
        w = g.w_out_deg
        if w is None:
            src, _dst, wt, _c = g.host_edges()
            w = _to(np.bincount(src, weights=wt.astype(np.float64),
                                minlength=g.n).astype(np.float32), g.device)
        return torch.where(w > 0, w, torch.ones_like(w))
    return _cached(_WDEG_CACHE, id(g), g, build)


# ---------------------------------------------------------------------------
# Blocked-ELL layout for the CUDA edge sweeps.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockedELL:
    """Degree-padded neighbour lists in one direction.

    With ``direction="in"`` (the pull layout) row v holds the predecessors
    of v; with ``direction="out"`` (the push layout) row v holds the
    successors.  ``mask`` marks real slots; ``n_pad``/``width`` are
    multiples of the tile sizes; ``tile_nnz[i, j]`` counts real slots per
    (block_v × block_e) tile."""
    n: int
    n_pad: int
    width: int
    block_v: int
    block_e: int
    nbrs: torch.Tensor       # [n_pad, width] int32
    weight: torch.Tensor     # [n_pad, width] float32
    capacity: torch.Tensor   # [n_pad, width] float32
    mask: torch.Tensor       # [n_pad, width] bool
    tile_nnz: torch.Tensor   # [n_pad/block_v, width/block_e] int32
    direction: str = "in"

    @functools.cached_property
    def tiles_static(self) -> torch.Tensor:
        """int32 [n_pad/block_v, width/block_e]: 1 where the tile holds a
        real slot (``tile_nnz > 0``).  Built once per layout: the tile list
        the sweeps walk when every tile that can run may run."""
        return (self.tile_nnz > 0).to(torch.int32)

    @functools.cached_property
    def row_tile_walk(self) -> tuple:
        """The tile walk of the level sweep, built once per layout, at
        (8 × 128) tiles whatever the layout's tiling: ``tiles`` int32
        [n_pad/8, width/128], 1 where the tile lies in a non-empty layout
        tile; ``counts`` int32 [n_pad/8], such tiles per 8-row tile; and
        ``multi`` int32, the 8-row tiles that hold two or more of them (the
        rows whose partials must be combined)."""
        live = (self.tile_nnz > 0) \
            .repeat_interleave(self.block_v // 8, 0) \
            .repeat_interleave(self.block_e // 128, 1)
        counts = live.sum(1, dtype=torch.int32)
        multi = torch.nonzero(counts >= 2).flatten().to(torch.int32)
        return live.to(torch.int32).contiguous(), counts, multi

    @property
    def srcs(self) -> torch.Tensor:
        """Pull-layout alias: the neighbour ids ARE the edge sources."""
        if self.direction != "in":
            raise AttributeError(
                "BlockedELL.srcs is only meaningful on the pull layout "
                f"(direction='in'); this layout is direction={self.direction!r}"
                " — use .nbrs")
        return self.nbrs


def _padded_width(deg: torch.Tensor, block_e: int) -> int:
    """Max degree padded up to the slot-tile size — THE width rule of every
    blocked layout."""
    width = max(1, int(deg.max()) if deg.numel() else 1)
    return ((width + block_e - 1) // block_e) * block_e


def _fill_order_slots(row_of: torch.Tensor, n: int) -> torch.Tensor:
    """Per-edge slot index under the left-to-right row fill rule, edges in
    ``host_edges()`` order (int64, on the rows' device) — THE slot
    assignment of ``to_blocked_ell``."""
    dev = row_of.device
    perm = torch.argsort(row_of, stable=True)
    # rank within the row = position in the stable order − the row's start
    counts = torch.bincount(row_of, minlength=n)
    starts = torch.cumsum(counts, 0) - counts
    out = torch.empty(row_of.shape[0], dtype=torch.int64, device=dev)
    out[perm] = torch.arange(row_of.shape[0], device=dev) \
        - starts[row_of[perm].long()]
    return out


def _tile_nnz(rows: torch.Tensor, ks: torch.Tensor, n_pad: int, width: int,
              block_v: int, block_e: int) -> torch.Tensor:
    """Slots per (block_v × block_e) tile among (rows, ks): int32
    ``[n_pad/block_v, width/block_e]``."""
    n_j = width // block_e
    return torch.bincount((rows // block_v) * n_j + ks // block_e,
                          minlength=(n_pad // block_v) * n_j) \
        .to(torch.int32).view(n_pad // block_v, n_j)


def to_blocked_ell(g: Graph, block_v: int = 8, block_e: int = 128,
                   direction: str = "in") -> BlockedELL:
    """Build the blocked-ELL layout keyed by dst (``direction="in"``) or by
    src (``direction="out"``) on the graph's device."""
    e = g.by_dst
    if direction == "in":
        row_of, nbr_of, deg = e.dst, e.src, g.in_deg
    elif direction == "out":
        row_of, nbr_of, deg = e.src, e.dst, g.out_deg
    else:
        raise ValueError(f"direction must be 'in' or 'out', got {direction!r}")
    n = g.n
    width = _padded_width(deg, block_e)
    n_pad = ((n + block_v - 1) // block_v) * block_v
    dev = g.device
    rows = row_of.long()
    ks = _fill_order_slots(row_of, n)
    at = (rows, ks)

    def rect(dtype, vals):
        out = torch.zeros((n_pad, width), dtype=dtype, device=dev)
        out[at] = vals
        return out
    return BlockedELL(n=n, n_pad=n_pad, width=width,
                      block_v=block_v, block_e=block_e,
                      nbrs=rect(torch.int32, nbr_of),
                      weight=rect(torch.float32, e.weight),
                      capacity=rect(torch.float32, e.capacity),
                      mask=rect(torch.bool, True),
                      tile_nnz=_tile_nnz(rows, ks, n_pad, width, block_v,
                                         block_e),
                      direction=direction)


_ELL_CACHE: dict = {}


def blocked_ell_cached(g: Graph, block_v: int = 8, block_e: int = 128,
                       direction: str = "in") -> BlockedELL:
    """Memoized ``to_blocked_ell`` (one entry per graph and direction)."""
    return _cached(_ELL_CACHE, (id(g), block_v, block_e, direction), g,
                   lambda: to_blocked_ell(g, block_v=block_v,
                                          block_e=block_e,
                                          direction=direction))


# ---------------------------------------------------------------------------
# Dst-sorted push-resolution layout.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PushResolution:
    """Dst-major permutation of the out-edge rectangle, as segment metadata.

    ``in2out[v, k]`` is the flat out-rectangle index of the edge that is the
    k-th dst-major candidate slot of v (the pull layout's fill order, so a
    reduction over this rectangle is the pull sweep's reduction tree);
    ``valid`` marks real slots; ``src_tile`` is the flat out-tile id owning
    each slot; ``tile_nnz`` counts real slots per resolution tile and
    ``contrib[t]`` lists the out-tiles contributing to resolution tile t
    (−1 padded)."""
    n: int
    n_pad: int
    width: int
    out_width: int
    block_v: int
    block_e: int
    in2out: torch.Tensor     # [n_pad, width] int32
    valid: torch.Tensor      # [n_pad, width] bool
    src_tile: torch.Tensor   # [n_pad, width] int32
    tile_nnz: torch.Tensor   # [n_pad/block_v, width/block_e] int32
    contrib: torch.Tensor    # [n_tiles, c_max] int32, −1 pad


def _resolution_from_slots(n, src, dst, k_in, k_out, w_in, w_out,
                           block_v, block_e) -> PushResolution:
    """The dst-major resolution over explicit per-edge slots and widths.
    ``src`` / ``dst`` / ``k_in`` / ``k_out`` are tensors in ``host_edges``
    (dst-sorted) order on the graph's device, where every field is built:
    ``in2out[dst[i], k_in[i]] = src[i]·w_out + k_out[i]``, O(E) tile ids,
    a sorted unique over the (resolution tile, out-tile) pairs and a cumsum
    rank into ``contrib``.  The canonical layouts' slots are the fill order
    (``to_push_resolution``); a patched pair's are wherever a free slot was
    (``graph.mutate``)."""
    dev = src.device
    n_pad = ((n + block_v - 1) // block_v) * block_v
    if n_pad * w_out >= 2 ** 31:
        raise ValueError(
            f"out rectangle {n_pad}×{w_out} overflows int32 flat indices; "
            "the dst-sorted resolution layout needs an int64 gather path "
            "for graphs this hub-heavy")
    n_j_in = w_in // block_e
    n_j_out = w_out // block_e
    n_tiles = (n_pad // block_v) * n_j_in
    n_out_tiles = (n_pad // block_v) * n_j_out
    src, dst = src.long(), dst.long()
    s_tile = (src // block_v) * n_j_out + k_out // block_e
    r_tile = (dst // block_v) * n_j_in + k_in // block_e
    tile_nnz = torch.bincount(r_tile, minlength=n_tiles).to(torch.int32) \
        .view(n_pad // block_v, n_j_in)
    pair = torch.unique(r_tile * n_out_tiles + s_tile)       # sorted
    r_ids = pair // n_out_tiles
    counts = torch.bincount(r_ids, minlength=n_tiles)
    c_max = max(1, int(counts.max())) if counts.numel() else 1
    contrib = torch.full((n_tiles, c_max), -1, dtype=torch.int32, device=dev)
    # r_ids is sorted: rank within its run = position − the run's start
    # (O(E), where a searchsorted over tens of millions of ids is not)
    contrib[r_ids, torch.arange(r_ids.numel(), device=dev)
            - (torch.cumsum(counts, 0) - counts)[r_ids]] = \
        (pair % n_out_tiles).to(torch.int32)
    in2out = torch.zeros((n_pad, w_in), dtype=torch.int32, device=dev)
    valid = torch.zeros((n_pad, w_in), dtype=torch.bool, device=dev)
    src_tile = torch.zeros((n_pad, w_in), dtype=torch.int32, device=dev)
    at = (dst, k_in)
    in2out[at] = (src * w_out + k_out).to(torch.int32)
    valid[at] = True
    src_tile[at] = s_tile.to(torch.int32)
    return PushResolution(
        n=n, n_pad=n_pad, width=w_in, out_width=w_out,
        block_v=block_v, block_e=block_e, in2out=in2out, valid=valid,
        src_tile=src_tile, tile_nnz=tile_nnz, contrib=contrib)


def to_push_resolution(g: Graph, block_v: int = 8, block_e: int = 128,
                       min_width: int = 0,
                       min_out_width: int = 0) -> PushResolution:
    """Build the dst-major resolution permutation for the push sweep by the
    reference's exact slot rules (``_fill_order_slots``/``_padded_width``),
    on the graph's device."""
    e = g.by_dst
    w_in = max(_padded_width(g.in_deg, block_e), int(min_width))
    w_out = max(_padded_width(g.out_deg, block_e), int(min_out_width))
    return _resolution_from_slots(
        g.n, e.src, e.dst, _fill_order_slots(e.dst, g.n),
        _fill_order_slots(e.src, g.n), w_in, w_out, block_v, block_e)


_RES_CACHE: dict = {}


def push_resolution_cached(g: Graph, block_v: int = 8,
                           block_e: int = 128) -> PushResolution:
    """Memoized ``to_push_resolution`` (one entry per graph and tile
    shape)."""
    return _cached(_RES_CACHE, (id(g), block_v, block_e), g,
                   lambda: to_push_resolution(g, block_v=block_v,
                                              block_e=block_e))


# Per-graph edge→slot maps kept by ``graph.mutate``: in a PATCHED layout an
# edge's slot is wherever a free slot was, not the left-to-right fill order,
# so a mutation records the actual (k_in, k_out) per edge (int64 tensors on
# the graph's device, aligned to ``host_edges`` order) here, and a chained
# mutation patches from them.  The same (identity key, weakref, finalizer)
# contract as every other structure cache.
_SLOT_CACHE: dict = {}


def clear_graph_caches(g: Graph) -> int:
    """Drop every cached derived structure of ONE graph (layouts,
    resolutions, degrees, validation summary, statistics and mutation slot
    maps); returns the number of entries dropped."""
    dropped = 0
    for cache in (_ELL_CACHE, _RES_CACHE, _WDEG_CACHE, _VALID_CACHE,
                  _STATS_CACHE, _SLOT_CACHE):
        stale = [k for k, (ref, _) in list(cache.items()) if ref() is g]
        for k in stale:
            if cache.pop(k, None) is not None:
                dropped += 1
    return dropped


# ---------------------------------------------------------------------------
# Synthetic graph generators (seeded, host-side numpy — the same draws as the
# reference's, so the same seed gives the same edges).
# ---------------------------------------------------------------------------

def _dedupe(n, src, dst):
    keep = src != dst  # drop self loops
    src, dst = src[keep], dst[keep]
    key = src.astype(np.int64) * n + dst
    _, idx = np.unique(key, return_index=True)
    return src[idx], dst[idx]


def rmat_graph(n: int, e: int, seed: int = 0, weighted: bool = True,
               a=0.57, b=0.19, c=0.19, device=None) -> Graph:
    """R-MAT power-law generator (Chakrabarti et al.), deduped, no self
    loops.  The default initiator is Graph500's Kronecker A, B, C."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(n, 2))))
    src = np.zeros(e, dtype=np.int64)
    dst = np.zeros(e, dtype=np.int64)
    for _level in range(scale):
        r = rng.random(e)
        right = r >= a + b
        bottom = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        src = src * 2 + bottom
        dst = dst * 2 + right
    src, dst = src % n, dst % n
    src, dst = _dedupe(n, src, dst)
    w = rng.integers(1, 64, size=src.shape[0]).astype(np.float32) if weighted \
        else np.ones(src.shape[0], np.float32)
    cap = rng.integers(1, 64, size=src.shape[0]).astype(np.float32) if weighted \
        else np.ones(src.shape[0], np.float32)
    return from_edges(int(n), src.astype(np.int32), dst.astype(np.int32), w,
                      cap, device=device)


def uniform_graph(n: int, e: int, seed: int = 0, weighted: bool = True,
                  device=None) -> Graph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=e)
    dst = rng.integers(0, n, size=e)
    src, dst = _dedupe(n, src, dst)
    w = rng.integers(1, 16, size=src.shape[0]).astype(np.float32) if weighted \
        else np.ones(src.shape[0], np.float32)
    cap = rng.integers(1, 16, size=src.shape[0]).astype(np.float32) if weighted \
        else np.ones(src.shape[0], np.float32)
    return from_edges(int(n), src.astype(np.int32), dst.astype(np.int32), w,
                      cap, device=device)


def line_graph(n: int, weighted: bool = False, seed: int = 0,
               device=None) -> Graph:
    src = np.arange(n - 1)
    dst = np.arange(1, n)
    rng = np.random.default_rng(seed)
    w = rng.integers(1, 9, size=n - 1).astype(np.float32) if weighted \
        else np.ones(n - 1, np.float32)
    return from_edges(n, src, dst, w, w[::-1].copy(), device=device)


def grid_graph(rows: int, cols: int, seed: int = 0, device=None) -> Graph:
    """4-neighbour mesh, bidirectional edges."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    s = [idx[:, :-1].ravel(), idx[:-1, :].ravel()]
    d = [idx[:, 1:].ravel(), idx[1:, :].ravel()]
    src = np.concatenate(s + d)
    dst = np.concatenate(d + s)
    rng = np.random.default_rng(seed)
    w = rng.random(src.shape[0]).astype(np.float32) + 0.5
    return from_edges(rows * cols, src, dst, w, w, device=device)


def undirected(g: Graph) -> Graph:
    """Symmetrize: add reverse edges, deduplicated (CC assumes undirected
    graphs)."""
    src, dst, w, c = g.host_edges()
    s2 = np.concatenate([src, dst])
    d2 = np.concatenate([dst, src])
    w2 = np.concatenate([w, w])
    c2 = np.concatenate([c, c])
    key = s2.astype(np.int64) * g.n + d2
    _, idx = np.unique(key, return_index=True)
    return from_edges(g.n, s2[idx], d2[idx], w2[idx], c2[idx],
                      device=g.device)
