"""Segment/scatter reduction primitives with explicit monoid identities.

Condition C6 of the paper (``R(n, ⊥) = n``) makes ⊥ the identity element of
every admissible reduction, so ⊥ is represented by the identity value of the
monoid.  Every engine draws identities from here so they agree bit-for-bit.

``psum_like`` folds the per-shard partials of the sharded engines in shard
order.

Float sums never use atomics: a float ``sum``/``prod`` segment reduction
sorts by segment (stable) and reduces each contiguous segment with
``torch.segment_reduce``, so its order is fixed run to run on the card.
Min/max reductions and integer sums are exact in any order, so they go
through ``scatter_reduce``.  Every reduction takes rows: ``data`` [e, ...]
reduces into [num_segments, ...] (``segment_sum`` is the GNNs' message sum;
``segment_softmax`` normalises each column of [e, H] per segment).
"""
from __future__ import annotations

import numpy as np
import torch

# Large-but-finite sentinel; float identities are ±inf.
INT_INF = np.iinfo(np.int32).max // 2

_TORCH_TO_NP = {torch.int32: np.int32, torch.float32: np.float32,
                torch.float64: np.float64, torch.bool: np.bool_,
                torch.int64: np.int64}


def _np_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return np.dtype(_TORCH_TO_NP[dtype])
    return np.dtype(dtype)


def identity(op: str, dtype):
    """Monoid identity as a NumPy scalar of ``dtype`` (a torch or numpy
    dtype)."""
    dt = _np_dtype(dtype)
    integer = np.issubdtype(dt, np.integer)
    if op == "min":
        v = INT_INF if integer else np.inf
    elif op == "max":
        v = -INT_INF if integer else -np.inf
    elif op == "sum":
        v = 0
    elif op == "prod":
        v = 1
    elif op == "or":
        v = False
    elif op == "and":
        v = True
    else:
        raise ValueError(f"unknown reduction {op}")
    return dt.type(v)


def _sorted_segment(op: str, data, segment_ids, num_segments: int):
    """Deterministic float sum/prod of the rows of ``data``: stable sort by
    segment (skipped, with its copy of ``data``, where the ids are already
    sorted), then one ``segment_reduce`` along axis 0 over the contiguous
    runs (empty segments read the identity).  ``meta`` ids have no values
    to test, so they take the sort, as unsorted ids would."""
    ids = segment_ids.long()
    if ids.numel() > 1 and (ids.is_meta
                            or bool((ids[1:] < ids[:-1]).any())):
        perm = torch.sort(ids, stable=True).indices
        ids, data = ids[perm], data[perm]
    bounds = torch.searchsorted(
        ids, torch.arange(num_segments + 1, device=ids.device))
    return torch.segment_reduce(data, op, lengths=bounds.diff(),
                                initial=float(identity(op, data.dtype)))


def segment_sum(data, segment_ids, num_segments: int):
    """Float rows ``data`` [e, ...] summed per segment into
    [num_segments, ...] in the fixed order (``_sorted_segment``); an empty
    segment reads 0."""
    if not data.dtype.is_floating_point:
        raise TypeError(f"segment_sum sums float rows, got {data.dtype}")
    return _sorted_segment("sum", data, segment_ids, num_segments)


def segment_reduce(op: str, data, segment_ids, num_segments: int):
    """Pull-side reduction: dst-keyed segment reduce with identity fill,
    rows ``data`` [e, ...] into [num_segments, ...]."""
    if op in ("or", "and"):
        out = segment_reduce("max" if op == "or" else "min",
                             data.to(torch.int32), segment_ids, num_segments)
        return out.to(data.dtype)
    init = torch.full((num_segments, *data.shape[1:]),
                      identity(op, data.dtype).item(), dtype=data.dtype,
                      device=data.device)
    return scatter_reduce(op, init, data, segment_ids)


def scatter_reduce(op: str, init, data, segment_ids):
    """Push-side reduction: ``init.at[ids].op(data)`` over rows (``ids``
    [e], ``data`` [e, ...]).  ``init`` must already hold current values
    (idempotent path) or identities (non-idempotent)."""
    ids = segment_ids.long()
    if op in ("sum", "prod") and init.dtype.is_floating_point:
        part = _sorted_segment(op, data.to(init.dtype), ids, init.shape[0])
        return init + part if op == "sum" else init * part
    if op not in _MONOIDS:
        raise ValueError(f"unknown reduction {op}")
    # min/max/or/and, and integer sums/products, are exact in any order;
    # scatter_reduce_ takes one index per element of ``data``
    ids = ids.view(-1, *(1,) * (data.dim() - 1)).expand(data.shape)
    red = {"min": "amin", "max": "amax", "or": "amax", "and": "amin"}.get(
        op, op)
    return init.clone().scatter_reduce_(0, ids, data.to(init.dtype), red,
                                        include_self=True)


def combine(op: str, a, b):
    """Elementwise monoid combine."""
    if op in ("min", "and"):
        return torch.minimum(a, b)
    if op in ("max", "or"):
        return torch.maximum(a, b)
    if op == "sum":
        return a + b
    if op == "prod":
        return a * b
    raise ValueError(f"unknown reduction {op}")


_MONOIDS = ("min", "max", "sum", "prod", "or", "and")


def psum_like(op: str, parts, mesh) -> list:
    """Cross-shard combine of the sharded engines: the k per-shard partials
    ``parts`` (``parts[j]`` on ``mesh.devices[j]``) folded with ``combine``
    in shard order 0…k−1 on ``mesh.devices[0]``, the result handed back to
    each shard's device (a list; no copy where a shard shares that device).
    ``or`` / ``and`` fold as int32 max / min, ``prod`` as a product.  The
    fixed order makes float sums reproducible run to run; they may differ
    from a collective's summation tree in the last ulps."""
    if op not in _MONOIDS:
        raise ValueError(f"unknown reduction {op}")
    devs = tuple(mesh.devices)
    if len(parts) != len(devs):
        raise ValueError(f"{len(parts)} partials for {len(devs)} shards")
    fold = {"or": "max", "and": "min"}.get(op, op)
    acc = None
    for p in parts:
        p = p.to(devs[0])
        if op in ("or", "and"):
            p = p.to(torch.int32)
        acc = p if acc is None else combine(fold, acc, p)
    acc = acc.to(parts[0].dtype)
    return [acc.to(d) for d in devs]


def segment_softmax(scores, segment_ids, num_segments: int):
    """Numerically-stable per-segment softmax (GAT edge attention): each
    column of ``scores`` [e] or [e, H] normalised over its segment."""
    ids = segment_ids.long()
    smax = segment_reduce("max", scores, segment_ids, num_segments)
    ex = torch.exp(scores - smax[ids])
    denom = segment_reduce("sum", ex, segment_ids, num_segments)
    return ex / denom[ids].clamp(min=1e-30)
