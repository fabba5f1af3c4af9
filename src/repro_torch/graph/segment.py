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
through ``scatter_reduce``.
"""
from __future__ import annotations

import numpy as np
import torch

# Large-but-finite sentinel; float identities are ±inf.
INT_INF = np.iinfo(np.int32).max // 2

_TORCH_TO_NP = {torch.int32: np.int32, torch.float32: np.float32,
                torch.bool: np.bool_, torch.int64: np.int64}


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
    """Deterministic float sum/prod: stable sort by segment, then one
    ``segment_reduce`` over the contiguous runs (empty segments read the
    identity)."""
    ids = segment_ids.long()
    if ids.numel() > 1 and bool((ids[1:] < ids[:-1]).any()):
        perm = torch.sort(ids, stable=True).indices
        ids, data = ids[perm], data[perm]
    bounds = torch.searchsorted(
        ids, torch.arange(num_segments + 1, device=ids.device))
    return torch.segment_reduce(data, op, lengths=bounds.diff(),
                                initial=float(identity(op, data.dtype)))


def segment_reduce(op: str, data, segment_ids, num_segments: int):
    """Pull-side reduction: dst-keyed segment reduce with identity fill."""
    if op in ("or", "and"):
        out = segment_reduce("max" if op == "or" else "min",
                             data.to(torch.int32), segment_ids, num_segments)
        return out.to(data.dtype)
    init = torch.full((num_segments,), identity(op, data.dtype).item(),
                      dtype=data.dtype, device=data.device)
    return scatter_reduce(op, init, data, segment_ids)


def scatter_reduce(op: str, init, data, segment_ids):
    """Push-side reduction: ``init.at[ids].op(data)``.  ``init`` must already
    hold current values (idempotent path) or identities (non-idempotent)."""
    ids = segment_ids.long()
    if op in ("min", "max"):
        return init.clone().scatter_reduce_(0, ids, data.to(init.dtype),
                                            "a" + op, include_self=True)
    if op in ("or", "and"):
        red = "amax" if op == "or" else "amin"
        return init.clone().scatter_reduce_(0, ids, data.to(init.dtype), red,
                                            include_self=True)
    if op in ("sum", "prod"):
        if not init.dtype.is_floating_point:
            # integer sums/products are exact in any order
            return init.clone().scatter_reduce_(0, ids, data.to(init.dtype),
                                                op, include_self=True)
        part = _sorted_segment(op, data.to(init.dtype), ids, init.shape[0])
        return init + part if op == "sum" else init * part
    raise ValueError(f"unknown reduction {op}")


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
    """Numerically-stable per-segment softmax (GAT edge attention)."""
    ids = segment_ids.long()
    smax = segment_reduce("max", scores, segment_ids, num_segments)
    ex = torch.exp(scores - smax[ids])
    denom = segment_reduce("sum", ex, segment_ids, num_segments)
    return ex / denom[ids].clamp(min=1e-30)
