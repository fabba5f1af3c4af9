"""Plain-torch oracles for every kernel of this package — the port's copy
of ``repro.kernels.ref``.

Each ``ref_*`` function computes what the corresponding kernel computes,
with plain torch ops and no tiling, so the tests can compare a kernel (or
its plain version) against it across shapes and dtypes.  They are the
oracles the JAX package's kernel tests use, on torch tensors.
"""
from __future__ import annotations

import math

import torch

from repro_torch.graph import segment


def _reduce(op: str, x, dim: int):
    if op == "min":
        return x.amin(dim=dim)
    if op == "max":
        return x.amax(dim=dim)
    if op == "sum":
        return x.sum(dim=dim, dtype=x.dtype)
    if op == "prod":
        return x.prod(dim=dim, dtype=x.dtype)
    raise ValueError(op)


def ref_ell_reduce(op: str, values, mask, ident):
    """Masked row-reduction over a blocked-ELL tile layout.

    values [n_pad, width], mask [n_pad, width] → [n_pad].
    """
    masked = torch.where(mask, values, torch.as_tensor(ident, dtype=values.dtype))
    return _reduce(op, masked, 1)


def ref_edge_level(op: str, state, srcs, mask, p_of, ident, bot,
                   tie_masks=None):
    """One lex level of the blocked-ELL gather→propagate→reduce.

    state [n] per-vertex values; srcs/mask [n_pad, width]; ``p_of(nvals,
    srcs)`` applies the propagation to the gathered values.  ``tie_masks``
    [n_pad, width] further restricts eligible slots (lex ties).  Returns
    [n_pad] per-vertex partial reduction.
    """
    nvals = state[srcs.long()]
    p = p_of(nvals, srcs)
    p = torch.where(nvals == bot, torch.as_tensor(ident, dtype=p.dtype), p)
    m = mask if tie_masks is None else (mask & tie_masks)
    return ref_ell_reduce(op, p, m, ident)


def _take_rows(table, idx):
    """``table[idx]`` with JAX's index rule: a negative index wraps once,
    then every index is clamped into range."""
    v = table.shape[0]
    i = idx.long()
    i = torch.where(i < 0, i + v, i).clamp(0, v - 1)
    return table[i]


def ref_embedding_bag(table, idx, offsets=None, mode: str = "sum",
                      weights=None):
    """EmbeddingBag: gather rows of ``table`` [V, D] for flat indices
    ``idx`` [N] grouped into bags by ``offsets`` [B] (start positions), or
    fixed-width bags when ``idx`` is [B, K]."""
    if idx.ndim == 2:                                 # fixed-width bags
        rows = _take_rows(table, idx)                 # [B, K, D]
        if weights is not None:
            rows = rows * weights[..., None]
        if mode == "sum":
            return rows.sum(dim=1)
        if mode == "mean":
            return rows.mean(dim=1)
        if mode == "max":
            return rows.amax(dim=1)
        raise ValueError(mode)
    if offsets is None:
        raise ValueError("flat indices need offsets")
    n, b = idx.shape[0], offsets.shape[0]
    marks = torch.zeros(n, dtype=torch.int32, device=idx.device)
    if b > 1:
        marks.index_add_(0, offsets[1:].long(),
                         torch.ones(b - 1, dtype=torch.int32,
                                    device=idx.device))
    seg = torch.cumsum(marks, 0)
    rows = _take_rows(table, idx)
    if weights is not None:
        rows = rows * weights[:, None]
    d = rows.shape[1]
    if mode in ("sum", "mean"):
        s = torch.zeros((b, d), dtype=rows.dtype, device=rows.device)
        s.index_add_(0, seg.long(), rows)
        if mode == "sum":
            return s
        cnt = torch.zeros(b, dtype=torch.float32, device=rows.device)
        cnt.index_add_(0, seg.long(), torch.ones(n, device=rows.device))
        return s / cnt.clamp(min=1.0)[:, None]
    if mode == "max":
        init = torch.full((b, d), float("-inf"), dtype=rows.dtype,
                          device=rows.device)
        return init.scatter_reduce(0, seg.long()[:, None].expand(n, d), rows,
                                   "amax", include_self=True)
    raise ValueError(mode)


def ref_ell_softmax(scores, mask):
    """Masked row softmax over an ELL tile layout (GAT edge attention).

    scores/mask [n_pad, width] → attention weights [n_pad, width] with
    masked slots exactly 0 and each real row summing to 1.
    """
    neg = torch.finfo(scores.dtype).min
    s = torch.where(mask, scores, torch.as_tensor(neg, dtype=scores.dtype))
    m = s.amax(dim=1, keepdim=True)
    e = torch.where(mask, torch.exp(s - m), 0.0)
    denom = e.sum(dim=1, keepdim=True)
    return e / denom.clamp(min=1e-30)


def ref_segment_softmax(scores, segment_ids, num_segments):
    return segment.segment_softmax(scores, segment_ids, num_segments)


def ref_flash_attention(q, k, v, causal: bool = True, scale=None,
                        chunk: int | None = None):
    """Plain softmax attention oracle (optionally local/chunked).

    q [B, H, S, D], k/v [B, Hkv, S, D] with H a multiple of Hkv (GQA).
    ``chunk`` restricts attention to the same chunk of size ``chunk``.
    """
    b, h, s, d = q.shape
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    if scale is None:                  # 1 / sqrt(d) rounded to q's type
        scale = 1.0 / torch.tensor(math.sqrt(d)).to(q.dtype)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    m = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        m = m & (ki <= qi)
    if chunk is not None:
        m = m & (qi // chunk == ki // chunk)
    logits = torch.where(m, logits, torch.finfo(logits.dtype).min)
    p = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)
