"""Forward flash attention: CUDA kernel and plain version.

The port of ``repro.kernels.flash_attention``: q [B, H, S, D], k/v [B,
Hkv, T, D] (H a multiple of Hkv, grouped-query heads), float32 or
bfloat16, with a causal mask and/or a chunked-local mask (llama4 iRoPE:
key // chunk == query // chunk), positions starting at 0 for queries and
keys alike → [B, H, S, D] in q's dtype.  Any S and T; D in {16, 32, 64,
128}.

The kernel (``csrc/flash_attention.cu``, replacing ``_flash_kernel``) runs
one block per (b·h, tile of queries), walks the KV tiles through shared
memory with the online-softmax recurrence and computes both products in
float32 on the CUDA cores; the KV head is read as h // (H / Hkv), never
repeated.  The plain version computes the same function with whole
matrix products per KV head; the two are held to a tolerance.

``flash_attention`` launches the kernel for CUDA tensors (checking device,
dtype, shape and contiguity, and the launch status) and counts the launch
in ``LAUNCHES``; for CPU tensors it runs the plain version.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.launch import check, raise_on, stream

LAUNCHES = {"flash": 0}

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def reset_launches() -> None:
    LAUNCHES["flash"] = 0


def flash_attention(q, k, v, causal: bool = True,
                    chunk: Optional[int] = None):
    """q [B, H, S, D]; k/v [B, Hkv, T, D] (GQA: H a multiple of Hkv).

    Returns [B, H, S, D].  Forward only."""
    if q.ndim != 4 or k.ndim != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"q must be [B, H, S, D] and k, v one [B, Hkv, T, "
                         f"D] shape, got {tuple(q.shape)}, {tuple(k.shape)},"
                         f" {tuple(v.shape)}")
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or h % hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (H must be a multiple of Hkv)")
    if chunk is not None and chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if not q.is_cuda:
        return _flash_plain(q, k, v, causal, chunk)
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        check(name, x, q.dtype)
    from repro_torch.kernels import build
    lib = build.fixed_library()
    out = torch.empty_like(q)
    status = lib.grafs_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, hkv,
        s, t, d, int(causal), 0 if chunk is None else int(chunk),
        1.0 / math.sqrt(d), _DTYPES[q.dtype], stream(q))
    raise_on(status, "flash_attention")
    LAUNCHES["flash"] += 1
    return out


def attention_mask(s: int, t: int, causal: bool, chunk: Optional[int],
                   device=None):
    """[S, T] bool: which keys each query sees (positions from 0)."""
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if chunk is not None:
        mask = mask & (kpos // chunk == qpos // chunk)
    return mask


def _flash_plain(q, k, v, causal, chunk):
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    rep = h // hkv
    scale = 1.0 / math.sqrt(d)
    if t == 0:
        return torch.zeros_like(q)
    mask = attention_mask(s, t, causal, chunk, q.device)
    out = torch.empty_like(q)
    for bi in range(b):
        for g in range(hkv):                 # the query heads of KV head g
            qf = q[bi, g * rep:(g + 1) * rep].float()
            kf, vf = k[bi, g].float(), v[bi, g].float()
            logits = torch.where(mask, qf @ kf.T * scale, _NEG)
            m = logits.amax(dim=-1, keepdim=True).clamp(min=_NEG)
            p = torch.where(mask, torch.exp(logits - m), 0.0)
            l = p.sum(dim=-1, keepdim=True)
            out[bi, g * rep:(g + 1) * rep] = \
                ((p @ vf) / l.clamp(min=1e-30)).to(q.dtype)
    return out
