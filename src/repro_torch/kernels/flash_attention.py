"""Forward flash attention: two CUDA kernels and a plain version.

The port of ``repro.kernels.flash_attention``: q [B, H, S, D], k/v [B,
Hkv, T, D] (H a multiple of Hkv, grouped-query heads), float32 or
bfloat16, with a causal mask and/or a chunked-local mask (llama4 iRoPE:
key // chunk == query // chunk), positions starting at 0 for queries and
keys alike → [B, H, S, D] in q's dtype.  Any S and T; D in {16, 32, 64,
128}.

Both kernels replace ``_flash_kernel``, and ``flash_attention`` picks one by
dtype (a documented dispatch, not a fallback: each serves every call of
its dtype).  Both run their products on the tensor cores with ``wgmma``,
Q once and K/V through a shared-memory ring loaded by TMA, and the online
softmax in registers:

- bfloat16 → ``csrc/flash_attention_sm90.cu`` (``flash_sm90_kernel``): P
  split into a bfloat16 high and low part so that p·v keeps float32's
  accuracy, as the reference's float32 ``p @ v`` does;
- float32 → ``csrc/flash_attention_3xtf32.cu`` (``flash_3xtf32_kernel``):
  3xTF32.  Every operand x is split into hi = x rounded to TF32 and lo =
  the TF32 rounding of x − hi, and each product is a_hi·b_hi + a_hi·b_lo +
  a_lo·b_hi with float32 accumulators, which keeps float32's accuracy at
  three TF32 products' cost (one TF32 product alone keeps 11 bits of each
  operand).  V is split into a transposed Vᵀ, which TF32 ``wgmma`` needs.

Each runs one block per (b·h, tile of queries), walks only the KV tiles
its rows can see and reads the KV head as h // (H / Hkv), never repeated.
The plain version computes the same function with whole matrix products
per KV head; the kernels are held to a tolerance against it.

``flash_attention`` launches a kernel for CUDA tensors (checking device,
dtype, shape and contiguity, and the launch status) and counts the launch
in ``LAUNCHES`` under its route (``flash_sm90`` or ``flash_f32``) and in
the total ``flash``; for CPU tensors it runs the plain version.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels.launch import check, raise_on, stream

LAUNCHES = {"flash": 0, "flash_sm90": 0, "flash_f32": 0}

_NEG = -1e30
_HEAD_DIMS = (16, 32, 64, 128)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def flash_attention(q, k, v, causal: bool = True,
                    chunk: Optional[int] = None):
    """q [B, H, S, D]; k/v [B, Hkv, T, D] (GQA: H a multiple of Hkv).

    Returns [B, H, S, D].  Forward only."""
    if q.ndim != 4 or k.ndim != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"q must be [B, H, S, D] and k, v one [B, Hkv, T, "
                         f"D] shape, got {tuple(q.shape)}, {tuple(k.shape)},"
                         f" {tuple(v.shape)}")
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or h % hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (H must be a multiple of Hkv)")
    if chunk is not None and chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if not q.is_cuda:
        return _flash_plain(q, k, v, causal, chunk)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        check(name, x, q.dtype)
    if q.dtype == torch.bfloat16:
        out, route = _launch_sm90(q, k, v, causal, chunk), "flash_sm90"
    else:
        out, route = _launch_f32(q, k, v, causal, chunk), "flash_f32"
    LAUNCHES[route] += 1
    LAUNCHES["flash"] += 1
    return out


def _args(q, k, v, out, causal, chunk):
    b, h, s, d = q.shape
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            k.shape[1], s, k.shape[2], d, int(causal),
            0 if chunk is None else int(chunk), 1.0 / math.sqrt(d))


def _launch_f32(q, k, v, causal, chunk):
    """The float32 3xTF32 tensor-core kernel on checked card tensors."""
    from repro_torch.kernels import build
    out = torch.empty_like(q)
    raise_on(build.fixed_library().grafs_flash_3xtf32(
        *_args(q, k, v, out, causal, chunk), stream(q)), "flash_3xtf32")
    return out


def _launch_sm90(q, k, v, causal, chunk):
    """The bfloat16 tensor-core kernel on checked card tensors."""
    from repro_torch.kernels import build
    out = torch.empty_like(q)
    raise_on(build.fixed_library().grafs_flash_sm90(
        *_args(q, k, v, out, causal, chunk), stream(q)), "flash_sm90")
    return out


def kernel_attributes(dtype, d: int) -> dict:
    """The compiled kernel of ``dtype``'s route at head dim ``d``: registers
    per thread, local (spill) bytes per thread and shared-memory bytes per
    block (``cudaFuncGetAttributes``; needs the card)."""
    from repro_torch.kernels import build
    lib = build.fixed_library()
    fn = (lib.grafs_flash_sm90_attributes if dtype == torch.bfloat16
          else lib.grafs_flash_3xtf32_attributes)
    attrs = (ctypes.c_int * 4)()
    raise_on(fn(d, attrs), "flash attributes")
    return {"registers": attrs[0], "local_bytes": attrs[1],
            "static_smem_bytes": attrs[2], "dynamic_smem_bytes": attrs[3]}


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
    """The plain version: float32 arithmetic, or float64 for float64
    inputs (the oracle the float32 kernel is held to on the card)."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    rep = h // hkv
    scale = 1.0 / math.sqrt(d)
    if t == 0:
        return torch.zeros_like(q)
    mask = attention_mask(s, t, causal, chunk, q.device)
    out = torch.empty_like(q)
    ct = torch.promote_types(q.dtype, torch.float32)
    for bi in range(b):
        for g in range(hkv):                 # the query heads of KV head g
            qf = q[bi, g * rep:(g + 1) * rep].to(ct)
            kf, vf = k[bi, g].to(ct), v[bi, g].to(ct)
            logits = torch.where(mask, qf @ kf.T * scale, _NEG)
            m = logits.amax(dim=-1, keepdim=True).clamp(min=_NEG)
            p = torch.where(mask, torch.exp(logits - m), 0.0)
            l = p.sum(dim=-1, keepdim=True)
            out[bi, g * rep:(g + 1) * rep] = \
                ((p @ vf) / l.clamp(min=1e-30)).to(q.dtype)
    return out
