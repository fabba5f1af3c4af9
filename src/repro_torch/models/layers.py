"""Transformer building blocks: RMSNorm, RoPE, GQA/MLA attention, SwiGLU,
MoE — parameterized by LMConfig.

The port of ``repro.models.layers``.  Conventions:

  * a parameter set ``p`` is anything indexed by name like the reference's
    dicts (``p["wq"]``): a plain dict of tensors or the ``Params`` modules
    of ``models.transformer``;
  * compute dtype is cfg.dtype (bf16 for the big configs); params live in
    cfg.param_dtype and are cast per product, as the reference casts them
    per einsum; norms, rope angles and softmax run in float32 (a float64
    model keeps float64 there too: ``_wide``);
  * a KV cache is a dict of one layer's tensors, written IN PLACE at a
    host offset (the reference returns an updated copy).  Within range
    the write lands where ``dynamic_update_slice_in_dim`` writes; past
    the cache's end it raises ``ValueError`` where the reference clamps
    the offset and writes early.

The reference's sharding annotations (``shard_hint``, the ``*_specs``
trees) have no counterpart: ``hint_axes`` and ``loop_impl`` stay in
``LMConfig`` for parity and change no result here; ``remat="full"``
recomputes each layer in the backward (``models.transformer``).  No kernel of
``kernels/`` runs here: the reference's model calls none either (its
attention is its own online-softmax scan over KV tiles).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0                 # shared (always-on) experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    first_dense_layers: int = 0       # deepseek-v3: first k layers are dense
    interleave_step: int = 1          # llama4: MoE every k-th layer

    def is_moe_layer(self, li: int) -> bool:
        if li < self.first_dense_layers:
            return False
        return (li - self.first_dense_layers) % self.interleave_step == \
            self.interleave_step - 1


@dataclasses.dataclass(frozen=True)
class MLACfg:
    """DeepSeek multi-head latent attention dims."""
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None
    qkv_bias: bool = False            # qwen2
    rope_theta: float = 500000.0
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    # llama4 iRoPE: local chunked attention, every `chunk_global_every`-th
    # layer is global. None ⇒ all layers full causal attention.
    attn_chunk: Optional[int] = None
    chunk_global_every: int = 4
    norm_eps: float = 1e-5
    # MLA decode: "absorbed" folds W_uk/W_uv through the attention so
    # scores/context stay in the r-dim latent space; "auto": absorbed when
    # q_len == 1 with a cache.
    mla_decode: str = "auto"          # "auto" | "absorbed" | "expanded"
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: str = "full"               # "full" | "none": per-layer recompute
    attn_impl: str = "chunked"        # "chunked" (online softmax) | "naive"
    kv_chunk: int = 1024              # KV tile for chunked attention
    # "scan" | "unroll": the reference's lax.scan or Python loops; one
    # Python loop here (no effect)
    loop_impl: str = "scan"
    # mesh axes of the reference's sharding hints (no effect here)
    hint_axes: tuple = ()
    # MoE dispatch groups: tokens bucket into per-group expert queues, the
    # capacity is per group.  1 = a single flat group.
    moe_groups: int = 1
    # int8 KV cache (per-token-per-head scales)
    kv_quant: bool = False
    # multi-token prediction (deepseek-v3): extra depth-1 MTP head
    mtp: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None \
            else self.d_model // self.n_heads

    def param_count(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, l = self.d_model, self.n_layers
        if self.mla is not None:
            m = self.mla
            attn = (d * m.q_lora_rank
                    + m.q_lora_rank * self.n_heads
                    * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.n_heads
                    * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d)
        else:
            hd = self.head_dim
            attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                + (self.n_heads * hd) * d
        if self.moe is not None:
            mo = self.moe
            moe_l = sum(mo.is_moe_layer(i) for i in range(l))
            dense_l = l - moe_l
            ffn = dense_l * 3 * d * self.d_ff + moe_l * (
                (mo.n_experts + mo.n_shared) * 3 * d * mo.d_ff_expert
                + d * mo.n_experts)
        else:
            ffn = l * 3 * d * self.d_ff
        return l * attn + ffn + 2 * self.vocab * d

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        d, l = self.d_model, self.n_layers
        mo = self.moe
        if self.mla is not None:
            m = self.mla
            attn = (d * m.q_lora_rank
                    + m.q_lora_rank * self.n_heads
                    * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.n_heads
                    * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d)
        else:
            hd = self.head_dim
            attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                + (self.n_heads * hd) * d
        moe_l = sum(mo.is_moe_layer(i) for i in range(l))
        dense_l = l - moe_l
        ffn = dense_l * 3 * d * self.d_ff + moe_l * (
            (mo.top_k + mo.n_shared) * 3 * d * mo.d_ff_expert
            + d * mo.n_experts)
        return l * attn + ffn + 2 * self.vocab * d


# ---------------------------------------------------------------------------
# Small primitives
# ---------------------------------------------------------------------------

# float32 elements drawn at once by _dense_init (512 MB): an expert weight
# of deepseek-v3 (256 × 7168 × 2048) is drawn in slices of experts
_INIT_CHUNK = 1 << 27


def _dt(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _pdt(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _norm_init(shape, dtype, device):
    return torch.ones(shape, dtype=dtype, device=device)


def _dense_init(gen: Optional[torch.Generator], shape, dtype, device,
                scale: Optional[float] = None):
    """normal × scale (default 1/√fan_in), drawn in float32 and cast, as
    the reference's, fan_in = shape[-2] as it takes it (for the 3-D
    attention weights the head count or head dim, not the contracted
    size); the draws come from ``gen`` (on ``device``), so they are not
    JAX's.  On ``meta`` only the shape is made."""
    device = torch.device(device)
    out = torch.empty(shape, dtype=dtype, device=device)
    if device.type == "meta":
        return out
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    rows = out.view(shape[0], -1)
    step = max(1, _INIT_CHUNK // max(1, rows.shape[1]))
    for r0 in range(0, rows.shape[0], step):
        blk = rows[r0:r0 + step]
        blk.copy_(torch.randn(blk.shape, generator=gen, dtype=torch.float32,
                              device=device) * s)
    return out


def _wide(x):
    """x in float32, the precision of the reference's norms and softmax, or
    as it is where it is already float64."""
    return x if x.dtype == torch.float64 else x.float()


def rms_norm(x, gamma, eps: float):
    xf = _wide(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def rope_freqs(positions, dim: int, theta: float, dtype=torch.float32):
    """positions [...,] → (cos, sin) [..., dim/2]."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, cos, sin):
    """x [..., S, H, D]; cos/sin [..., S, D/2] (broadcast over heads)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _causal_mask(kpos, q_pos, chunk):
    """[B, S, T]: key position ≤ query position (and, with a local chunk,
    in the query's chunk)."""
    mask = kpos[None, None, :] <= q_pos[:, :, None]
    if chunk is not None:
        mask = mask & (kpos[None, None, :] // chunk
                       == q_pos[:, :, None] // chunk)
    return mask


def _write_offset(positions, offset: Optional[int], s: int,
                  length: int) -> int:
    """The cache write offset: ``offset``, or the first position id (one
    host read), checked against the cache's length."""
    off = int(positions[0, 0]) if offset is None else int(offset)
    if off < 0 or off + s > length:
        raise ValueError(f"cache write of {s} positions at offset {off} "
                         f"outside a cache of {length}")
    return off


# ---------------------------------------------------------------------------
# Attention (GQA) — shared by train (full seq) and serve (KV-cache decode).
# ---------------------------------------------------------------------------

def init_attention(cfg: LMConfig, gen, device):
    hd = cfg.head_dim
    pdt = _pdt(cfg)
    p = {
        "wq": _dense_init(gen, (cfg.d_model, cfg.n_heads, hd), pdt, device),
        "wk": _dense_init(gen, (cfg.d_model, cfg.n_kv_heads, hd), pdt,
                          device),
        "wv": _dense_init(gen, (cfg.d_model, cfg.n_kv_heads, hd), pdt,
                          device),
        "wo": _dense_init(gen, (cfg.n_heads, hd, cfg.d_model), pdt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.n_heads, hd), dtype=pdt, device=device)
        p["bk"] = torch.zeros((cfg.n_kv_heads, hd), dtype=pdt, device=device)
        p["bv"] = torch.zeros((cfg.n_kv_heads, hd), dtype=pdt, device=device)
    return p


def _sdpa_naive(q, k, v, q_pos, chunk, dtype):
    """Reference attention: materializes the full [B,H,S,T] logits.
    q [B,S,H,D], k/v [B,T,Hkv,D], q_pos [B,S] absolute positions."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    q = q.reshape(b, s, hkv, g, d)
    logits = torch.einsum("bskgd,btkd->bkgst", q, k) / math.sqrt(d)
    logits = _wide(logits)
    mask = _causal_mask(torch.arange(t, device=q.device), q_pos, chunk)
    logits = torch.where(mask[:, None, None], logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, s, h, d)


def _kv_chunk_for(t: int, want: int) -> int:
    c = min(want, t)
    while t % c:
        c -= 1
    return max(c, 1)


# ---------------------------------------------------------------------------
# Flash-style chunked attention core: the online softmax over KV tiles,
# one loop for every mode but "naive" (the reference's "chunked" flash
# core and its "scan" / "unroll" bodies compute the same tile products).
#
# Differentiated as the reference's custom VJP is: ``_FlashCore`` saves
# only (primals, row max m, row sum l, out) and its backward recomputes
# each KV tile's probabilities and takes that tile's VJP, so the [S, T]
# probabilities are never held for the backward.  Without a gradient to
# take (serving) the loop runs as a plain function.
#
# Generic over a ``chunk_fn(primals, idx) → (logits, v_tile)``:
#   logits [..., R, KC] (float32 or wider), already masked (-inf), already
#   scaled; v_tile [..., KC, DV] with the same leading dims.
# GQA's primals are (q, k, v, q_pos); MLA's (q_nope, q_rope, c_kv, k_r,
# wuk, wuv, q_pos), so the latent up-projections' gradients come out of
# the same tile VJPs.  A fully masked tile leaves the running max at
# -inf; its probabilities and the rescale ``alpha`` are then guarded to
# 0, never NaN.
# ---------------------------------------------------------------------------

def _flash_fwd_scan(chunk_fn, n_chunks):
    """The softmax-weighted sum of the tiles' values [..., R, DV], the row
    max m and the row sum l [..., R] of ``chunk_fn(idx)``'s tiles."""
    m = l = acc = None
    for idx in range(n_chunks):
        logits, v_c = chunk_fn(idx)
        if m is None:
            m = torch.full(logits.shape[:-1], -math.inf, dtype=logits.dtype,
                           device=logits.device)
            l = torch.zeros_like(m)
            acc = m.new_zeros(m.shape + v_c.shape[-1:])
        m_new = torch.maximum(m, logits.amax(dim=-1))
        safe = torch.isfinite(m_new)
        p = torch.exp(logits - torch.where(safe, m_new, 0.0)[..., None])
        p = torch.where(safe[..., None], p, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, v_c)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None], m, l


class _FlashCore(torch.autograd.Function):
    """``_flash_fwd_scan`` over ``chunk_fn(primals, idx)`` with the
    reference's tile-recomputing backward (``_flash_core_bwd``): with
    dG = dout / l and dL = −Σ dout·out / l, each tile's unnormalised
    probabilities p = exp(logits − m) are recomputed and the VJP of
    (p·v, Σ p) taken against (dG, dL); the primals' gradients are summed
    over the tiles in float32 (float64 for a float64 model) and cast to
    their dtypes once."""

    @staticmethod
    def forward(ctx, chunk_fn, n_chunks, *primals):
        out, m, l = _flash_fwd_scan(lambda idx: chunk_fn(primals, idx),
                                    n_chunks)
        ctx.chunk_fn, ctx.n_chunks = chunk_fn, n_chunks
        ctx.save_for_backward(*primals, m, l, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        *primals, m, l, out = ctx.saved_tensors
        wrt = [i for i, need in enumerate(ctx.needs_input_grad[2:]) if need]
        l_safe = torch.clamp(l, min=1e-30)
        dout = dout.to(l.dtype)
        d_g = dout / l_safe[..., None]
        d_l = -torch.sum(dout * out, dim=-1) / l_safe
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        grads = [None] * len(primals)
        for idx in range(ctx.n_chunks):
            with torch.enable_grad():
                pr = list(primals)
                for i in wrt:
                    pr[i] = primals[i].detach().requires_grad_(True)
                logits, v_c = ctx.chunk_fn(pr, idx)
                p = torch.exp(logits - m_safe[..., None])    # unnormalised
                d_pr = torch.autograd.grad(
                    (torch.matmul(p, v_c), p.sum(dim=-1)),
                    [pr[i] for i in wrt], (d_g, d_l), allow_unused=True)
            for i, g in zip(wrt, d_pr):
                if g is not None:
                    g = _wide(g)
                    grads[i] = g if grads[i] is None else grads[i] + g
        return (None, None, *[None if g is None else g.to(x.dtype)
                              for g, x in zip(grads, primals)])


def _flash_core(chunk_fn, n_chunks, primals):
    """The attention of ``chunk_fn``'s tiles, through ``_FlashCore`` where
    a gradient is to be taken, else the plain loop."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in primals if isinstance(t, torch.Tensor)):
        return _FlashCore.apply(chunk_fn, n_chunks, *primals)
    out, _, _ = _flash_fwd_scan(lambda idx: chunk_fn(primals, idx),
                                n_chunks)
    return out


def _gqa_chunk(kc, chunk, scale, primals, idx):
    """Tile logits [b, hkv, g·s, kc] of the queries q [b, s, h, d], each
    KV head's g query heads grouped as g·s rows, and the tile's values
    [b, hkv, kc, d], each KV head once."""
    q, k, v, q_pos = primals
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qr = _wide(q.reshape(b, s, hkv, g, d))
    c0 = idx * kc
    k_c = _wide(k[:, c0:c0 + kc])
    v_c = _wide(v[:, c0:c0 + kc])
    logits = torch.einsum("bskgd,btkd->bkgst", qr, k_c) * scale
    kpos = c0 + torch.arange(kc, device=q.device)
    mask = _causal_mask(kpos, q_pos, chunk)
    logits = torch.where(mask[:, None, None], logits, -math.inf)
    return logits.reshape(b, hkv, g * s, kc), v_c.transpose(1, 2)


def _sdpa(q, k, v, q_pos, chunk, dtype, kv_chunk: int = 1024,
          impl: str = "chunked"):
    """Online-softmax attention over KV chunks (flash-style).

    Never materializes [S, T] logits, forward or backward: peak extra
    memory is O(B·H·S·kv_chunk).  Causal and chunked-local (llama4 iRoPE)
    masking are computed per KV tile from positions.  ``impl``: "naive"
    (whole logits, plain autograd); any other of the reference's modes
    ("chunked", "scan", "unroll") runs the one online-softmax loop.
    """
    if impl == "naive":
        return _sdpa_naive(q, k, v, q_pos, chunk, dtype)
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    kc = _kv_chunk_for(t, kv_chunk)
    chunk_fn = functools.partial(_gqa_chunk, kc, chunk, 1.0 / math.sqrt(d))
    out = _flash_core(chunk_fn, t // kc, (q, k, v, q_pos))
    out = out.reshape(b, hkv, g, s, -1)
    return torch.movedim(out, 3, 1).reshape(b, s, h, -1).to(dtype)


def _quantize_int8(x):
    """Per-token-per-head int8 codes of x [B, S, Hkv, D] and their scales
    max|x|/127 + 1e-9 [B, S, Hkv] in x's dtype; rounded half to even, as
    ``jnp.round`` rounds."""
    scale = x.abs().amax(dim=-1) / 127.0 + 1e-9
    return torch.round(x / scale[..., None]).to(torch.int8), scale


def gqa_qkv(cfg: LMConfig, p, x, positions):
    """The projected, biased and rotated (q, k, v), [B, S, heads, D]."""
    dt = _dt(cfg)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    cos, sin = rope_freqs(positions, cfg.head_dim, cfg.rope_theta, dt)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def gqa_attention(cfg: LMConfig, p, x, positions, chunk, cache=None,
                  offset: Optional[int] = None):
    """Returns (out [B,S,D_model], cache or None).

    ``positions`` [B,S] absolute token positions (rope + causal mask);
    ``chunk`` — local-attention chunk size or None (global causal);
    cache = {"k": [B, S_max, Hkv, D], "v": …} (int8: + "k_s", "v_s"),
    written in place at ``offset`` (default: positions[0, 0]).
    """
    dt = _dt(cfg)
    q, k, v = gqa_qkv(cfg, p, x, positions)
    if cache is not None:
        s = x.shape[1]
        off = _write_offset(positions, offset, s, cache["k"].shape[1])
        if "k_s" in cache:
            # int8 cache: quantize this step's K/V
            kq, ks = _quantize_int8(k)
            vq, vs = _quantize_int8(v)
            cache["k"][:, off:off + s] = kq
            cache["v"][:, off:off + s] = vq
            cache["k_s"][:, off:off + s] = ks.float()
            cache["v_s"][:, off:off + s] = vs.float()
            k = cache["k"].to(dt) * cache["k_s"].to(dt)[..., None]
            v = cache["v"].to(dt) * cache["v_s"].to(dt)[..., None]
        else:
            # write this step's K/V at the first position id (prefill: 0)
            cache["k"][:, off:off + s] = k.to(cache["k"].dtype)
            cache["v"][:, off:off + s] = v.to(cache["v"].dtype)
            k, v = cache["k"].to(dt), cache["v"].to(dt)
    out = _sdpa(q, k, v, positions, chunk, dt, kv_chunk=cfg.kv_chunk,
                impl=cfg.attn_impl)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))
    return out, cache


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V2/V3): low-rank compressed KV latent.
# ---------------------------------------------------------------------------

def init_mla(cfg: LMConfig, gen, device):
    m = cfg.mla
    pdt = _pdt(cfg)
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wdq": _dense_init(gen, (cfg.d_model, m.q_lora_rank), pdt, device),
        "wuq": _dense_init(gen, (m.q_lora_rank, cfg.n_heads, qk_head), pdt,
                           device),
        "wdkv": _dense_init(gen, (cfg.d_model, m.kv_lora_rank), pdt, device),
        "wkr": _dense_init(gen, (cfg.d_model, m.qk_rope_head_dim), pdt,
                           device),
        "wuk": _dense_init(gen, (m.kv_lora_rank, cfg.n_heads,
                                 m.qk_nope_head_dim), pdt, device),
        "wuv": _dense_init(gen, (m.kv_lora_rank, cfg.n_heads,
                                 m.v_head_dim), pdt, device),
        "wo": _dense_init(gen, (cfg.n_heads, m.v_head_dim, cfg.d_model), pdt,
                          device),
    }


def _mla_chunk(kc, scale, primals, idx):
    """Tile logits [b, h, s, kc] and values [b, h, kc, dv] for MLA: expands
    the latent tile to per-head (k_nope, v) inside the tile (the backward
    recomputes it, and its VJP gives wuk's and wuv's gradients)."""
    q_nope, q_rope, c_kv, k_r, wuk, wuv, q_pos = primals
    c0 = idx * kc
    c_c = _wide(c_kv[:, c0:c0 + kc])
    kr_c = _wide(k_r[:, c0:c0 + kc])
    k_nope = torch.einsum("btr,rhk->bthk", c_c, _wide(wuk))
    v_c = torch.einsum("btr,rhk->bhtk", c_c, _wide(wuv))
    logits = (torch.einsum("bshk,bthk->bhst", _wide(q_nope), k_nope)
              + torch.einsum("bshk,btk->bhst", _wide(q_rope), kr_c)) * scale
    kpos = c0 + torch.arange(kc, device=c_kv.device)
    mask = _causal_mask(kpos, q_pos, None)
    logits = torch.where(mask[:, None], logits, -math.inf)
    return logits, v_c


def _mla_sdpa_chunked(cfg, p, q_nope, q_rope, c_kv, k_r, q_pos, dt):
    """Online-softmax MLA attention over latent chunks.

    Each KV tile expands c_kv → per-head (k_nope, v) on the tile, so the
    full-sequence per-head K/V never exist.  The reference's scan and
    unroll bodies compute the same tile products in the same order, so
    one loop serves both ``loop_impl``s.
    """
    m = cfg.mla
    b, s, h, _ = q_nope.shape
    t = c_kv.shape[1]
    kc = _kv_chunk_for(t, cfg.kv_chunk)
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    out = _flash_core(functools.partial(_mla_chunk, kc, scale), t // kc,
                      (q_nope, q_rope, c_kv, k_r, p["wuk"], p["wuv"],
                       q_pos))
    return out.transpose(1, 2).to(dt)                     # [b,s,h,dv]


def _mla_sdpa_absorbed(cfg, p, q_nope, q_rope, c_kv, k_r, q_pos, dt):
    """Absorbed MLA attention (DeepSeek-V2 §"matrix absorption").

    By associativity, scores = (q W_uk)·c_kv and context = (p·c_kv) W_uv —
    so the per-head K/V expansion of the whole cache collapses into two
    per-query projections.
    """
    m = cfg.mla
    t = c_kv.shape[1]
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    # fold W_uk into the query: [b,s,h,r]
    q_lat = torch.einsum("bshk,rhk->bshr", _wide(q_nope), _wide(p["wuk"]))
    c32 = _wide(c_kv)
    logits = (torch.einsum("bshr,btr->bhst", q_lat, c32)
              + torch.einsum("bshk,btk->bhst", _wide(q_rope),
                             _wide(k_r))) * scale
    mask = _causal_mask(torch.arange(t, device=c_kv.device), q_pos, None)
    logits = torch.where(mask[:, None], logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhst,btr->bshr", w, c32)
    out = torch.einsum("bshr,rhk->bshk", ctx, _wide(p["wuv"]))
    return out.to(dt)


def mla_qkv(cfg: LMConfig, p, x, positions):
    """The query's (nope, rotated rope) parts [B,S,H,·], the latent c_kv
    [B,S,r] and the rotated shared rope key k_r [B,S,d_r]."""
    dt = _dt(cfg)
    m = cfg.mla
    q = torch.einsum("bsd,dr->bsr", x, p["wdq"].to(dt))
    q = torch.einsum("bsr,rhk->bshk", q, p["wuq"].to(dt))
    q_nope, q_rope = torch.split(
        q, [m.qk_nope_head_dim, q.shape[-1] - m.qk_nope_head_dim], dim=-1)
    c_kv = torch.einsum("bsd,dr->bsr", x, p["wdkv"].to(dt))
    k_r = torch.einsum("bsd,dk->bsk", x, p["wkr"].to(dt))
    cos, sin = rope_freqs(positions, m.qk_rope_head_dim, cfg.rope_theta, dt)
    q_rope = apply_rope(q_rope, cos, sin)
    k_r = apply_rope(k_r[:, :, None, :], cos, sin)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_r


def mla_attention(cfg: LMConfig, p, x, positions, chunk, cache=None,
                  offset: Optional[int] = None):
    """MLA: cache holds the compressed latent c_kv [B, S, r] and the shared
    rope key k_r [B, S, d_r], written in place at ``offset``."""
    dt = _dt(cfg)
    m = cfg.mla
    s = x.shape[1]
    q_nope, q_rope, c_kv, k_r = mla_qkv(cfg, p, x, positions)
    if cache is not None:
        off = _write_offset(positions, offset, s, cache["c_kv"].shape[1])
        cache["c_kv"][:, off:off + s] = c_kv.to(cache["c_kv"].dtype)
        cache["k_r"][:, off:off + s] = k_r.to(cache["k_r"].dtype)
        c_kv, k_r = cache["c_kv"].to(dt), cache["k_r"].to(dt)
    absorbed = cfg.mla_decode == "absorbed" or \
        (cfg.mla_decode == "auto" and s == 1 and cache is not None)
    if absorbed:
        out = _mla_sdpa_absorbed(cfg, p, q_nope, q_rope, c_kv, k_r,
                                 positions, dt)
    elif cfg.attn_impl == "chunked":
        out = _mla_sdpa_chunked(cfg, p, q_nope, q_rope, c_kv, k_r,
                                positions, dt)
    else:
        # naive reference: expand the full latent, materialize logits
        k_nope = torch.einsum("btr,rhk->bthk", c_kv, p["wuk"].to(dt))
        v = torch.einsum("btr,rhk->bthk", c_kv, p["wuv"].to(dt))
        scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
        logits = (torch.einsum("bshk,bthk->bhst", q_nope, k_nope)
                  + torch.einsum("bshk,btk->bhst", q_rope, k_r)) * scale
        logits = _wide(logits)
        t = c_kv.shape[1]
        msk = _causal_mask(torch.arange(t, device=x.device), positions, None)
        logits = torch.where(msk[:, None], logits, -1e30)
        w = torch.softmax(logits, dim=-1).to(dt)
        out = torch.einsum("bhst,bthk->bshk", w, v)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))
    return out, cache


# ---------------------------------------------------------------------------
# FFN: SwiGLU and MoE.
# ---------------------------------------------------------------------------

def init_swiglu(d_model: int, d_ff: int, gen, dtype, device):
    return {"wg": _dense_init(gen, (d_model, d_ff), dtype, device),
            "wu": _dense_init(gen, (d_model, d_ff), dtype, device),
            "wd": _dense_init(gen, (d_ff, d_model), dtype, device)}


def swiglu(p, x, dt):
    g = torch.einsum("bsd,df->bsf", x, p["wg"].to(dt))
    u = torch.einsum("bsd,df->bsf", x, p["wu"].to(dt))
    h = F.silu(g) * u
    return torch.einsum("bsf,fd->bsd", h, p["wd"].to(dt))


def init_moe(cfg: LMConfig, gen, device):
    mo = cfg.moe
    e = mo.n_experts
    pdt = _pdt(cfg)
    p = {
        "router": _dense_init(gen, (cfg.d_model, e), torch.float32, device),
        "wg": _dense_init(gen, (e, cfg.d_model, mo.d_ff_expert), pdt,
                          device),
        "wu": _dense_init(gen, (e, cfg.d_model, mo.d_ff_expert), pdt,
                          device),
        "wd": _dense_init(gen, (e, mo.d_ff_expert, cfg.d_model), pdt,
                          device),
    }
    if mo.n_shared:
        p["shared"] = init_swiglu(cfg.d_model, mo.n_shared * mo.d_ff_expert,
                                  gen, pdt, device)
    return p


def _moe_rank_in_expert(top_flat, e):
    """Per-assignment rank within its expert queue, per row of
    ``top_flat`` [G, n] (sort-based; never a [tokens, E] one-hot)."""
    n = top_flat.shape[-1]
    order = torch.argsort(top_flat, dim=-1, stable=True)
    sorted_e = torch.gather(top_flat, -1, order)
    experts = torch.arange(e, device=top_flat.device).expand(
        top_flat.shape[0], e).contiguous()
    starts = torch.searchsorted(sorted_e, experts, side="left")
    rank_sorted = torch.arange(n, device=top_flat.device) \
        - torch.gather(starts, -1, sorted_e)
    # back to assignment order: the inverse permutation of ``order``
    return torch.gather(rank_sorted, -1, torch.argsort(order, dim=-1))


class Routing(NamedTuple):
    """The router's decision for t tokens in G groups of tg."""
    probs: torch.Tensor     # [t, E] float32
    gate: torch.Tensor      # [t, k] float32, renormalized over the top k
    top: torch.Tensor       # [t, k] int64, the higher probability first
    rank: torch.Tensor      # [G, tg·k] rank in the expert's group queue
    keep: torch.Tensor      # [G, tg·k] rank < cap
    cap: int                # per-group capacity of each expert


def moe_route(cfg: LMConfig, router, xt) -> Routing:
    """Top-k routing with per-group capacity for xt [t, d].

    The top k are taken with the lower expert index first on equal
    probabilities (``jax.lax.top_k``'s rule), by a stable descending sort
    (``torch.topk`` promises no order among ties)."""
    mo = cfg.moe
    t = xt.shape[0]
    k, e = mo.top_k, mo.n_experts
    gcount = max(1, min(cfg.moe_groups, t))
    while t % gcount:
        gcount -= 1
    tg = t // gcount
    logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, top = vals[:, :k], idx[:, :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    cap = int(max(1, math.ceil(tg * k / e * mo.capacity_factor)))
    rank = _moe_rank_in_expert(top.reshape(gcount, tg * k), e)
    return Routing(probs, gate, top, rank, rank < cap, cap)


def moe_ffn(cfg: LMConfig, p, x):
    """Capacity-based top-k MoE with grouped-local sort dispatch.

    Tokens bucket into per-group expert queues of ``cap`` rows (a dropped
    assignment goes to the sentinel row e·cap, which is cut off); every
    expert runs on its [G·cap, d] rows; each token sums its kept
    assignments' outputs × gate.  Returns (y, the Switch aux loss)."""
    dt = _dt(cfg)
    mo = cfg.moe
    b, s, d = x.shape
    t = b * s
    k, e = mo.top_k, mo.n_experts
    xt = x.reshape(t, d)
    r = moe_route(cfg, p["router"], xt)
    cap = r.cap
    gcount = r.rank.shape[0]
    tg = t // gcount
    top_g = r.top.reshape(gcount, tg * k)                # group-major
    dest = torch.where(r.keep, top_g * cap + r.rank, e * cap)
    token_id = torch.arange(tg, device=x.device).repeat_interleave(k)
    xg = xt.reshape(gcount, tg, d)

    # local scatter into each group's expert queues (kept rows are unique;
    # the sentinel row collects the dropped ones)
    buf = torch.zeros((gcount, e * cap + 1, d), dtype=dt, device=x.device)
    groups = torch.arange(gcount, device=x.device)[:, None].expand_as(dest)
    buf.index_put_((groups, dest), xg[:, token_id].to(dt), accumulate=True)
    xb = buf[:, :e * cap].reshape(gcount, e, cap, d)
    xe = xb.transpose(0, 1).reshape(e, gcount * cap, d)
    g = torch.einsum("ecd,edf->ecf", xe, p["wg"].to(dt))
    u = torch.einsum("ecd,edf->ecf", xe, p["wu"].to(dt))
    h = F.silu(g) * u
    ye = torch.einsum("ecf,efd->ecd", h, p["wd"].to(dt))

    yb = ye.reshape(e, gcount, cap, d).transpose(0, 1).reshape(
        gcount, e * cap, d)
    rows = torch.cat([yb, yb.new_zeros((gcount, 1, d))], dim=1)
    weight = (r.gate.reshape(gcount, tg * k).to(dt) * r.keep.to(dt))
    contrib = torch.gather(rows, 1, dest[..., None].expand(-1, -1, d)) \
        * weight[..., None]
    y = contrib.reshape(gcount, tg, k, d).sum(dim=2).reshape(t, d)

    if mo.n_shared:
        y = y + swiglu(p["shared"], x, dt).reshape(t, d)
    # load-balance aux loss (Switch): E · Σ_e f_e · P_e
    me = r.probs.mean(0)
    counts = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, r.top.reshape(-1), torch.ones(t * k, device=x.device))
    ce = counts / float(t)
    aux = e * torch.sum(me * ce) * mo.router_aux_weight
    return y.reshape(b, s, d), aux
