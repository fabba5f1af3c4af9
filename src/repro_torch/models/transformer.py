"""LM transformer: training forward, loss value, prefill and KV-cache decode.

The port of ``repro.models.transformer``, as an ``nn.Module``.  Supports:

  * GQA attention (llama3 / qwen2 / yi) with optional QKV bias,
  * MLA latent attention (deepseek-v3) with compressed-KV decode cache,
  * SwiGLU dense FFN and capacity-based top-k MoE (+ shared experts),
  * llama4 iRoPE chunked local attention (3 of 4 layers local),
  * optional depth-1 MTP head (deepseek-v3 multi-token prediction).

Layers run in a plain Python loop, one ``Params`` set per layer (the
reference stacks ``[L, …]`` leaves under ``lax.scan``; its scan groups
only shape XLA's HLO).  Each layer holds only the FFN set it runs: the
reference gives every layer of an MoE config both a dense and an MoE set
to keep its scan leaves uniform, and ``load_reference_params`` drops the
unused one.  Parameters are created with ``requires_grad=False``, so
serving builds no autograd graph; ``trainable()`` turns on the
floating-point leaves for a training step.  With ``cfg.remat == "full"``
a forward that takes gradients recomputes each layer in the backward
(``torch.utils.checkpoint``, non-reentrant), where the reference applies
``jax.checkpoint`` to its layer scan.

``init_params(cfg, generator, device=None)`` draws the reference's
distributions from a ``torch.Generator``; ``device=None`` is the CUDA
card (``RuntimeError`` without one), ``"cpu"`` runs on the CPU and
``"meta"`` makes shapes only.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from repro_torch.graph.structure import resolve_device
from repro_torch.models import layers as Lyr
from repro_torch.models.layers import LMConfig
from repro_torch.tree import tree_map


class Params(nn.Module):
    """A named parameter set, indexed like the reference's dicts
    (``p["wq"]``, ``"bq" in p``); a nested dict becomes a nested set, a
    list of dicts a ``ModuleList`` of sets."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                self.add_module(name, Params(leaf))
            elif isinstance(leaf, list):
                self.add_module(name, nn.ModuleList(Params(x) for x in leaf))
            else:
                self.register_parameter(
                    name, nn.Parameter(leaf, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def trainable(self, on: bool = True):
        """Every floating-point parameter set to take gradients (or, with
        ``on=False``, not); returns the module."""
        return _trainable(self, on)


def _trainable(module: nn.Module, on: bool):
    for p in module.parameters():
        if p.dtype.is_floating_point:
            p.requires_grad_(on)
    return module


def _tree_of(p, live: bool = False):
    """A module's parameters as nested dicts (and lists for a
    ``ModuleList``): detached tensors sharing their storage, or with
    ``live`` the parameters themselves (gradients flow through them)."""
    if isinstance(p, nn.ModuleList):
        return [_tree_of(c, live) for c in p]
    out = {name: t if live else t.detach()
           for name, t in p._parameters.items()}
    out.update({name: _tree_of(m, live) for name, m in p._modules.items()})
    return out


# Fields that change how the same weights run, not their shapes
# (``TransformerLM.with_config``).
_RUN_FIELDS = frozenset({"mla_decode", "attn_impl", "kv_chunk", "loop_impl",
                         "remat", "hint_axes", "moe_groups", "kv_quant"})


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def _layer_init(cfg: LMConfig, use_moe: bool, gen, device):
    pdt = Lyr._pdt(cfg)
    p = {"ln1": Lyr._norm_init((cfg.d_model,), pdt, device),
         "ln2": Lyr._norm_init((cfg.d_model,), pdt, device)}
    if cfg.mla is not None:
        p["attn"] = Lyr.init_mla(cfg, gen, device)
    else:
        p["attn"] = Lyr.init_attention(cfg, gen, device)
    if use_moe:
        p["moe"] = Lyr.init_moe(cfg, gen, device)
    else:
        p["ffn"] = Lyr.init_swiglu(cfg.d_model, cfg.d_ff, gen, pdt, device)
    return p


def init_params(cfg: LMConfig, generator: Optional[torch.Generator],
                device=None) -> "TransformerLM":
    """A model of ``cfg`` with the reference's distributions (normal ×
    1/√fan_in, the embedding × 0.02, norms ones, biases zeros), drawn
    from ``generator`` (on ``device``; ignored on ``meta``)."""
    dev = resolve_device(device)
    pdt = Lyr._pdt(cfg)
    gen = None if dev.type == "meta" else generator
    tree = {
        "embed": Lyr._dense_init(gen, (cfg.vocab, cfg.d_model), pdt, dev,
                                 scale=0.02),
        "layers": [_layer_init(cfg, _layer_pattern(cfg, li)[0], gen, dev)
                   for li in range(cfg.n_layers)],
        "ln_f": Lyr._norm_init((cfg.d_model,), pdt, dev),
        "unembed": Lyr._dense_init(gen, (cfg.d_model, cfg.vocab), pdt, dev),
    }
    if cfg.mtp:
        tree["mtp"] = {"proj": Lyr._dense_init(gen, (2 * cfg.d_model,
                                                     cfg.d_model), pdt, dev),
                       "layer": _layer_init(cfg, False, gen, dev)}
    return TransformerLM(cfg, tree)


def _from_numpy(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    if not a.flags.writeable:                # a view of a JAX array
        a = a.copy()
    return torch.from_numpy(a).to(device)


def _one_ffn(layer: dict, use_moe: bool) -> dict:
    """The layer's leaves without the FFN set it does not run."""
    return {k: v for k, v in layer.items()
            if k != ("ffn" if use_moe else "moe")}


def load_reference_params(cfg: LMConfig, tree: dict,
                          device=None) -> "TransformerLM":
    """A model holding the reference's ``init_params`` tree (numpy leaves,
    ``jax.tree.map(np.asarray, params)``): the ``[L, …]`` layer leaves
    unstacked into one set per layer, each layer and the MTP layer
    without the FFN set it does not run."""
    dev = resolve_device(device)

    def t(a):
        return _from_numpy(a, dev)

    layers = [tree_map(lambda a, li=li: t(a[li]),
                       _one_ffn(tree["layers"], _layer_pattern(cfg, li)[0]))
              for li in range(cfg.n_layers)]
    out = {"embed": t(tree["embed"]), "layers": layers,
           "ln_f": t(tree["ln_f"]), "unembed": t(tree["unembed"])}
    if cfg.mtp:
        out["mtp"] = {"proj": t(tree["mtp"]["proj"]),
                      "layer": tree_map(t, _one_ffn(tree["mtp"]["layer"],
                                                    False))}
    return TransformerLM(cfg, out)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _is_global_layer(cfg: LMConfig, li: int) -> bool:
    return cfg.attn_chunk is None or (li % cfg.chunk_global_every ==
                                      cfg.chunk_global_every - 1)


def _layer_pattern(cfg: LMConfig, li: int):
    use_moe = cfg.moe is not None and cfg.moe.is_moe_layer(li)
    return (use_moe, _is_global_layer(cfg, li))


def _layer_apply(cfg: LMConfig, p, x, positions, chunk, use_moe: bool,
                 cache=None, offset: Optional[int] = None):
    dt = Lyr._dt(cfg)
    h = Lyr.rms_norm(x, p["ln1"].to(dt), cfg.norm_eps)
    attend = Lyr.mla_attention if cfg.mla is not None else Lyr.gqa_attention
    a, new_cache = attend(cfg, p["attn"], h, positions, chunk, cache, offset)
    x = x + a
    h = Lyr.rms_norm(x, p["ln2"].to(dt), cfg.norm_eps)
    if use_moe:
        f, aux = Lyr.moe_ffn(cfg, p["moe"], h)
    else:
        f = Lyr.swiglu(p["ffn"], h, dt)
        aux = x.new_zeros((), dtype=torch.float32)
    return x + f, aux, new_cache


def _positions(b: int, s: int, start: int, device) -> torch.Tensor:
    return torch.arange(start, start + s, device=device)[None, :].expand(b, s)


class TransformerLM(nn.Module):
    """The LM of ``cfg`` over a parameter tree: ``embed``, ``layers`` (one
    dict per layer), ``ln_f``, ``unembed`` and, with ``cfg.mtp``,
    ``mtp`` = {``proj``, ``layer``}; every leaf a tensor on one device."""

    def __init__(self, cfg: LMConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        for name in ("embed", "ln_f", "unembed"):
            self.register_parameter(
                name, nn.Parameter(tree[name], requires_grad=False))
        self.layers = nn.ModuleList(Params(lp) for lp in tree["layers"])
        if len(self.layers) != cfg.n_layers:
            raise ValueError(f"{len(self.layers)} layers for a config of "
                             f"{cfg.n_layers}")
        if cfg.mtp:
            self.mtp = Params(tree["mtp"])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def tree(self, live: bool = False) -> dict:
        """The parameter tree (``embed``, ``layers``, ``ln_f``,
        ``unembed``, ``mtp``) as ``TransformerLM(cfg, tree)`` takes it:
        detached tensors sharing the parameters' storage, or with
        ``live`` the parameters themselves."""
        return _tree_of(self, live)

    def trainable(self, on: bool = True) -> "TransformerLM":
        """Every floating-point parameter set to take gradients (or not);
        returns the model."""
        return _trainable(self, on)

    def with_config(self, **changes) -> "TransformerLM":
        """The same weights run under ``cfg`` with ``changes`` (fields of
        how they run: attention mode, MLA decode, KV tile, …)."""
        bad = set(changes) - _RUN_FIELDS
        if bad:
            raise ValueError(f"fields {sorted(bad)} change the weights' "
                             f"shapes; only {sorted(_RUN_FIELDS)} may change")
        other = copy.copy(self)
        other.cfg = dataclasses.replace(self.cfg, **changes)
        return other

    def cast(self, dtype: str) -> "TransformerLM":
        """The same weights held and computed in ``dtype`` (a new model; a
        leaf already of ``dtype`` is shared, not copied; the MoE routers
        stay float32, as ``init_moe`` makes them)."""
        dt = getattr(torch, dtype)
        tree = {}
        for name, p in self.named_parameters():
            *path, leaf = name.split(".")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = p.detach() if leaf == "router" else p.detach().to(dt)
        tree["layers"] = [tree["layers"][str(li)]
                          for li in range(self.cfg.n_layers)]
        return TransformerLM(dataclasses.replace(
            self.cfg, dtype=dtype, param_dtype=dtype), tree)

    def _run_layers(self, x, positions, cache=None,
                    offset: Optional[int] = None):
        cfg = self.cfg
        remat = cache is None and cfg.remat == "full" \
            and torch.is_grad_enabled()
        aux = x.new_zeros((), dtype=torch.float32)
        for li, lp in enumerate(self.layers):
            use_moe, glob = _layer_pattern(cfg, li)
            chunk = None if glob else cfg.attn_chunk
            if remat:
                # the layer's activations are recomputed in the backward;
                # only its input is held
                x, a, _ = torch.utils.checkpoint.checkpoint(
                    _layer_apply, cfg, lp, x, positions, chunk, use_moe,
                    use_reentrant=False, preserve_rng_state=False)
            else:
                c = None if cache is None else {k: v[li]
                                                for k, v in cache.items()}
                x, a, _ = _layer_apply(cfg, lp, x, positions, chunk,
                                       use_moe, c, offset)
            aux = aux + a
        return x, aux

    def forward(self, tokens):
        """tokens [B, S] → (logits [B, S, V], aux loss, final hidden)."""
        cfg = self.cfg
        dt = Lyr._dt(cfg)
        b, s = tokens.shape
        x = self.embed[tokens].to(dt)
        x, aux = self._run_layers(x, _positions(b, s, 0, tokens.device))
        x = Lyr.rms_norm(x, self.ln_f.to(dt), cfg.norm_eps)
        logits = torch.einsum("bsd,dv->bsv", x, self.unembed.to(dt))
        return logits, aux, x

    def loss_fn(self, batch):
        """Next-token cross entropy (+ MoE aux + optional MTP loss),
        differentiable.  A negative target is masked out; token ids may be
        int32 or int64."""
        cfg = self.cfg
        tokens, targets = batch["tokens"].long(), batch["targets"].long()
        logits, aux, x_final = self(tokens)
        loss = _masked_nll(F.log_softmax(Lyr._wide(logits), dim=-1),
                           targets)
        if cfg.mtp:
            # depth-1 MTP: predict token t+2 from [h_t ; emb(token t+1)]
            dt = Lyr._dt(cfg)
            emb_next = self.embed[tokens[:, 1:]].to(dt)
            h = torch.cat([x_final[:, :-1], emb_next], dim=-1)
            h = torch.einsum("bsd,dk->bsk", h, self.mtp["proj"].to(dt))
            b, s1 = tokens.shape[0], tokens.shape[1] - 1
            h, _, _ = _layer_apply(cfg, self.mtp["layer"], h,
                                   _positions(b, s1, 0, tokens.device),
                                   None, use_moe=False)
            mtp_logits = torch.einsum(
                "bsd,dv->bsv",
                Lyr.rms_norm(h, self.ln_f.to(dt), cfg.norm_eps),
                self.unembed.to(dt))
            mtp_logp = F.log_softmax(Lyr._wide(mtp_logits[:, :-1]), dim=-1)
            # the token t+2 stream, targets[:, 1:][:, 1:] (the reference
            # overwrites its first choice of mtp_tgt with this one)
            mtp_tgt = targets[:, 2:]
            loss = loss + 0.1 * _masked_nll(
                mtp_logp[:, :mtp_tgt.shape[1]], mtp_tgt)
        return loss + aux

    # -----------------------------------------------------------------------
    # Serving: prefill + single-token decode with a KV cache.
    # -----------------------------------------------------------------------

    def init_cache(self, batch: int, max_seq: int, dtype=None) -> dict:
        """Zeroed ``[L, B, max_seq, …]`` cache tensors on the model's
        device (the reference's layout)."""
        cfg = self.cfg
        dtype = dtype or Lyr._dt(cfg)
        l, dev = cfg.n_layers, self.device
        if cfg.mla is not None:
            m = cfg.mla
            return {"c_kv": torch.zeros((l, batch, max_seq, m.kv_lora_rank),
                                        dtype=dtype, device=dev),
                    "k_r": torch.zeros((l, batch, max_seq,
                                        m.qk_rope_head_dim), dtype=dtype,
                                       device=dev)}
        shape = (l, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        if cfg.kv_quant:
            return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "k_s": torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev),
                    "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "v_s": torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev)}
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}

    def prefill(self, tokens, cache: dict):
        """Full-sequence prefill writing the cache at positions 0…S−1 (in
        place); returns (logits of the last position [B, V], cache)."""
        cfg = self.cfg
        dt = Lyr._dt(cfg)
        b, s = tokens.shape
        x = self.embed[tokens].to(dt)
        # cache slots beyond s stay masked: kpos > q_pos
        x, _ = self._run_layers(x, _positions(b, s, 0, tokens.device),
                                cache, offset=0)
        x = Lyr.rms_norm(x, self.ln_f.to(dt), cfg.norm_eps)
        logits = torch.einsum("bd,dv->bv", x[:, -1], self.unembed.to(dt))
        return logits, cache

    def decode_step(self, token, pos: int, cache: dict):
        """One decode step: token [B] at position ``pos`` (the current
        length), written into the cache in place.

        Returns (logits [B, V], cache)."""
        cfg = self.cfg
        dt = Lyr._dt(cfg)
        b = token.shape[0]
        x = self.embed[token].to(dt)[:, None, :]
        x, _ = self._run_layers(x, _positions(b, 1, pos, token.device),
                                cache, offset=pos)
        x = Lyr.rms_norm(x, self.ln_f.to(dt), cfg.norm_eps)
        logits = torch.einsum("bd,dv->bv", x[:, 0], self.unembed.to(dt))
        return logits, cache


def _masked_nll(logp, targets):
    """Mean −log p(target) over the targets ≥ 0."""
    nll = -torch.gather(logp, -1, targets.clamp(min=0)[..., None])[..., 0]
    mask = (targets >= 0).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
