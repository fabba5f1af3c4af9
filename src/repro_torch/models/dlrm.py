"""DLRM RM2 (arXiv:1906.00091): sparse embedding tables → dot-product
feature interaction → MLPs.

The port of ``repro.models.dlrm``.  Tables are stacked [n_sparse, vocab,
dim] in ``cfg.dtype``; the MLPs stay float32.  The lookup is one
advanced-index gather ``tables[field, row]`` for single-hot fields and
that gather summed over the K slots for multi-hot ones, as the reference's
vmapped ``t[i]`` / ``t[i].sum(axis=1)`` are (its module docstring names the
Pallas ``embedding_bag`` kernel for the multi-hot path, but its code
gathers, and the port follows the code: no kernel launches here).  Row ids
follow JAX's ``t[i]`` rule (``kernels.embedding_bag._wrap_indices``): a
negative id wraps once, then every id is clamped into the table.  The
interaction is a batched ``z zᵀ`` (``torch.bmm``) whose strict lower
triangle is taken in row-major order, the order of ``jnp.tril_indices``.

``DLRM`` is an ``nn.Module`` over the reference's parameter tree
(``{"tables", "bot", "top"}``), made by ``dlrm_init(cfg, generator,
device=None)`` from the reference's distributions or by
``load_reference_params(cfg, tree, device=None)`` from the reference's own
initialised tree; ``device=None`` is the CUDA card (``RuntimeError``
without one), ``"cpu"`` runs on the CPU.  ``dlrm_forward`` / ``dlrm_loss``
/ ``dlrm_user_vector`` / ``dlrm_retrieval_scores`` take the model where
the reference takes its params.  Parameters are made with
``requires_grad=False``; ``trainable()`` turns them on for a training
step.  The tables' gradient is dense, as the reference's is: the
gather's backward sums each looked-up row's cotangents into a zero
[n_sparse, vocab, dim] tensor, and AdamW then updates every row.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.graph.structure import resolve_device
from repro_torch.kernels.embedding_bag import _wrap_indices
from repro_torch.models.gnn import _init_mlp, _mlp
from repro_torch.models.transformer import Params, _from_numpy, _tree_of
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    vocab: int = 1_000_000          # rows per table
    bot_mlp: Sequence[int] = (13, 512, 256, 64)
    top_mlp_hidden: Sequence[int] = (512, 512, 256, 1)
    multi_hot: int = 1              # K slots per field (1 = single-hot)
    dtype: str = "float32"          # the tables' dtype

    @property
    def n_feats(self) -> int:
        return self.n_sparse + 1    # embeddings + bottom-MLP output

    @property
    def d_interact(self) -> int:
        f = self.n_feats
        return f * (f - 1) // 2 + self.embed_dim

    def param_count(self) -> int:
        emb = self.n_sparse * self.vocab * self.embed_dim
        bot = sum(a * b for a, b in zip(self.bot_mlp[:-1], self.bot_mlp[1:]))
        dims = [self.d_interact] + list(self.top_mlp_hidden)
        top = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        return emb + bot + top


def dlrm_init(cfg: DLRMConfig, generator: Optional[torch.Generator],
              device=None) -> "DLRM":
    """A model of ``cfg`` with the reference's distributions: tables
    N(0, 1)/√embed_dim drawn in float32 and cast to ``cfg.dtype``, MLPs
    normal × 1/√fan_in with zero biases, drawn from ``generator`` (on
    ``device``) in that order.  The tables are drawn one at a time into
    the stacked tensor on ``device`` (26.6 GB at RM2's full size) and
    scaled in place, so no second copy of them is ever held."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    shape = (cfg.vocab, cfg.embed_dim)
    tables = torch.empty((cfg.n_sparse,) + shape, dtype=dt, device=dev)
    scale = math.sqrt(cfg.embed_dim)
    for f in range(cfg.n_sparse):
        if dt == torch.float32:
            tables[f].normal_(generator=generator).div_(scale)
        else:
            tables[f].copy_(torch.empty(shape, device=dev).normal_(
                generator=generator).div_(scale))
    top_dims = [cfg.d_interact] + list(cfg.top_mlp_hidden)
    return DLRM(cfg, {"tables": tables,
                      "bot": _init_mlp(generator, list(cfg.bot_mlp), dev),
                      "top": _init_mlp(generator, top_dims, dev)})


def _lookup(cfg: DLRMConfig, tables, sparse_idx):
    """sparse_idx [B, n_sparse] (single-hot) or [B, n_sparse, K]
    (multi-hot) → [B, n_sparse, D] in the tables' dtype: one gather over
    every table, summed over K for multi-hot fields."""
    f, v = tables.shape[:2]
    rows = _wrap_indices(sparse_idx, v)
    fields = torch.arange(f, device=tables.device)
    if rows.ndim == 2:
        return tables[fields, rows]
    return tables[fields[:, None], rows].sum(dim=2)


def _interact(cfg: DLRMConfig, bot_out, emb):
    """Dot interaction: pairwise dots of the 27 feature vectors (lower
    triangle, no diagonal) concatenated with the bottom-MLP output."""
    z = torch.cat([bot_out[:, None, :], emb], dim=1)         # [B, F, D]
    zz = torch.bmm(z, z.transpose(1, 2))                      # [B, F, F]
    f = z.shape[1]
    iu, ju = torch.tril_indices(f, f, offset=-1, device=z.device)
    dots = zz[:, iu, ju]                                      # [B, F(F-1)/2]
    return torch.cat([bot_out, dots], dim=-1)


def _bottom(params, dense):
    """The bottom MLP, ReLU after its last layer; ``dense`` is taken in the
    MLP's dtype (float32 features into float64 weights promote, as JAX's
    do)."""
    return _mlp(params["bot"], dense.to(params["bot"][0]["w"].dtype),
                final_act=True)


def dlrm_forward(cfg: DLRMConfig, params, dense, sparse_idx):
    """dense [B, 13] float; sparse_idx [B, 26] int32 → logits [B]."""
    bot = _bottom(params, dense)
    emb = _lookup(cfg, params["tables"], sparse_idx).to(bot.dtype)
    x = _interact(cfg, bot, emb)
    out = _mlp(params["top"], x)
    return out[:, 0]


def dlrm_loss(cfg: DLRMConfig, params, batch):
    """Binary cross-entropy with logits, the stable form, averaged."""
    logits = dlrm_forward(cfg, params, batch["dense"], batch["sparse"])
    y = batch["label"].to(torch.float32)
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-logits.abs())))


def dlrm_user_vector(cfg: DLRMConfig, params, dense, sparse_idx):
    """Retrieval tower: the interaction-layer input reduced to embed_dim —
    used to score candidate item embeddings with one batched dot."""
    bot = _bottom(params, dense)
    emb = _lookup(cfg, params["tables"], sparse_idx).to(bot.dtype)
    return bot + emb.mean(dim=1)                              # [B, D]


def dlrm_retrieval_scores(cfg: DLRMConfig, params, dense, sparse_idx,
                          cand_emb):
    """Score 1 query (or B queries) against n_candidates item embeddings:
    a single [B, D] × [N, D]ᵀ product."""
    u = dlrm_user_vector(cfg, params, dense, sparse_idx)      # [B, D]
    return u @ cand_emb.T                                     # [B, N]


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

class DLRM(Params):
    """DLRM of ``cfg`` over the reference's parameter tree (``"tables"``
    [n_sparse, vocab, dim], ``"bot"`` and ``"top"`` lists of ``{"w",
    "b"}``, every leaf on one device), indexed as the tree is:
    ``model["bot"][0]["w"]``.  ``model(dense, sparse)`` is
    ``dlrm_forward``, ``model.loss(batch)`` ``dlrm_loss``."""

    def __init__(self, cfg: DLRMConfig, tree: dict):
        if not isinstance(cfg, DLRMConfig):
            raise TypeError(f"no DLRM for a {type(cfg).__name__}")
        super().__init__(tree)
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self["tables"].device

    def forward(self, dense, sparse_idx):
        return dlrm_forward(self.cfg, self, dense, sparse_idx)

    def loss(self, batch):
        return dlrm_loss(self.cfg, self, batch)

    def user_vector(self, dense, sparse_idx):
        return dlrm_user_vector(self.cfg, self, dense, sparse_idx)

    def retrieval_scores(self, dense, sparse_idx, cand_emb):
        return dlrm_retrieval_scores(self.cfg, self, dense, sparse_idx,
                                     cand_emb)

    def tree(self, live: bool = False) -> dict:
        """The parameter tree as nested dicts and lists of tensors
        (detached, sharing the parameters' storage; with ``live`` the
        parameters themselves)."""
        return _tree_of(self, live)

    def to_device(self, device) -> "DLRM":
        """The same weights copied to ``device`` (a new model)."""
        dev = resolve_device(device)
        return DLRM(self.cfg, tree_map(lambda t: t.to(dev), self.tree()))

    def cast(self, dtype: str, tables: bool = True) -> "DLRM":
        """The same weights held in ``dtype`` (a new model): every leaf, or
        with ``tables=False`` the MLPs alone over the same tables (shared,
        not copied).  Float64 MLPs over the float32 tables compute the
        float32 forward's function in float64, since the gather is exact,
        without a float64 copy of the tables (53 GB at RM2's full size)."""
        dt = getattr(torch, dtype)
        tree = self.tree()
        out = {k: tree_map(lambda t: t.to(dt), v) for k, v in tree.items()
               if k != "tables"}
        out["tables"] = tree["tables"].to(dt) if tables else tree["tables"]
        cfg = dataclasses.replace(self.cfg, dtype=dtype) if tables \
            else self.cfg
        return DLRM(cfg, out)


def load_reference_params(cfg: DLRMConfig, tree: dict, device=None) -> DLRM:
    """A model holding the reference's ``dlrm_init(cfg, key)`` tree with
    numpy leaves (``jax.tree.map(np.asarray, params)``)."""
    dev = resolve_device(device)
    return DLRM(cfg, tree_map(lambda a: _from_numpy(np.asarray(a), dev),
                              tree))
