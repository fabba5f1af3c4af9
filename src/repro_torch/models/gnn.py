"""GNN architectures: GAT, EGNN, MeshGraphNet, DimeNet.

The port of ``repro.models.gnn``.  Message passing is edge-index gathers
(``index_select``) and destination sums (``segment.segment_sum``: a stable
sort where the ids are not already sorted, then ``torch.segment_reduce``
along the rows, one fixed order run to run, never float atomics), as the
reference's is gathers and ``jax.ops.segment_*`` scatters.  No model
launches a kernel of the port: the reference's GNNs call no Pallas kernel.
The three regimes:

  SpMM/SDDMM        GAT (edge scores → segment softmax → weighted aggregate)
  plain scatter     EGNN / MeshGraphNet (MLP messages → segment_sum)
  triplet gather    DimeNet (angular basis over (k→j→i) wedge lists)

Every model is a ``GNN`` (an ``nn.Module`` over the reference's parameter
tree, indexed as its dicts and lists are), made by ``*_init(cfg,
generator, device=None)`` from the reference's distributions or by
``load_reference_params(cfg, tree, device=None)`` from the reference's own
initialised tree; ``device=None`` is the CUDA card (``RuntimeError``
without one), ``"cpu"`` runs on the CPU.  ``*_forward`` / ``*_loss`` take
the model where the reference takes its params, with the reference's
arguments.  Parameters are made with ``requires_grad=False``;
``trainable()`` turns them on for a training step, and every forward
and loss, the vertex-cut ones included, is differentiable.

The vertex-cut forwards (``mgn_forward_dist``, ``egnn_forward_dist`` and
their losses) take the k per-shard inputs and a ``ShardMesh`` where the
reference runs one shard's function under ``shard_map`` with ``axes``: one
process drives the k shards, each layer all-gathers the node state as the
shards' rows in shard order, and the loss sums fold with
``segment.psum_like`` in shard order.  ``mesh=None`` is one shard, the
reference's ``axes=()``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.graph import segment
from repro_torch.graph.partition import check_mesh
from repro_torch.graph.structure import resolve_device
from repro_torch.models.transformer import Params, _from_numpy, _tree_of
from repro_torch.tree import tree_map


def _normal(gen, shape, device, scale: float) -> torch.Tensor:
    """normal × scale in float32, drawn from ``gen`` (on ``device``)."""
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) * scale


def _gather(x, idx):
    """Rows ``x[idx]`` (``idx`` int32 or int64)."""
    return x.index_select(0, idx)


# ---------------------------------------------------------------------------
# Shared MLP helper
# ---------------------------------------------------------------------------

def _init_mlp(gen, dims: Sequence[int], device, dtype=torch.float32):
    return [{"w": _normal(gen, (a, b), device, 1.0 / math.sqrt(a)).to(dtype),
             "b": torch.zeros((b,), dtype=dtype, device=device)}
            for a, b in zip(dims[:-1], dims[1:])]


def _mlp(params, x, act=F.relu, final_act=False):
    for i, lyr in enumerate(params):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(params) - 1 or final_act:
            x = act(x)
    return x


# ---------------------------------------------------------------------------
# GAT (arXiv:1710.10903) — n_layers=2, d_hidden=8, n_heads=8 on cora.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat-cora"
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    d_in: int = 1433
    n_classes: int = 7
    dtype: str = "float32"


def gat_init(cfg: GATConfig, generator: Optional[torch.Generator],
             device=None) -> "GNN":
    dev = resolve_device(device)
    layers = []
    d_in = cfg.d_in
    for li in range(cfg.n_layers):
        last = li == cfg.n_layers - 1
        h = cfg.n_heads if not last else 1
        d_out = cfg.d_hidden if not last else cfg.n_classes
        layers.append({
            "w": _normal(generator, (d_in, h, d_out), dev,
                         1.0 / math.sqrt(d_in)),
            "a_src": _normal(generator, (h, d_out), dev, 0.1),
            "a_dst": _normal(generator, (h, d_out), dev, 0.1),
        })
        d_in = h * d_out if not last else d_out
    return GNN(cfg, {"layers": layers})


def gat_attention(p, h, src, dst, n: int):
    """One layer's edge logits ``leaky_relu(es + ed, 0.2)`` [e, H] over
    its projected nodes ``h`` [n, H, K], and their per-destination softmax
    α, each head's column on its own."""
    es = _gather((h * p["a_src"]).sum(-1), src)
    ed = _gather((h * p["a_dst"]).sum(-1), dst)
    logits = F.leaky_relu(es + ed, 0.2)                   # [e, H]
    return logits, segment.segment_softmax(logits, dst, n)


def gat_forward(cfg: GATConfig, params, x, src, dst, n: int):
    """x [n, d_in]; edge lists src/dst [e] (messages flow src→dst)."""
    layers = params["layers"]
    for li, p in enumerate(layers):
        last = li == len(layers) - 1
        w = p["w"]
        h = (x @ w.reshape(w.shape[0], -1)).view(n, *w.shape[1:])
        alpha = gat_attention(p, h, src, dst, n)[1]
        msg = _gather(h, src) * alpha[..., None]          # [e, H, K]
        agg = segment.segment_sum(msg, dst, n)            # [n, H, K]
        del msg
        x = agg.reshape(n, -1) if not last else agg.mean(dim=1)
        if not last:
            x = F.elu(x)
    return x                                              # [n, n_classes]


def gat_loss(cfg: GATConfig, params, batch):
    logits = gat_forward(cfg, params, batch["x"], batch["src"],
                         batch["dst"], batch["x"].shape[0])
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, batch["y"].long()[:, None])[:, 0]
    mask = batch.get("mask", torch.ones_like(nll))
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


# ---------------------------------------------------------------------------
# EGNN (arXiv:2102.09844) — n_layers=4, d_hidden=64, E(n)-equivariant.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_in: int = 16
    d_out: int = 1
    dtype: str = "float32"


def egnn_init(cfg: EGNNConfig, generator: Optional[torch.Generator],
              device=None) -> "GNN":
    dev = resolve_device(device)
    d = cfg.d_hidden
    layers = [{"phi_e": _init_mlp(generator, [2 * d + 1, d, d], dev),
               "phi_x": _init_mlp(generator, [d, d, 1], dev),
               "phi_h": _init_mlp(generator, [2 * d, d, d], dev)}
              for _ in range(cfg.n_layers)]
    return GNN(cfg, {"embed": _init_mlp(generator, [cfg.d_in, d], dev),
                     "layers": layers,
                     "head": _init_mlp(generator, [d, d, cfg.d_out], dev)})


def egnn_forward(cfg: EGNNConfig, params, feats, coords, src, dst, n: int):
    """feats [n, d_in], coords [n, 3] → (invariant per-node out, coords')."""
    h = _mlp(params["embed"], feats)
    x = coords
    deg = segment.segment_sum(
        torch.ones((src.shape[0], 1), dtype=h.dtype, device=h.device), dst, n)
    for p in params["layers"]:
        diff = _gather(x, src) - _gather(x, dst)          # [e, 3]
        d2 = torch.sum(diff * diff, dim=-1, keepdim=True)
        m = _mlp(p["phi_e"], torch.cat(
            [_gather(h, src), _gather(h, dst), d2], dim=-1), final_act=True)
        # coordinate update (equivariant): x_i += mean_j (x_i-x_j)·φ_x(m_ij)
        w = _mlp(p["phi_x"], m)                           # [e, 1]
        upd = segment.segment_sum(-diff * w, dst, n)
        x = x + upd / torch.clamp(deg, min=1.0)
        # invariant update
        agg = segment.segment_sum(m, dst, n)
        h = h + _mlp(p["phi_h"], torch.cat([h, agg], dim=-1))
    out = _mlp(params["head"], h)
    return out, x


def egnn_loss(cfg: EGNNConfig, params, batch):
    out, x = egnn_forward(cfg, params, batch["feats"], batch["coords"],
                          batch["src"], batch["dst"],
                          batch["feats"].shape[0])
    # per-graph energy regression (segment-sum over graph ids); the graph
    # count is the target's length
    ng = batch["target"].shape[0]
    energy = segment.segment_sum(out[:, 0], batch["graph_id"], ng)
    return torch.mean((energy - batch["target"]) ** 2)


# ---------------------------------------------------------------------------
# MeshGraphNet (arXiv:2010.03409) — 15 layers, d=128, sum agg, 2-layer MLPs.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MGNConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_node_in: int = 8
    d_edge_in: int = 4
    d_out: int = 2
    dtype: str = "float32"


def _mgn_mlp_dims(cfg: MGNConfig, d_in: int):
    return [d_in] + [cfg.d_hidden] * cfg.mlp_layers


def mgn_init(cfg: MGNConfig, generator: Optional[torch.Generator],
             device=None) -> "GNN":
    dev = resolve_device(device)
    d = cfg.d_hidden
    layers = [{"edge_mlp": _init_mlp(generator, _mgn_mlp_dims(cfg, 3 * d),
                                     dev),
               "node_mlp": _init_mlp(generator, _mgn_mlp_dims(cfg, 2 * d),
                                     dev)}
              for _ in range(cfg.n_layers)]
    return GNN(cfg, {
        "node_enc": _init_mlp(generator, _mgn_mlp_dims(cfg, cfg.d_node_in),
                              dev),
        "edge_enc": _init_mlp(generator, _mgn_mlp_dims(cfg, cfg.d_edge_in),
                              dev),
        "layers": layers,
        "decoder": _init_mlp(generator, [d, d, cfg.d_out], dev)})


def mgn_forward(cfg: MGNConfig, params, node_x, edge_x, src, dst, n: int):
    h = _mlp(params["node_enc"], node_x, final_act=True)
    e = _mlp(params["edge_enc"], edge_x, final_act=True)
    for p in params["layers"]:
        e = e + _mlp(p["edge_mlp"], torch.cat(
            [e, _gather(h, src), _gather(h, dst)], dim=-1))
        agg = segment.segment_sum(e, dst, n)              # sum aggregator
        h = h + _mlp(p["node_mlp"], torch.cat([h, agg], dim=-1))
    return _mlp(params["decoder"], h)


def mgn_loss(cfg: MGNConfig, params, batch):
    out = mgn_forward(cfg, params, batch["node_x"], batch["edge_x"],
                      batch["src"], batch["dst"], batch["node_x"].shape[0])
    return torch.mean((out - batch["target"]) ** 2)


# ---------------------------------------------------------------------------
# Vertex-cut MeshGraphNet and EGNN over k shards (dst-block partition:
# nodes row-sharded, every edge on its dst's shard, so every scatter is
# local; the only cross-shard steps are one all-gather of the node state
# per layer, for the h[src] gather, and the loss's sums).
# ---------------------------------------------------------------------------

def _shards(mesh, *per_shard):
    """The shard devices and each input as a list of k per-shard tensors;
    ``mesh=None`` is one shard on its input's device."""
    if mesh is None:
        return [per_shard[0].device], [[a] for a in per_shard]
    devs = list(check_mesh(mesh).devices)
    lists = [list(a) for a in per_shard]
    for a in lists:
        if len(a) != len(devs):
            raise ValueError(f"{len(a)} shard inputs for {len(devs)} shards")
    return devs, lists


def _replicas(params, devs) -> list:
    """The weights on each shard's device (one copy per distinct device,
    a tree of differentiable copies, so each shard's gradient flows back
    to the one set of weights)."""
    copies = {}
    for d in devs:
        if d not in copies:
            copies[d] = params if params.device == d else tree_map(
                lambda t, d=d: t.to(d), params.tree(live=True))
    return [copies[d] for d in devs]


def _all_gather(parts, devs) -> list:
    """The node rows of every shard, concatenated in shard order, on each
    shard's device (one concatenation per distinct device)."""
    full = {}
    for d in devs:
        if d not in full:
            full[d] = torch.cat([p.to(d) for p in parts])
    return [full[d] for d in devs]


def _real_edges(emask, *per_edge) -> list:
    """The rows of a shard's real edges (``emask`` True): slices where the
    mask is a prefix (``dst_block_partition``'s layout), else one gather.
    A padding edge carries no message (the reference masks it), so the
    vertex-cut forwards drop the pads up front; kept, every pad would join
    destination 0's segment and make it the longest by far.  A ``meta``
    mask has no values to read, so every edge slot is kept (the shapes of
    a shard whose slots all hold real edges)."""
    if emask.is_meta:
        return list(per_edge)
    m = int(emask.sum())
    if bool(emask[:m].all()):
        return [a[:m] for a in per_edge]
    keep = torch.nonzero(emask).squeeze(1)
    return [a.index_select(0, keep) for a in per_edge]


def _unshard(outs, mesh):
    return outs[0] if mesh is None else outs


def mgn_forward_dist(cfg: MGNConfig, params, node_x, edge_x, src_g, dst_l,
                     emask, mesh=None):
    """Vertex-cut forward.  Per shard j: node_x [n_loc, ·]; edges local
    with GLOBAL src ids, LOCAL dst ids, and a validity mask (the
    dst-block partition's pads, dropped up front: ``_real_edges``).  With
    a ``ShardMesh`` each argument is a sequence of k per-shard tensors
    (shard j on ``mesh.devices[j]``) and the result is the list of k
    per-shard outputs [n_loc, d_out]; with ``mesh=None`` each is one
    shard's tensor and so is the result."""
    devs, (node_x, edge_x, src_g, dst_l, emask) = _shards(
        mesh, node_x, edge_x, src_g, dst_l, emask)
    ps = _replicas(params, devs)
    k = len(devs)
    for j in range(k):
        edge_x[j], src_g[j], dst_l[j] = _real_edges(emask[j], edge_x[j],
                                                    src_g[j], dst_l[j])
    h = [_mlp(ps[j]["node_enc"], node_x[j], final_act=True) for j in range(k)]
    e = [_mlp(ps[j]["edge_enc"], edge_x[j], final_act=True)
         for j in range(k)]
    for li in range(cfg.n_layers):
        h_full = _all_gather(h, devs) if mesh is not None else h
        for j in range(k):
            p = ps[j]["layers"][li]
            n_loc = h[j].shape[0]
            e[j] = e[j] + _mlp(p["edge_mlp"], torch.cat(
                [e[j], _gather(h_full[j], src_g[j]),
                 _gather(h[j], dst_l[j])], dim=-1))
            agg = segment.segment_sum(e[j], dst_l[j], n_loc)     # local!
            h[j] = h[j] + _mlp(p["node_mlp"], torch.cat([h[j], agg], dim=-1))
        del h_full
    return _unshard([_mlp(ps[j]["decoder"], h[j]) for j in range(k)], mesh)


def egnn_forward_dist(cfg: EGNNConfig, params, feats, coords, src_g, dst_l,
                      emask, mesh=None):
    """Vertex-cut EGNN: the recipe of ``mgn_forward_dist``, one all-gather
    of (h, x) per layer (the coordinates ride along: [n, d+3]).  Returns
    (outputs, coordinates), each a per-shard list with a mesh."""
    devs, (feats, coords, src_g, dst_l, emask) = _shards(
        mesh, feats, coords, src_g, dst_l, emask)
    ps = _replicas(params, devs)
    k = len(devs)
    for j in range(k):
        src_g[j], dst_l[j] = _real_edges(emask[j], src_g[j], dst_l[j])
    h = [_mlp(ps[j]["embed"], feats[j]) for j in range(k)]
    x = list(coords)
    deg = [segment.segment_sum(
        torch.ones((dst_l[j].shape[0], 1), dtype=h[j].dtype,
                   device=h[j].device), dst_l[j], h[j].shape[0])
        for j in range(k)]
    for li in range(cfg.n_layers):
        hx = [torch.cat([h[j], x[j]], dim=-1) for j in range(k)]
        hx_full = _all_gather(hx, devs) if mesh is not None else hx
        for j in range(k):
            p = ps[j]["layers"][li]
            n_loc = h[j].shape[0]
            h_full, x_full = hx_full[j][:, :-3], hx_full[j][:, -3:]
            diff = _gather(x_full, src_g[j]) - _gather(x[j], dst_l[j])
            d2 = torch.sum(diff * diff, dim=-1, keepdim=True)
            m = _mlp(p["phi_e"], torch.cat(
                [_gather(h_full, src_g[j]), _gather(h[j], dst_l[j]), d2],
                dim=-1), final_act=True)
            w = _mlp(p["phi_x"], m)
            upd = segment.segment_sum(-diff * w, dst_l[j], n_loc)
            x[j] = x[j] + upd / torch.clamp(deg[j], min=1.0)
            agg = segment.segment_sum(m, dst_l[j], n_loc)
            h[j] = h[j] + _mlp(p["phi_h"], torch.cat([h[j], agg], dim=-1))
        del hx, hx_full
    outs = [_mlp(ps[j]["head"], h[j]) for j in range(k)]
    return _unshard(outs, mesh), _unshard(x, mesh)


def _masked_mse(outs, batches, mesh):
    """Σ over real nodes of (out − target)² over the count of their
    elements, the sums folded across shards in shard order."""
    sse, cnt = [], []
    for out, b in zip(outs, batches):
        nmask = b["nmask"][:, None].to(out.dtype)
        sse.append(torch.sum(((out - b["target"]) ** 2) * nmask))
        cnt.append(torch.sum(nmask) * out.shape[-1])
    if mesh is not None:
        sse = segment.psum_like("sum", sse, mesh)
        cnt = segment.psum_like("sum", cnt, mesh)
    return sse[0] / torch.clamp(cnt[0], min=1.0)


def _shard_args(batch, mesh, keys) -> list:
    """Each key's tensor of the one shard's dict, or with a mesh its list
    over the k shards' dicts."""
    if mesh is None:
        return [batch[key] for key in keys]
    return [[b[key] for b in batch] for key in keys]


def egnn_loss_dist(cfg: EGNNConfig, params, batch, mesh=None):
    """Per-node invariant regression (the full-graph cells have one giant
    graph, so the molecule regime's per-graph energy sum does not apply).
    ``batch``: one shard's dict, or with a mesh the k shards' dicts; the
    global mean, on the first shard's device."""
    outs, _ = egnn_forward_dist(cfg, params, *_shard_args(
        batch, mesh, ("feats", "coords", "src", "dst", "emask")), mesh=mesh)
    if mesh is None:
        return _masked_mse([outs], [batch], None)
    return _masked_mse(outs, batch, mesh)


def mgn_loss_dist(cfg: MGNConfig, params, batch, mesh=None):
    """The global mean loss over the shards (the reference's psum-normalised
    per-shard loss, which every shard returns replicated), on the first
    shard's device.  ``batch``: one shard's dict, or with a mesh the k
    shards' dicts."""
    outs = mgn_forward_dist(cfg, params, *_shard_args(
        batch, mesh, ("node_x", "edge_x", "src", "dst", "emask")), mesh=mesh)
    if mesh is None:
        return _masked_mse([outs], [batch], None)
    return _masked_mse(outs, batch, mesh)


# ---------------------------------------------------------------------------
# DimeNet (arXiv:2003.03123) — 6 blocks, d=128, bilinear 8, sph 7, rad 6.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    n_species: int = 16
    d_out: int = 1
    dtype: str = "float32"


def _rbf(d, cfg: DimeNetConfig):
    """DimeNet radial Bessel basis: sin(nπ d/c) / d, n = 1..n_radial, in
    the reference's order of operations, in ``d``'s dtype."""
    n = torch.arange(1, cfg.n_radial + 1, dtype=d.dtype, device=d.device)
    d = torch.clamp(d[:, None], min=1e-6)
    return torch.sin(n * math.pi * d / cfg.cutoff) / d \
        * math.sqrt(2.0 / cfg.cutoff)


def _sbf(d, angle, cfg: DimeNetConfig):
    """Angular × radial basis on triplets: the reference's table-free
    cos(ℓα)⊗Bessel-sin product basis of rank n_spherical × n_radial (its
    TPU adaptation of the spherical Bessel roots table), kept as it is."""
    ell = torch.arange(cfg.n_spherical, dtype=angle.dtype,
                       device=angle.device)
    ang = torch.cos(angle[:, None] * (ell + 1.0))         # [t, S]
    rad = _rbf(d, cfg)                                    # [t, R]
    return (ang[:, :, None] * rad[:, None, :]).reshape(
        d.shape[0], cfg.n_spherical * cfg.n_radial)


def dimenet_init(cfg: DimeNetConfig, generator: Optional[torch.Generator],
                 device=None) -> "GNN":
    dev = resolve_device(device)
    d = cfg.d_hidden
    nsr = cfg.n_spherical * cfg.n_radial
    g = generator
    blocks = [{
        "w_rbf": _normal(g, (cfg.n_radial, d), dev,
                         1.0 / math.sqrt(cfg.n_radial)),
        "w_sbf": _normal(g, (nsr, cfg.n_bilinear), dev, 1.0 / math.sqrt(nsr)),
        "w_kj": _normal(g, (d, d), dev, 1.0 / math.sqrt(d)),
        "bilinear": _normal(g, (d, cfg.n_bilinear, d), dev,
                            0.1 / math.sqrt(d)),
        "mlp": _init_mlp(g, [d, d, d], dev),
        "out_mlp": _init_mlp(g, [d, d], dev),
    } for _ in range(cfg.n_blocks)]
    return GNN(cfg, {
        "species_emb": _normal(g, (cfg.n_species, d), dev, 0.1),
        "edge_emb": _init_mlp(g, [2 * d + cfg.n_radial, d], dev),
        "blocks": blocks,
        "head": _init_mlp(g, [d, d, cfg.d_out], dev)})


def dimenet_geometry(cfg: DimeNetConfig, coords, src, dst, t_kj, t_ji):
    """The forward's geometry: per edge the vector ``diff`` (j→i) and
    ``dist``; per wedge k→j→i ``cosang`` (the cosine between j→k and j→i)
    and the angle ``arccos(clip(cosang, −1, 1))``."""
    diff = _gather(coords, dst) - _gather(coords, src)
    dist = torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=-1),
                                  min=1e-12))
    v1 = -_gather(diff, t_kj)                             # j→k direction
    v2 = _gather(diff, t_ji)                              # j→i direction
    cosang = torch.sum(v1 * v2, dim=-1) / torch.clamp(
        torch.linalg.vector_norm(v1, dim=-1)
        * torch.linalg.vector_norm(v2, dim=-1), min=1e-9)
    ang = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
    return diff, dist, cosang, ang


def dimenet_forward(cfg: DimeNetConfig, params, species, coords, src, dst,
                    t_kj, t_ji, n: int):
    """Directional message passing.

    species [n] int; coords [n, 3]; edges (j→i): src=j, dst=i, e edges;
    triplets: t_kj[t], t_ji[t] are EDGE indices with dst(t_kj) == src(t_ji)
    (wedge k→j→i); the angular basis is evaluated on each wedge.
    """
    _, dist, _, ang = dimenet_geometry(cfg, coords, src, dst, t_kj, t_ji)
    rbf = _rbf(dist, cfg)                                 # [e, R]
    z = _gather(params["species_emb"], species)
    m = _mlp(params["edge_emb"], torch.cat(
        [_gather(z, src), _gather(z, dst), rbf], dim=-1), final_act=True)
    sbf = _sbf(_gather(dist, t_ji), ang, cfg)             # [t, S·R]

    d = cfg.d_hidden
    out_sum = torch.zeros((n, d), dtype=m.dtype, device=m.device)
    e = src.shape[0]
    for p in params["blocks"]:
        # triplet gather: messages of incoming edges k→j modulate edge j→i
        m_kj = _gather(m @ p["w_kj"], t_kj)               # [t, d]
        a = sbf @ p["w_sbf"]                              # [t, B]
        # the bilinear Σ_{d,b} m_kj[t,d]·W[d,b,k]·a[t,b] as one product over
        # the [t, d·B] outer product (never a [t, d, B, d] intermediate)
        inter = (m_kj[:, :, None] * a[:, None, :]).reshape(m_kj.shape[0], -1) \
            @ p["bilinear"].reshape(-1, d)                # [t, d]
        agg = segment.segment_sum(inter, t_ji, e)         # [e, d]
        m = m + _mlp(p["mlp"], agg + rbf @ p["w_rbf"])
        out_sum = out_sum + segment.segment_sum(
            _mlp(p["out_mlp"], m), dst, n)
    return _mlp(params["head"], out_sum)                  # [n, d_out]


def dimenet_loss(cfg: DimeNetConfig, params, batch):
    out = dimenet_forward(cfg, params, batch["species"], batch["coords"],
                          batch["src"], batch["dst"], batch["t_kj"],
                          batch["t_ji"], batch["species"].shape[0])
    energy = segment.segment_sum(out[:, 0], batch["graph_id"],
                                 batch["target"].shape[0])
    return torch.mean((energy - batch["target"]) ** 2)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

_KINDS = {GATConfig: (gat_forward, gat_loss),
          EGNNConfig: (egnn_forward, egnn_loss),
          MGNConfig: (mgn_forward, mgn_loss),
          DimeNetConfig: (dimenet_forward, dimenet_loss)}


class GNN(Params):
    """One GNN of ``cfg`` over the reference's parameter tree (nested dicts
    and lists of tensors, every leaf on one device), indexed as the tree
    is: ``model["layers"][0]["w"]``.  ``model(*args)`` is the config's
    ``*_forward(cfg, model, *args)``, ``model.loss(batch)`` its
    ``*_loss``."""

    def __init__(self, cfg, tree: dict):
        if type(cfg) not in _KINDS:
            raise TypeError(f"no GNN for a {type(cfg).__name__}")
        super().__init__(tree)
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, *args):
        return _KINDS[type(self.cfg)][0](self.cfg, self, *args)

    def loss(self, batch):
        return _KINDS[type(self.cfg)][1](self.cfg, self, batch)

    def tree(self, live: bool = False) -> dict:
        """The parameter tree as nested dicts and lists of tensors
        (detached, sharing the parameters' storage; with ``live`` the
        parameters themselves)."""
        return _tree_of(self, live)

    def to_device(self, device) -> "GNN":
        """The same weights copied to ``device`` (a new model)."""
        dev = resolve_device(device)
        return GNN(self.cfg, tree_map(lambda t: t.to(dev), self.tree()))

    def cast(self, dtype: str) -> "GNN":
        """The same weights held in ``dtype`` (a new model, e.g. float64 to
        measure the float32 forward's rounding)."""
        dt = getattr(torch, dtype)
        return GNN(dataclasses.replace(self.cfg, dtype=dtype),
                   tree_map(lambda t: t.to(dt), self.tree()))


def load_reference_params(cfg, tree: dict, device=None) -> GNN:
    """A model holding the reference's ``*_init(cfg, key)`` tree with numpy
    leaves (``jax.tree.map(np.asarray, params)``); ``cfg`` is the port's
    config of the same fields, and picks the model."""
    dev = resolve_device(device)
    return GNN(cfg, tree_map(lambda a: _from_numpy(np.asarray(a), dev),
                             tree))
