"""Shape-regime graph/batch generators for the GNN and recsys smoke paths.

The port of ``repro.data.graphs``: the same seeded numpy draws in the same
order, so the same seed gives bitwise the reference's arrays.  Batches
come out as dicts of tensors on ``device`` (``None`` = the CUDA card,
``"cpu"`` here), matching each model's ``*_loss`` contract; a molecule
batch's ``n_graphs`` stays an int.  ``triplets_for`` builds the DimeNet
wedge lists (k→j→i) from an edge list, the 2-hop gather pattern that sits
outside plain SpMM; ``dst_block_partition`` the vertex-cut blocks and
``shard_batch`` the per-shard batches of the vertex-cut forwards.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.graph.structure import (_to, grid_graph, resolve_device,
                                         uniform_graph)


def _tensors(arrays: dict, device) -> dict:
    dev = resolve_device(device)
    return {k: _to(v, dev) if isinstance(v, np.ndarray) else v
            for k, v in arrays.items()}


def triplets_for(src: np.ndarray, dst: np.ndarray,
                 max_triplets: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Wedge lists: pairs of edge indices (t_kj, t_ji) with
    dst(t_kj) == src(t_ji) and k≠i.  Returns (t_kj, t_ji) int32 arrays."""
    e = src.shape[0]
    t_kj, t_ji = [], []
    # reverse adjacency: edges grouped by dst (edges INTO each j)
    order_d = np.argsort(dst, kind="stable")
    indptr_d = np.zeros(int(max(src.max(initial=0), dst.max(initial=0)) + 2),
                        dtype=np.int64)
    np.add.at(indptr_d, dst[order_d] + 1, 1)
    np.cumsum(indptr_d, out=indptr_d)
    for ji in range(e):
        j, i = src[ji], dst[ji]
        lo, hi = indptr_d[j], indptr_d[j + 1]
        for p in range(lo, hi):
            kj = order_d[p]
            if src[kj] != i:                     # exclude backtracking wedge
                t_kj.append(kj)
                t_ji.append(ji)
    t_kj = np.asarray(t_kj, dtype=np.int32)
    t_ji = np.asarray(t_ji, dtype=np.int32)
    if max_triplets is not None and t_kj.shape[0] > max_triplets:
        t_kj, t_ji = t_kj[:max_triplets], t_ji[:max_triplets]
    if t_kj.shape[0] == 0:                       # degenerate tiny graphs
        t_kj = np.zeros(1, np.int32)
        t_ji = np.zeros(1, np.int32)
    return t_kj, t_ji


def molecule_batch(n_graphs: int = 8, n_atoms: int = 12, n_species: int = 8,
                   seed: int = 0, cutoff: float = 2.5, device=None) -> dict:
    """Batched small molecules: random 3D coordinates, radius-graph edges,
    per-graph scalar target.  Returns one flat batch (graph_id segments)."""
    rng = np.random.default_rng(seed)
    species, coords, srcs, dsts, gids = [], [], [], [], []
    off = 0
    for gi in range(n_graphs):
        pos = rng.normal(size=(n_atoms, 3)) * 1.5
        z = rng.integers(0, n_species, size=n_atoms)
        d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
        s, t = np.nonzero((d < cutoff) & (d > 1e-6))
        species.append(z)
        coords.append(pos)
        srcs.append(s + off)
        dsts.append(t + off)
        gids.append(np.full(n_atoms, gi))
        off += n_atoms
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    t_kj, t_ji = triplets_for(src, dst)
    species = np.concatenate(species).astype(np.int32)
    coords = np.concatenate(coords).astype(np.float32)
    gid = np.concatenate(gids).astype(np.int32)
    target = rng.normal(size=n_graphs).astype(np.float32)
    return _tensors({"species": species, "coords": coords,
                     "feats": np.eye(16, dtype=np.float32)[species % 16],
                     "src": src, "dst": dst, "t_kj": t_kj, "t_ji": t_ji,
                     "graph_id": gid, "n_graphs": n_graphs,
                     "target": target}, device)


def mesh_batch(rows: int = 8, cols: int = 8, d_node_in: int = 8,
               d_edge_in: int = 4, d_out: int = 2, seed: int = 0,
               device=None) -> dict:
    """MeshGraphNet-style regular mesh with node/edge features + targets."""
    g = grid_graph(rows, cols, seed=seed, device=device)
    src, dst, _, _ = g.host_edges()
    rng = np.random.default_rng(seed + 1)
    return _tensors({
        "node_x": rng.normal(size=(g.n, d_node_in)).astype(np.float32),
        "edge_x": rng.normal(size=(src.shape[0], d_edge_in))
        .astype(np.float32),
        "src": src.astype(np.int32), "dst": dst.astype(np.int32),
        "target": rng.normal(size=(g.n, d_out)).astype(np.float32)}, device)


def cora_batch(n: int = 128, e: int = 512, d_feat: int = 64,
               n_classes: int = 7, seed: int = 0, device=None) -> dict:
    g = uniform_graph(n, e, seed=seed, weighted=False, device=device)
    src, dst, _, _ = g.host_edges()
    return cora_batch_on(src, dst, n, d_feat, n_classes, seed, device)


def cora_batch_on(src: np.ndarray, dst: np.ndarray, n: int, d_feat: int = 64,
                  n_classes: int = 7, seed: int = 0, device=None) -> dict:
    """``cora_batch``'s features and labels over the edges (src, dst) of
    ``uniform_graph(n, e, seed=seed)`` built already (the same edges its
    own graph would hold)."""
    rng = np.random.default_rng(seed + 1)
    return _tensors({"x": (rng.random((n, d_feat)) < 0.05).astype(np.float32),
                     "src": src.astype(np.int32, copy=False),
                     "dst": dst.astype(np.int32, copy=False),
                     "y": rng.integers(0, n_classes, n).astype(np.int32)},
                    device)


def egnn_batch(n_graphs: int = 4, n_atoms: int = 10, seed: int = 0,
               device=None) -> dict:
    return molecule_batch(n_graphs, n_atoms, seed=seed, device=device)


def dst_block_partition(src, dst, n: int, k: int, pad_factor: float = 1.3):
    """Partition edges by destination block (vertex-cut with local
    scatters): shard j owns nodes [j·n_loc, (j+1)·n_loc) and every edge
    whose dst falls there.  Returns dict of [k, e_pad] arrays: global src,
    LOCAL dst, mask; plus n_loc (n padded to a multiple of k).  As the
    reference's, a block's edges past ``e_pad`` are dropped without a
    word: callers check that Σ mask is the edge count."""
    n_loc = -(-n // k)
    e_pad = max(1, int(np.ceil(src.shape[0] * pad_factor / k)))
    srcs = np.zeros((k, e_pad), np.int32)
    dsts = np.zeros((k, e_pad), np.int32)
    mask = np.zeros((k, e_pad), bool)
    blocks = dst // n_loc
    for j in range(k):
        sel = np.nonzero(blocks == j)[0][:e_pad]
        m = sel.shape[0]
        srcs[j, :m] = src[sel]
        dsts[j, :m] = dst[sel] - j * n_loc
        mask[j, :m] = True
    return {"src": srcs, "dst": dsts, "mask": mask, "n_loc": int(n_loc),
            "e_pad": e_pad}


def shard_batch(batch: dict, part: dict, node_keys: Sequence[str],
                edge_keys: Sequence[str] = (), devices=None) -> list:
    """The k per-shard batches of the vertex-cut forwards from one batch's
    numpy arrays (or tensors) and its ``dst_block_partition``: per shard
    the node rows of its block (``node_keys``, zero-padded to k·n_loc,
    with ``nmask``), the rows of its edges (``edge_keys``, zero-padded to
    e_pad, in the partition's order), its ``src`` / ``dst`` / ``emask``;
    shard j's tensors on ``devices[j]`` (the CUDA card for each by
    default)."""
    k, e_pad = part["src"].shape
    n_loc = part["n_loc"]
    host = {key: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for key, v in batch.items() if key in (*node_keys, *edge_keys,
                                                   "dst")}
    n = host[node_keys[0]].shape[0]
    devices = [None] * k if devices is None else list(devices)
    if len(devices) != k:
        raise ValueError(f"{len(devices)} devices for {k} shards")
    blocks = host["dst"] // n_loc
    out = []
    for j in range(k):
        rows = slice(j * n_loc, min(n, (j + 1) * n_loc))
        shard = {"src": part["src"][j], "dst": part["dst"][j],
                 "emask": part["mask"][j]}
        nmask = np.zeros(n_loc, bool)
        nmask[:rows.stop - rows.start] = True
        shard["nmask"] = nmask
        for key in node_keys:
            a = host[key]
            pad = np.zeros((n_loc,) + a.shape[1:], a.dtype)
            pad[:rows.stop - rows.start] = a[rows]
            shard[key] = pad
        sel = np.nonzero(blocks == j)[0][:e_pad]
        for key in edge_keys:
            a = host[key]
            pad = np.zeros((e_pad,) + a.shape[1:], a.dtype)
            pad[:sel.shape[0]] = a[sel]
            shard[key] = pad
        out.append(_tensors(shard, devices[j]))
    return out


def dlrm_batch(cfg, batch: int, seed: int = 0, device=None) -> dict:
    rng = np.random.default_rng(seed)
    shape = (batch, cfg.n_sparse) if cfg.multi_hot == 1 else \
        (batch, cfg.n_sparse, cfg.multi_hot)
    return _tensors({
        "dense": rng.normal(size=(batch, cfg.n_dense)).astype(np.float32),
        "sparse": rng.integers(0, cfg.vocab, size=shape).astype(np.int32),
        "label": rng.integers(0, 2, size=batch).astype(np.float32)}, device)
