"""Fanout neighbour sampler (GraphSAGE-style) for ``minibatch_lg`` training.

The port of ``repro.graph.sampler``: host-side numpy over the port's
``Graph.host_edges()`` (dst-sorted, as the reference's), the same draws in
the same order, so the same seed gives bitwise the reference's batch.
Produces fixed-shape padded batches, so a step over them sees one shape.

All hops share ONE local node universe (the union of every frontier, padded
to ``max_nodes``); each hop's edge block is (src_local, dst_local, mask) and
the forward pass aggregates over the full universe per hop, which keeps every
shape static at the cost of some masked compute.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.graph.structure import Graph


@dataclasses.dataclass
class SampledBatch:
    nodes: np.ndarray        # [max_nodes] int32 global ids (0-padded)
    node_mask: np.ndarray    # [max_nodes] bool
    seeds_local: np.ndarray  # [batch] int32 positions of seeds in `nodes`
    # per hop, outermost (farthest from seeds) first:
    edge_src: list           # [n_edges_hop] int32 local ids
    edge_dst: list           # [n_edges_hop] int32 local ids
    edge_mask: list          # [n_edges_hop] bool


def max_nodes_for(batch: int, fanouts: Sequence[int]) -> int:
    total, frontier = batch, batch
    for f in fanouts:
        frontier *= f
        total += frontier
    return total


class NeighborSampler:
    """Uniform with-replacement in-neighbour sampler over a CSR built once."""

    def __init__(self, g: Graph, fanouts: Sequence[int], seed: int = 0):
        src, dst, _, _ = g.host_edges()
        order = np.argsort(dst, kind="stable")
        self.src_sorted = src[order]
        self.indptr = np.zeros(g.n + 1, dtype=np.int64)
        np.add.at(self.indptr, dst + 1, 1)
        np.cumsum(self.indptr, out=self.indptr)
        self.fanouts = list(fanouts)
        self.rng = np.random.default_rng(seed)
        self.n = g.n

    def sample(self, seeds: np.ndarray) -> SampledBatch:
        seeds = np.asarray(seeds, dtype=np.int64)
        batch = seeds.shape[0]
        cap = max_nodes_for(batch, self.fanouts)

        hops = []                       # (src_global, dst_global, mask)
        frontier = seeds
        for f in self.fanouts:
            n_dst = frontier.shape[0]
            starts = self.indptr[frontier]
            degs = self.indptr[frontier + 1] - starts
            offs = (self.rng.random((n_dst, f))
                    * np.maximum(degs, 1)[:, None]).astype(np.int64)
            idx = np.minimum(starts[:, None] + offs,
                             len(self.src_sorted) - 1)
            srcs = self.src_sorted[idx].astype(np.int64)
            mask = degs[:, None] > 0
            hops.append((srcs.ravel(), np.repeat(frontier, f), mask.ravel()))
            frontier = np.unique(np.concatenate([frontier, srcs.ravel()]))

        universe = np.unique(np.concatenate([seeds] + [h[0] for h in hops]
                                            + [h[1] for h in hops]))
        lut = universe                   # sorted: searchsorted gives local ids
        nodes = np.zeros(cap, dtype=np.int32)
        nodes[:universe.shape[0]] = universe
        node_mask = np.zeros(cap, dtype=bool)
        node_mask[:universe.shape[0]] = True

        def local(ids):
            return np.searchsorted(lut, ids).astype(np.int32)

        edge_src, edge_dst, edge_mask = [], [], []
        for s, d, m in reversed(hops):   # outermost hop first for forward pass
            edge_src.append(local(s))
            edge_dst.append(local(d))
            edge_mask.append(m)
        return SampledBatch(nodes=nodes, node_mask=node_mask,
                            seeds_local=local(seeds),
                            edge_src=edge_src, edge_dst=edge_dst,
                            edge_mask=edge_mask)
