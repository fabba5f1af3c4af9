"""Frozen graph generators of the benchmark's configurations.

Each draws an edge list from one ``torch.Generator`` on the device it is
given, in a few large calls, and returns it as an undirected graph, as both
sources define theirs: self-loops dropped, each pair of vertices joined at
most once, and every edge given as two arcs, (u, v) and (v, u), with one
weight and one capacity.  The arrays are host arrays: ``src``, ``dst``
(int32), ``weight`` and ``capacity`` (float32), sorted by (src, dst).  The
graph is the configuration's own, drawn from its ``graph_seed``, so every
run serves the same graph (on one device type), and the roots the traffic
takes are a pool of the graph's own (``root_pool``).  Nothing here imports
the program: the benchmark hands these arrays both to the program and to
the reference.

``kronecker``: the Graph500 specification's Kronecker generator (its
edge-list generation section; initiator A, B, C, D = 1 - A - B - C), with
the vertex labels randomly permuted as the specification requires.
``uniform``: the GAP Benchmark Suite's ``urand``, every endpoint uniform
over the vertices (Erdos-Renyi).  Weights and capacities are integers
drawn uniformly from the configuration's closed ranges, one of each an
undirected edge.
"""
from __future__ import annotations

import numpy as np
import torch


def _kronecker_endpoints(scale: int, m: int, a: float, b: float, c: float,
                         gen, device):
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        # one row bit and one column bit an edge at every level: the row bit
        # is 1 with probability C + D, the column bit then 1 with D / (C + D)
        # below and B / (A + B) above
        r = torch.rand((2, m), generator=gen, device=device)
        ii = r[0] > ab
        jj = r[1] > torch.where(ii, c_norm, a_norm)
        src |= ii.to(torch.int64) << bit
        dst |= jj.to(torch.int64) << bit
    perm = torch.randperm(1 << scale, generator=gen, device=device)
    return perm[src], perm[dst]


def _uniform_endpoints(scale: int, m: int, gen, device):
    ends = torch.randint(0, 1 << scale, (2, m), generator=gen, device=device)
    return ends[0], ends[1]


def generate(config: dict, device="cpu") -> dict:
    """The edge arrays of one configuration (see ``configs/*.json``), drawn
    from its ``graph_seed``: ``{"n", "src", "dst", "weight",
    "capacity"}``, host arrays."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(config["graph_seed"]))
    scale = int(config["scale"])
    n = 1 << scale
    m = int(config["edge_factor"]) * n
    kind = config["generator"]
    if kind == "kronecker":
        a, b, c = config["initiator"]
        src, dst = _kronecker_endpoints(scale, m, float(a), float(b),
                                        float(c), gen, device)
    elif kind == "uniform":
        src, dst = _uniform_endpoints(scale, m, gen, device)
    else:
        raise ValueError(f"unknown generator {kind!r}")
    # an undirected edge once, by its lesser end first
    lo, hi = torch.minimum(src, dst), torch.maximum(src, dst)
    del src, dst
    keep = lo != hi
    pair = torch.unique(lo[keep] * n + hi[keep])        # sorted, deduplicated
    del lo, hi, keep
    e = pair.numel()
    lo_w, hi_w = config["weight_range"]
    lo_c, hi_c = config["capacity_range"]
    attrs = torch.stack([
        torch.randint(int(lo_w), int(hi_w) + 1, (e,), generator=gen,
                      device=device),
        torch.randint(int(lo_c), int(hi_c) + 1, (e,), generator=gen,
                      device=device)]).to(torch.float32)
    # both arcs of every edge, sorted by (src, dst)
    key = torch.cat([pair, (pair % n) * n + pair // n])
    del pair
    key, order = torch.sort(key)
    attrs = attrs.repeat(1, 2)[:, order].cpu().numpy()
    del order
    ends = torch.stack([key // n, key % n]).to(torch.int32).cpu().numpy()
    return {"n": n, "src": np.ascontiguousarray(ends[0]),
            "dst": np.ascontiguousarray(ends[1]),
            "weight": np.ascontiguousarray(attrs[0]),
            "capacity": np.ascontiguousarray(attrs[1])}


def out_degree(edges: dict) -> np.ndarray:
    return np.bincount(edges["src"], minlength=edges["n"])


def root_pool(edges: dict, size: int, graph_seed: int) -> np.ndarray:
    """``size`` distinct roots of degree at least 1, drawn by the
    graph's own seed: the same vertices in every run."""
    eligible = np.flatnonzero(out_degree(edges) >= 1)
    pick = np.random.default_rng([int(graph_seed), 3]).choice(
        eligible.size, size=min(int(size), eligible.size), replace=False)
    return eligible[pick]
