"""The plain reference of the four path queries the traffic sends.

Straightforward PyTorch over the edge list, on any device, independent of
the program under test: it imports nothing of it and reads none of its
layouts.  Every answer is given in the program's output encoding (the
GraFS specification language's):

  BFS   int32 parent on the lexicographically least shortest path (the
        least-numbered in-neighbour one hop closer to the root); the root
        is its own parent; unreachable 2**30 - 1 (the min monoid's int32
        identity)
  SSSP  float32 least path weight; unreachable +inf
  WP    float32 widest path (max over paths of the min capacity); the
        root 1e30 (the zero-length path's capacity); unreachable -inf
  WSP   float32 widest among the fewest-hop paths; root and unreachable
        as WP

``state_dtype`` is the precision every vertex state is held in: float32
(every value here is an integer below 2**24, so exact) for the reference,
bfloat16 for the control, which rounds each state and each candidate to
it after every operation, vertex ids included.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

INT_BOT = 2 ** 30 - 1
CAP_INF = 1e30


@dataclasses.dataclass
class RefGraph:
    n: int
    src: torch.Tensor         # [E] int64
    dst: torch.Tensor         # [E] int64
    weight: torch.Tensor      # [E] float32
    capacity: torch.Tensor    # [E] float32
    out_deg: torch.Tensor     # [n] int64


def ref_graph(edges: dict, device="cpu") -> RefGraph:
    def t(a, dtype):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)
    src = t(edges["src"], torch.int64)
    return RefGraph(n=int(edges["n"]), src=src,
                    dst=t(edges["dst"], torch.int64),
                    weight=t(edges["weight"], torch.float32),
                    capacity=t(edges["capacity"], torch.float32),
                    out_deg=torch.bincount(src, minlength=int(edges["n"])))


def _rounder(state_dtype):
    if state_dtype == torch.float32:
        return lambda x: x
    return lambda x: x.to(state_dtype).to(torch.float32)


def bfs_depth(g: RefGraph, root: int) -> torch.Tensor:
    """Hop count from ``root``; -1 where unreachable."""
    depth = torch.full((g.n,), -1, dtype=torch.int64, device=g.src.device)
    depth[root] = 0
    visited = depth >= 0
    front = visited.clone()
    level = 0
    while True:
        nxt = torch.zeros_like(visited)
        nxt[g.dst[front[g.src]]] = True
        nxt &= ~visited
        if not bool(nxt.any()):
            return depth
        level += 1
        depth[nxt] = level
        visited |= nxt
        front = nxt


def bfs_parent(g: RefGraph, root: int,
               state_dtype=torch.float32) -> torch.Tensor:
    rnd = _rounder(state_dtype)

    def held(ids):
        """Vertex ids as the state holds them (exact below 2**24 in
        float32)."""
        return rnd(ids.to(torch.float32)).to(torch.int64)
    depth = bfs_depth(g, root)
    tree = (depth[g.src] >= 0) & (depth[g.dst] == depth[g.src] + 1)
    parent = torch.full((g.n,), INT_BOT, dtype=torch.int64,
                        device=g.src.device)
    parent = parent.scatter_reduce(0, g.dst[tree], held(g.src[tree]), "amin")
    parent[root] = held(torch.tensor(root))
    return parent.to(torch.int32)


def _relax(g: RefGraph, val: torch.Tensor, root: int, extend, better: str,
           rnd):
    """Label-correcting fixpoint from ``root`` over the out-edges of the
    vertices that changed last round."""
    active = torch.zeros(g.n, dtype=torch.bool, device=val.device)
    active[root] = True
    while bool(active.any()):
        e = active[g.src]
        cand = rnd(extend(val[g.src[e]], e))
        new = val.scatter_reduce(0, g.dst[e], cand, better)
        active = new != val
        val = new
    return val


def sssp(g: RefGraph, root: int, state_dtype=torch.float32) -> torch.Tensor:
    rnd = _rounder(state_dtype)
    dist = torch.full((g.n,), float("inf"), device=g.src.device)
    dist[root] = 0.0
    w = rnd(g.weight)
    return _relax(g, dist, root, lambda d, e: d + w[e], "amin", rnd)


def wp(g: RefGraph, root: int, state_dtype=torch.float32) -> torch.Tensor:
    rnd = _rounder(state_dtype)
    width = torch.full((g.n,), float("-inf"), device=g.src.device)
    width[root] = rnd(torch.tensor(CAP_INF, dtype=torch.float32))
    c = rnd(g.capacity)
    return _relax(g, width, root, lambda x, e: torch.minimum(x, c[e]),
                  "amax", rnd)


def wsp(g: RefGraph, root: int, state_dtype=torch.float32) -> torch.Tensor:
    rnd = _rounder(state_dtype)
    depth = bfs_depth(g, root)
    width = torch.full((g.n,), float("-inf"), device=g.src.device)
    width[root] = rnd(torch.tensor(CAP_INF, dtype=torch.float32))
    tree = (depth[g.src] >= 0) & (depth[g.dst] == depth[g.src] + 1)
    es, ed, ec = g.src[tree], g.dst[tree], rnd(g.capacity[tree])
    lvl = depth[ed]
    for level in range(1, int(depth.max()) + 1):
        sel = lvl == level
        width = width.scatter_reduce(
            0, ed[sel], rnd(torch.minimum(width[es[sel]], ec[sel])), "amax")
    return width


REFERENCE = {"BFS": bfs_parent, "SSSP": sssp, "WP": wp, "WSP": wsp}


def answer(g: RefGraph, kind: str, root: int,
           state_dtype=torch.float32) -> np.ndarray:
    return REFERENCE[kind](g, int(root), state_dtype).cpu().numpy()


def reach(g: RefGraph, root: int) -> tuple:
    """(vertices reached from ``root``, out-edges of those vertices)."""
    seen = bfs_depth(g, root) >= 0
    return int(seen.sum()), int(g.out_deg[seen].sum())
