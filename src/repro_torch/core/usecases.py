"""The paper's use-case specifications (Fig. 1), written in the Grafs
specification language — the port's copy of ``repro.core.usecases``.

Each function returns a spec AST; run it with

    prog = fusion.fuse(spec)
    result = engine.run_program(graph, prog, engine="pull")

``handwritten_*`` variants at the bottom mirror the frameworks' reference
implementations (hand-coded kernel functions) for the synthesized-vs-
handwritten experiments (paper Fig. 11 / Table 1).
"""
from __future__ import annotations

from repro_torch.core.lang import (AllPaths, ArgsRestrict, CAPACITY,
                                   Cardinality, HEAD, LENGTH, LetRound, MBin,
                                   MConst, ONE, PathReduce, PathSel,
                                   PENULTIMATE, RBin, ScalarRef, Term,
                                   VertexReduce, WEIGHT)


# --- single path-based reductions ------------------------------------------

def sssp(s: int) -> Term:
    """SSSP(s)(v) = min_{p∈Paths(s,v)} weight(p)"""
    return PathReduce("min", WEIGHT, AllPaths(s))


def cc() -> Term:
    """CC(v) = min_{p∈Paths(v)} head(p)   (undirected graphs)"""
    return PathReduce("min", HEAD, AllPaths(None))


def bfs(s: int) -> Term:
    """BFS(s)(v) = penultimate(arg min_{p∈Paths(s,v)} length(p))"""
    return PathSel(PENULTIMATE, "min", LENGTH, AllPaths(s))


def bfs_depth(s: int) -> Term:
    """Hop count — the 'simpler specification' variant of BFS."""
    return PathReduce("min", LENGTH, AllPaths(s))


def wp(s: int) -> Term:
    """WP: widest path — max capacity over all paths (Table 1 use-case)."""
    return PathReduce("max", CAPACITY, AllPaths(s))


def reach(s: int) -> Term:
    """REACH(s)(v): is v reachable from s?  An ∨-reduction over paths
    (appendix use-case; exercises the boolean monoids end to end).
    Encoded as min-length < ∞ at the spec level with an `or` vertex
    aggregate available via DS-style constraints; the direct boolean
    path-reduction uses ONE with the `or` monoid."""
    return PathReduce("or", ONE, AllPaths(s))


def n_reachable(s: int) -> Term:
    """|{v : reachable from s}| — Σ over vertices of the boolean (sugar:
    sum-reduce the 0/1 reach vector)."""
    return VertexReduce("sum", reach(s))


# --- nested path-based reductions -------------------------------------------

def wsp(s: int) -> Term:
    """WSP(s)(v): widest among the shortest paths (nested; rule FPNEST)."""
    return PathReduce("max", CAPACITY,
                      ArgsRestrict("min", LENGTH, AllPaths(s)))


def nsp(s: int) -> Term:
    """NSP(s)(v) = |args min length|: number of shortest paths."""
    return Cardinality(ArgsRestrict("min", LENGTH, AllPaths(s)))


# --- operators between path-based reductions --------------------------------

def nwr(s: int) -> Term:
    """NWR(s)(v) = narrowest / widest path ratio."""
    return MBin("/", PathReduce("min", CAPACITY, AllPaths(s)),
                PathReduce("max", CAPACITY, AllPaths(s)))


def trust(s1: int, s2: int) -> Term:
    """Trust({s1,s2})(v): wider (stronger) and shorter (closer) paths are
    more trustworthy — division and maximum over 4 path reductions."""
    def per_source(s):
        return MBin("/", PathReduce("max", CAPACITY, AllPaths(s)),
                    MBin("+", PathReduce("min", LENGTH, AllPaths(s)),
                         MConst(1.0)))
    return MBin("max", per_source(s1), per_source(s2))


# --- vertex-based reductions -------------------------------------------------

def ecc(s: int) -> Term:
    """Eccentricity of s: max over v of the shortest length."""
    return VertexReduce("max", PathReduce("min", LENGTH, AllPaths(s)))


def radius(s1: int, s2: int) -> Term:
    """RADIUS sampled over {s1, s2} (paper Fig. 2)."""
    return RBin("min", ecc(s1), ecc(s2))


def diameter(s1: int, s2: int) -> Term:
    return RBin("max", ecc(s1), ecc(s2))


def drr(s1: int, s2: int) -> Term:
    """DRR = Diameter / Radius (common-operation elimination shares the two
    eccentricity computations)."""
    return RBin("/", diameter(s1, s2), radius(s1, s2))


def ds(s: int, k: float = 7.0) -> Term:
    """DS(s) = {v | dist(s, v) ≥ k} (constrained vertex reduction → mask)."""
    dist = PathReduce("min", WEIGHT, AllPaths(s))
    return VertexReduce("collect", MConst(1.0),
                        cond=MBin(">=", dist, MConst(k)))


def rds(s1: int, s2: int) -> Term:
    """RDS: the narrowest of the widest paths to vertices within the radius
    (nested triple-lets → two iteration-map-reduce rounds)."""
    inner = radius(s1, s2)
    widest = PathReduce("max", CAPACITY, AllPaths(s1))
    hops = PathReduce("min", LENGTH, AllPaths(s1))
    body = VertexReduce("min", widest,
                        cond=MBin("<=", hops, ScalarRef("k")))
    return LetRound("k", inner, body)


ALL_SPECS = {
    "SSSP": lambda: sssp(0), "CC": cc, "BFS": lambda: bfs(0),
    "WP": lambda: wp(0), "WSP": lambda: wsp(0), "NSP": lambda: nsp(0),
    "NWR": lambda: nwr(0), "Trust": lambda: trust(0, 1),
    "RADIUS": lambda: radius(0, 1), "DRR": lambda: drr(0, 1),
    "DS": lambda: ds(0, 3.0), "RDS": lambda: rds(0, 1),
    "REACH": lambda: reach(0), "NREACH": lambda: n_reachable(0),
}


# ---------------------------------------------------------------------------
# Handwritten kernel baselines (paper Fig. 11 / Table 1): the reference
# vertex programs shipped with the frameworks, written directly against the
# iteration engines — bypassing fusion and synthesis.
# ---------------------------------------------------------------------------

import torch  # noqa: E402

from repro_torch.core.kernel_lang import FLT, INT, Bin, Lit, Var  # noqa: E402
from repro_torch.core.synthesis import (DirectKernels,  # noqa: E402
                                        pagerank_kernels,
                                        weighted_pagerank_kernels)
from repro_torch.graph.segment import identity  # noqa: E402


# The init kernels are SOURCE-GENERIC (``init_fn(v, s)`` + a ``source``
# default): the engines pass the query source as runtime data.  The engine's
# ⊥-mask keeps every vertex but s at the reduction identity, exactly like
# the synthesized path.  Each set carries its P as an ``Expr`` (``p_expr``),
# from which the cuda engine generates its sweep kernels.

def handwritten_sssp(s: int) -> DirectKernels:
    return DirectKernels(
        name="sssp", rop="min", dtype="float",
        p_fn=lambda env: env["n"] + env["w"],
        init_fn=lambda v, s: torch.where(v == s, 0.0, float("inf")),
        source=s, p_expr=Bin("+", Var("n", FLT), Var("w", FLT)))


def handwritten_bfs_depth(s: int) -> DirectKernels:
    bot = identity("min", torch.int32).item()
    return DirectKernels(
        name="bfs", rop="min", dtype="int",
        p_fn=lambda env: env["n"] + 1,
        init_fn=lambda v, s: torch.where(v == s, 0, bot),
        source=s, p_expr=Bin("+", Var("n", INT), Lit(1, INT)))


def handwritten_cc() -> DirectKernels:
    return DirectKernels(
        name="cc", rop="min", dtype="int",
        p_fn=lambda env: env["n"],
        init_fn=lambda v: v,
        p_expr=Var("n", INT))


def handwritten_wp(s: int) -> DirectKernels:
    inf = float("inf")
    return DirectKernels(
        name="wp", rop="max", dtype="float",
        p_fn=lambda env: torch.minimum(env["n"], env["c"]),
        init_fn=lambda v, s: torch.where(v == s, inf, -inf),
        source=s, p_expr=Bin("min", Var("n", FLT), Var("c", FLT)))


def handwritten_pagerank(n: int, gamma: float = 0.85) -> DirectKernels:
    return pagerank_kernels(n, gamma)


def handwritten_weighted_pagerank(n: int,
                                  gamma: float = 0.85) -> DirectKernels:
    """Edge-weight-proportional PageRank (P = n·w/wdeg(src)); see
    synthesis.weighted_pagerank_kernels."""
    return weighted_pagerank_kernels(n, gamma)


HANDWRITTEN = {
    "SSSP": lambda: handwritten_sssp(0),
    "BFS": lambda: handwritten_bfs_depth(0),
    "CC": handwritten_cc,
    "WP": lambda: handwritten_wp(0),
}
