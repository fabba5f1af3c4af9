"""The paper's use-case specifications (Fig. 1), written in the Grafs
specification language — the port's copy of ``repro.core.usecases``.

Each function returns a spec AST; run it with

    prog = fusion.fuse(spec)
    result = engine.run_program(graph, prog, engine="pull")

The ``handwritten_*`` kernel baselines of the reference belong to a later
slice of the port.
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
