"""The Grafs specification language (paper §2, §4.1) and its denotational
semantics — the port's copy of ``repro.core.lang``.

An analytics query is a term over:
  * path-based reductions   R_{p ∈ P} F(p)      (m-terms: one value per vertex)
  * vertex-based reductions R_{v ∈ V} m(v)      (r-terms: one scalar)
  * arithmetic operators between terms, nesting via restricted path sets
    (args min/max), and syntactic sugar (cardinality, path selection,
    constrained vertex reductions).

``paths_semantics`` below is the *denotational semantics oracle*: it
evaluates a specification by explicit bounded path enumeration (Def. 5/6 of
the paper) on small host-side graphs.  Everything else in the system —
fusion, synthesis, the five iteration engines — is validated against it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.graph.structure import Graph

# ---------------------------------------------------------------------------
# Path functions F and their algebra (extension laws — DESIGN.md §2).
# ---------------------------------------------------------------------------

INF = float("inf")

# The capacity of the zero-length path is +∞ mathematically, but +∞ is also
# the ⊥/identity of min-reductions (C6).  To keep "source initialized" and
# "unreachable" distinguishable in the engines, the trivial capacity is a
# large FINITE sentinel — any value above engine.BOT_CUTOFF reads as
# "no constraining edge yet" at result interpretation time (DESIGN.md §6).
CAP_INF = 1e30


@dataclasses.dataclass(frozen=True)
class PathFn:
    kind: str          # length|weight|capacity|head|penultimate|one
    dtype: str         # "int"|"float"|"vert"

    def trivial(self, v):
        """F(⟨v,v⟩): value on the zero-length path at v."""
        return {"length": 0, "weight": 0.0, "capacity": CAP_INF, "head": v,
                "penultimate": v, "one": 1}[self.kind]

    def extend(self, n, edge):
        """F(p·e) given F(p)=n and e=(src,dst,w,c) — the extension law."""
        src, dst, w, c = edge
        return {"length": lambda: n + 1,
                "weight": lambda: n + w,
                "capacity": lambda: min(n, c),
                "head": lambda: n,
                "penultimate": lambda: src,
                "one": lambda: n}[self.kind]()

    def __str__(self):
        return self.kind


LENGTH = PathFn("length", "int")
WEIGHT = PathFn("weight", "float")
CAPACITY = PathFn("capacity", "float")
HEAD = PathFn("head", "vert")
PENULTIMATE = PathFn("penultimate", "vert")
ONE = PathFn("one", "int")

PATH_FNS = {f.kind: f for f in
            (LENGTH, WEIGHT, CAPACITY, HEAD, PENULTIMATE, ONE)}

# Reduction functions R (commutative + associative; C7, C8).
IDEMPOTENT = {"min": True, "max": True, "or": True, "and": True,
              "sum": False, "prod": False}


def reduce_op(op: str, a, b):
    return {"min": min, "max": max, "sum": lambda x, y: x + y,
            "prod": lambda x, y: x * y,
            "or": lambda x, y: bool(x) or bool(y),
            "and": lambda x, y: bool(x) and bool(y)}[op](a, b)


def reduce_identity(op: str):
    return {"min": INF, "max": -INF, "sum": 0, "prod": 1,
            "or": False, "and": True}[op]


# ---------------------------------------------------------------------------
# Specification AST.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Term:
    pass


# ----- path sets ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AllPaths:
    """Paths(v) (source=None) or Paths(s, v)."""
    source: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ArgsRestrict:
    """args min/max_{p∈inner} F'(p): the subset of inner paths whose F' value
    is extremal (rule FPNEST flattens this to a lexicographic reduction)."""
    r: str                    # "min" | "max"
    f: PathFn
    inner: "AllPaths | ArgsRestrict"


# ----- m-terms (per-vertex values) ------------------------------------------

@dataclasses.dataclass(frozen=True)
class PathReduce(Term):
    """R_{p ∈ paths} F(p)."""
    r: str
    f: PathFn
    paths: "AllPaths | ArgsRestrict" = AllPaths()


@dataclasses.dataclass(frozen=True)
class PathSel(Term):
    """F(arg R'_{p ∈ paths} F'(p)) — sugar, rule FMRED (used by BFS)."""
    f: PathFn                 # applied to the selected path
    r: str                    # "min" | "max" over f_sel
    f_sel: PathFn
    paths: "AllPaths | ArgsRestrict" = AllPaths()


@dataclasses.dataclass(frozen=True)
class Cardinality(Term):
    """|paths| — sugar for Σ_{p∈paths} 1 (used by NSP)."""
    paths: "AllPaths | ArgsRestrict" = AllPaths()


@dataclasses.dataclass(frozen=True)
class MBin(Term):
    op: str                   # + - * / min max
    a: Term
    b: Term


@dataclasses.dataclass(frozen=True)
class MConst(Term):
    val: float


# ----- r-terms (scalars) -----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VertexReduce(Term):
    """R_{v ∈ V [∧ cond]} m(v).  `collect` gathers {v | cond} as a mask
    (set-valued domain extension, §4.3)."""
    r: str                    # min|max|sum|or|and|collect
    m: Term
    cond: Optional[Term] = None   # boolean m-term constraint on v


@dataclasses.dataclass(frozen=True)
class RBin(Term):
    op: str
    a: Term
    b: Term


@dataclasses.dataclass(frozen=True)
class RConst(Term):
    val: float


@dataclasses.dataclass(frozen=True)
class LetRound(Term):
    """Nested triple-lets (§4.3 Nested Triple-lets): bind the scalar result of
    r-term `bound` to `name`, usable inside `body` (→ a second
    iteration-map-reduce round, e.g. RDS)."""
    name: str
    bound: Term
    body: Term


@dataclasses.dataclass(frozen=True)
class ScalarRef(Term):
    """Reference to a LetRound-bound scalar inside m/r expressions."""
    name: str


# ---------------------------------------------------------------------------
# Denotational semantics oracle: explicit bounded path enumeration.
# ---------------------------------------------------------------------------

def _enum_paths(g: Graph, max_len: int):
    """All paths of length ≤ max_len, as lists of edge tuples, grouped by
    destination.  Exponential — test-sized graphs only."""
    src, dst, w, c = g.host_edges()
    out_edges = [[] for _ in range(g.n)]
    for i in range(src.shape[0]):
        out_edges[int(src[i])].append((int(src[i]), int(dst[i]),
                                       float(w[i]), float(c[i])))
    by_dst = [[] for _ in range(g.n)]
    for v in range(g.n):
        by_dst[v].append((v, []))           # trivial path ⟨v,v⟩ (head=v)
        stack = [(v, [])]
        while stack:
            u, path = stack.pop()
            if len(path) >= max_len:
                continue
            for e in out_edges[u]:
                p2 = path + [e]
                by_dst[e[1]].append((v, p2))
                stack.append((e[1], p2))
    return by_dst


def _path_value(f: PathFn, head: int, path):
    n = f.trivial(head)
    for e in path:
        n = f.extend(n, e)
    return n


def _paths_for(pathset, all_paths_to_v, v):
    """Filter/restrict the candidate (head, path) list per the path-set term."""
    if isinstance(pathset, AllPaths):
        ps = all_paths_to_v
        if pathset.source is not None:
            ps = [(h, p) for (h, p) in ps if h == pathset.source]
            # C(⟨v,v⟩) = (head = s): trivial path only counts at the source
        return ps
    if isinstance(pathset, ArgsRestrict):
        inner = _paths_for(pathset.inner, all_paths_to_v, v)
        if not inner:
            return []
        vals = [_path_value(pathset.f, h, p) for (h, p) in inner]
        best = min(vals) if pathset.r == "min" else max(vals)
        return [hp for hp, val in zip(inner, vals) if val == best]
    raise TypeError(pathset)


def paths_semantics(term: Term, g: Graph, max_len: Optional[int] = None,
                    scalars: Optional[dict] = None):
    """⟦term⟧ by explicit enumeration of paths with length ≤ max_len
    (Def. 6; with max_len ≥ longest simple path this equals Def. 5 whenever
    the termination condition C10 holds)."""
    if max_len is None:
        max_len = g.n
    scalars = scalars or {}
    by_dst = _enum_paths(g, max_len)

    def eval_m(t):
        """m-term → np array of per-vertex values (reduce-identity = ⊥)."""
        if isinstance(t, PathReduce):
            out = np.full(g.n, reduce_identity(t.r), dtype=object)
            for v in range(g.n):
                acc = reduce_identity(t.r)
                for (h, p) in _paths_for(t.paths, by_dst[v], v):
                    acc = reduce_op(t.r, acc, _path_value(t.f, h, p))
                out[v] = acc
            return out
        if isinstance(t, PathSel):
            # lexicographic: best f_sel, tie-broken reduction of f by r
            out = np.full(g.n, reduce_identity(t.r), dtype=object)
            for v in range(g.n):
                cands = _paths_for(ArgsRestrict(t.r, t.f_sel, t.paths),
                                   by_dst[v], v)
                if not cands:
                    out[v] = reduce_identity("min")
                    continue
                acc = reduce_identity("min")
                for (h, p) in cands:
                    acc = reduce_op("min", acc, _path_value(t.f, h, p))
                out[v] = acc
            return out
        if isinstance(t, Cardinality):
            return eval_m(PathReduce("sum", ONE, t.paths))
        if isinstance(t, MBin):
            a, b = eval_m(t.a), eval_m(t.b)
            return np.array([reduce_op(t.op, x, y) if t.op in ("min", "max")
                             else _arith(t.op, x, y) for x, y in zip(a, b)],
                            dtype=object)
        if isinstance(t, MConst):
            return np.full(g.n, t.val, dtype=object)
        if isinstance(t, ScalarRef):
            return np.full(g.n, scalars[t.name], dtype=object)
        raise TypeError(t)

    def eval_r(t):
        if isinstance(t, VertexReduce):
            vals = eval_m(t.m)
            mask = np.ones(g.n, dtype=bool)
            if t.cond is not None:
                mask = np.array([bool(x) for x in eval_m(t.cond)])
            if t.r == "collect":
                return mask
            acc = reduce_identity(t.r)
            for v in range(g.n):
                # C6: ⊥ (identity / unreachable sentinel) is excluded.
                x = vals[v]
                is_bot = (isinstance(x, (int, float)) and
                          (x != x or abs(float(x)) >= 1e8))
                if mask[v] and not is_bot:
                    acc = reduce_op(t.r, acc, x)
            return acc
        if isinstance(t, RBin):
            a, b = eval_r(t.a), eval_r(t.b)
            return reduce_op(t.op, a, b) if t.op in ("min", "max") else _arith(t.op, a, b)
        if isinstance(t, RConst):
            return t.val
        if isinstance(t, ScalarRef):
            return scalars[t.name]
        if isinstance(t, LetRound):
            val = eval_r(t.bound)
            inner = dict(scalars)
            inner[t.name] = val
            return paths_semantics(t.body, g, max_len, inner)
        raise TypeError(t)

    if isinstance(term, (VertexReduce, RBin, RConst, LetRound)):
        return eval_r(term)
    return eval_m(term)


def _arith(op, a, b):
    """IEEE float semantics, matching the engines exactly: x/0 = ±inf,
    ±inf/±inf = nan (⊥-like results on unreachable vertices compare equal
    after the test-side sentinel normalization)."""
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        with np.errstate(divide="ignore", invalid="ignore"):
            return float(np.float64(a) / np.float64(b))
    if op == ">=":
        return a >= b
    if op == "<=":
        return a <= b
    raise ValueError(op)
