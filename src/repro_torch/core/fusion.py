"""Fusion transformations (paper §4.2, Fig. 8) → triple-let normal form.

The port's copy of ``repro.core.fusion``.

Every specification term is rewritten into a ``FusedProgram``: a sequence of
rounds (nested triple-lets, §4.3), each round being exactly the paper's

    ilet X := R F in mlet X' := E in rlet X'' := R'⟨X'⟩ in e

* **ilet**: ONE fused path-based reduction over a tuple of components
  (rules FPRED, FPNEST, FMRED, FILETBIN, FMINILET, FMPAIR + common-operation
  elimination).  Nested ``args min/max`` restrictions become lexicographic
  reduction plans (FPNEST); pairs of flat reductions become tuple plans
  (FMPAIR); duplicate (F, source) components are shared (CSE).
* **mlet**: per-vertex expressions over the component outputs (the map).
* **rlet**: fused vertex-based reductions (FVRED, FLETSBIN, FRINLETS,
  FRPAIR), with optional per-vertex boolean constraints (§4.3 sugar).
* **out**: the final scalar/vertex expression.

Semantics preservation (paper Thm. 1) is checked empirically against the
path-enumeration oracle in ``lang.py``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

from repro_torch.core import lang as L
from repro_torch.core.kernel_lang import Bin, Expr, Lit, Var

# ---------------------------------------------------------------------------
# Fused IR
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Component:
    """One slot of the fused tuple-valued path reduction."""
    idx: int
    f: L.PathFn
    source: Optional[int]          # None ⇒ Paths(v) (all sources)


@dataclasses.dataclass(frozen=True)
class Prim:
    """Plain reduction of component `comp` with monoid `op`."""
    op: str
    comp: int


@dataclasses.dataclass(frozen=True)
class Lex:
    """Lexicographic: extremize `(op, comp)` first; reduce `secondary` over
    the tied paths (result of rules FPNEST / FMRED)."""
    op: str                        # "min" | "max"
    comp: int
    secondary: "Prim | Lex"


Plan = "Prim | Lex"


def plan_components(plan) -> tuple:
    if isinstance(plan, Prim):
        return (plan.comp,)
    return (plan.comp,) + plan_components(plan.secondary)


def plan_output(plan) -> int:
    """Component index whose value the leaf variable binds to."""
    if isinstance(plan, Prim):
        return plan.comp
    return plan_output(plan.secondary)


def plan_key(plan, comps) -> str:
    if isinstance(plan, Prim):
        c = comps[plan.comp]
        return f"{plan.op}:{c.f.kind}@{c.source}"
    c = comps[plan.comp]
    return f"lex[{plan.op}:{c.f.kind}@{c.source}]->{plan_key(plan.secondary, comps)}"


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A bound ilet variable: one (possibly lexicographic) path reduction."""
    name: str
    plan: object                   # Plan


@dataclasses.dataclass
class FusedRound:
    components: list               # [Component]
    leaves: list                   # [Leaf]
    maps: list                     # [(name, Expr over leaf names / ScalarRefs)]
    vreduces: list                 # [(name, op, map_name, cond_map_name|None)]
    out_kind: str                  # "vertex" | "scalar"
    out: Expr                      # over map names (vertex) or vreduce names
    multi_out: Optional[list] = None
                                   # [(key, Expr)] set by fuse_many: every
                                   # paired request's OWN output expression —
                                   # the engine returns {key: value} instead
                                   # of evaluating ``out`` alone


@dataclasses.dataclass
class FusedProgram:
    rounds: list                   # [(bind_name|None, FusedRound)] last = result
    stats: "FusionStats"


@dataclasses.dataclass
class FusionStats:
    fpnest: int = 0                # nested path reductions flattened
    fmred: int = 0                 # PathSel desugared
    fmpair: int = 0                # path-reduction pairings
    frpair: int = 0                # vertex-reduction pairings
    fbin: int = 0                  # operator fusions (FILETBIN/FLETSBIN)
    cse: int = 0                   # common operations eliminated
    wall_ms: float = 0.0

    def total_rules(self):
        return self.fpnest + self.fmred + self.fmpair + self.frpair + self.fbin


# ---------------------------------------------------------------------------
# The fusion pass.
# ---------------------------------------------------------------------------


class _RoundBuilder:
    def __init__(self, stats: FusionStats):
        self.stats = stats
        self.components: list = []
        self.leaves: list = []
        self._leaf_key: dict = {}
        self.maps: list = []
        self.vreduces: list = []
        self._fresh = 0
        self._pending_comps = 0        # components added for a leaf under test

    def fresh(self, prefix):
        self._fresh += 1
        return f"{prefix}{self._fresh}"

    def component(self, f: L.PathFn, source) -> int:
        # NOTE: components are per plan-position, NOT deduped on (f, source) —
        # two leaves reducing the same F with different monoids (e.g. NWR's
        # min-capacity and max-capacity) need distinct iteration state.
        # Common-operation elimination happens at leaf granularity below.
        idx = len(self.components)
        self.components.append(Component(idx=idx, f=f, source=source))
        self._pending_comps += 1
        return idx

    def leaf(self, plan) -> str:
        key = plan_key(plan, self.components)
        if key in self._leaf_key:
            # common-operation elimination: identical reduction already fused —
            # roll back this leaf's freshly added components.
            del self.components[len(self.components) - self._pending_comps:]
            self._pending_comps = 0
            self.stats.cse += 1
            return self._leaf_key[key]
        self._pending_comps = 0
        if self.leaves:
            self.stats.fmpair += 1     # pairing with the existing fused tuple
        name = self.fresh("x")
        self.leaves.append(Leaf(name=name, plan=plan))
        self._leaf_key[key] = name
        return name

    # ----- path-set flattening (FPNEST) ------------------------------------
    def flatten_paths(self, pathset, final_op: str, final_f: L.PathFn):
        """Build the lexicographic plan for (possibly nested) restricted
        paths; returns (plan, source)."""
        restricts = []
        ps = pathset
        while isinstance(ps, L.ArgsRestrict):
            restricts.append(ps)
            ps = ps.inner
        assert isinstance(ps, L.AllPaths)
        source = ps.source
        plan = Prim(final_op, self.component(final_f, source))
        # FPNEST flattens innermost-first: for
        # ArgsRestrict(r2,f2, ArgsRestrict(r1,f1, All)) the primary key is f1
        # (innermost restrict), then f2, then the final F.  `restricts` is
        # outermost-first, so wrapping in list order leaves the innermost
        # restrict as the outermost Lex key.
        for r in restricts:
            self.stats.fpnest += 1
            plan = Lex(op=r.r, comp=self.component(r.f, source), secondary=plan)
        return plan, source

    # ----- m-terms → per-vertex Expr ----------------------------------------
    def lower_m(self, t) -> Expr:
        if isinstance(t, L.PathReduce):
            plan, _ = self.flatten_paths(t.paths, t.r, t.f)
            return Var(self.leaf(plan), "float")
        if isinstance(t, L.PathSel):
            self.stats.fmred += 1
            return self.lower_m(L.PathReduce(
                "min", t.f, L.ArgsRestrict(t.r, t.f_sel, t.paths)))
        if isinstance(t, L.Cardinality):
            return self.lower_m(L.PathReduce("sum", L.ONE, t.paths))
        if isinstance(t, L.MBin):
            self.stats.fbin += 1
            return Bin(t.op, self.lower_m(t.a), self.lower_m(t.b))
        if isinstance(t, L.MConst):
            return Lit(t.val, "float")
        if isinstance(t, L.ScalarRef):
            return Var(f"$scalar:{t.name}", "float")
        raise TypeError(t)

    def add_map(self, expr: Expr) -> str:
        name = self.fresh("m")
        self.maps.append((name, expr))
        return name

    def add_vreduce(self, op, map_name, cond_name) -> str:
        if self.vreduces:
            self.stats.frpair += 1
        name = self.fresh("r")
        self.vreduces.append((name, op, map_name, cond_name))
        return name


def _lower_r(b: _RoundBuilder, t) -> Expr:
    """r-term → scalar Expr over vreduce names."""
    if isinstance(t, L.VertexReduce):
        m_expr = b.lower_m(t.m)
        m_name = b.add_map(m_expr)
        cond_name = None
        if t.cond is not None:
            cond_name = b.add_map(b.lower_m(t.cond))
        r_name = b.add_vreduce(t.r, m_name, cond_name)
        return Var(r_name, "float")
    if isinstance(t, L.RBin):
        b.stats.fbin += 1
        return Bin(t.op, _lower_r(b, t.a), _lower_r(b, t.b))
    if isinstance(t, L.RConst):
        return Lit(t.val, "float")
    if isinstance(t, L.ScalarRef):
        return Var(f"$scalar:{t.name}", "float")
    raise TypeError(t)


def _is_r_term(t) -> bool:
    if isinstance(t, (L.VertexReduce, L.RConst, L.LetRound)):
        return True
    if isinstance(t, L.RBin):
        return True
    return False


def fuse(term, stats: Optional[FusionStats] = None) -> FusedProgram:
    t0 = time.perf_counter()
    stats = stats or FusionStats()
    rounds = []

    def one_round(t, bind_name=None):
        b = _RoundBuilder(stats)
        if _is_r_term(t):
            out = _lower_r(b, t)
            kind = "scalar"
        else:
            expr = b.lower_m(t)
            m_name = b.add_map(expr)
            out = Var(m_name, "float")
            kind = "vertex"
        rounds.append((bind_name, FusedRound(
            components=b.components, leaves=b.leaves, maps=b.maps,
            vreduces=b.vreduces, out_kind=kind, out=out)))

    def walk(t, bind_name=None):
        if isinstance(t, L.LetRound):
            walk(t.bound, bind_name=t.name)   # earlier round(s)
            walk(t.body, bind_name=bind_name)
        else:
            one_round(t, bind_name)

    walk(term, None)
    stats.wall_ms = (time.perf_counter() - t0) * 1e3
    return FusedProgram(rounds=rounds, stats=stats)


def fuse_many(named_terms, stats: Optional[FusionStats] = None) -> FusedProgram:
    """Fuse MANY scalar requests into ONE round with per-request answers.

    ``named_terms`` is a dict (or [(key, term)] sequence) of single-round
    scalar (r-term) specifications — different users' RADIUS/DRR/ECC-style
    queries over one graph.  All of them lower into a SINGLE shared round
    builder, so the paper's pairing rules apply across requests exactly as
    they do within one: shared path reductions dedup through
    common-operation elimination, distinct ones pair via FMPAIR, and the
    vertex reductions pair via FRPAIR.  Unlike the ``r1 + 0*r2`` pairing
    trick (the examples/analytics_service.py sketch), the fused round keeps
    EVERY request's own output expression in ``multi_out``, so one
    execution of the program yields ``{key: value}`` — no per-request
    re-execution (the N+1 the sketch suffered).

    Multi-round (LetRound) and vertex-valued specifications don't pair —
    they raise ``TypeError`` and should run solo via ``fuse``."""
    t0 = time.perf_counter()
    stats = stats or FusionStats()
    items = list(named_terms.items()) if isinstance(named_terms, dict) \
        else list(named_terms)
    if not items:
        raise ValueError("fuse_many needs at least one request")
    b = _RoundBuilder(stats)
    outs = []
    for key, t in items:
        if isinstance(t, L.LetRound) or not _is_r_term(t):
            raise TypeError(
                f"fuse_many pairs single-round scalar requests; request "
                f"{key!r} is a {type(t).__name__} (vertex-valued or "
                "multi-round specifications run solo via fuse)")
        outs.append((key, _lower_r(b, t)))
    round_ = FusedRound(components=b.components, leaves=b.leaves,
                        maps=b.maps, vreduces=b.vreduces, out_kind="scalar",
                        out=outs[0][1], multi_out=outs)
    stats.wall_ms = (time.perf_counter() - t0) * 1e3
    return FusedProgram(rounds=[(None, round_)], stats=stats)


# ---------------------------------------------------------------------------
# Unfused lowering (baseline for the fusion experiments, Fig. 13/14):
# every path reduction / vertex reduction becomes its own single-leaf round.
# ---------------------------------------------------------------------------

def lower_unfused(term) -> FusedProgram:
    """Like ``fuse()``, but every path reduction leaf becomes its OWN round
    (its own iterative pass over the edges) and every vertex reduction its
    own vertex pass — the unfused baseline of the paper's Fig. 13/14."""
    stats = FusionStats()              # stays all-zero: nothing fuses
    rounds = []
    counter = [0]

    def fresh():
        counter[0] += 1
        return f"u{counter[0]}"

    def lower_m(t) -> Expr:
        """m-term → Expr over $vec refs; each leaf emits a vertex round."""
        if isinstance(t, (L.PathReduce, L.PathSel, L.Cardinality)):
            # paper-unfused semantics: every nested restriction (args
            # min/max) is its OWN phase over the edges — the unfused WSP
            # computes shortest lengths in pass 1 and the widest capacity
            # in pass 2 (Fig. 13); only FPNEST merges them.
            ps = getattr(t, "paths", L.AllPaths())
            restricts = []
            while isinstance(ps, L.ArgsRestrict):
                restricts.append(ps)
                ps = ps.inner
            for rr in reversed(restricts):           # innermost first
                b0 = _RoundBuilder(FusionStats())
                e0 = b0.lower_m(L.PathReduce(rr.r, rr.f, ps))
                m0 = b0.add_map(e0)
                rounds.append((fresh(), FusedRound(
                    components=b0.components, leaves=b0.leaves,
                    maps=b0.maps, vreduces=[], out_kind="vertex",
                    out=Var(m0, "float"))))
            b = _RoundBuilder(FusionStats())
            expr = b.lower_m(t)
            m = b.add_map(expr)
            name = fresh()
            rounds.append((name, FusedRound(
                components=b.components, leaves=b.leaves, maps=b.maps,
                vreduces=[], out_kind="vertex", out=Var(m, "float"))))
            return Var(f"$vec:{name}", "float")
        if isinstance(t, L.MBin):
            return Bin(t.op, lower_m(t.a), lower_m(t.b))
        if isinstance(t, L.MConst):
            return Lit(t.val, "float")
        if isinstance(t, L.ScalarRef):
            return Var(f"$scalar:{t.name}", "float")
        raise TypeError(t)

    def lower_r(t) -> Expr:
        if isinstance(t, L.VertexReduce):
            m_expr = lower_m(t.m)
            maps = [("m1", m_expr)]
            cond_name = None
            if t.cond is not None:
                maps.append(("m2", lower_m(t.cond)))
                cond_name = "m2"
            name = fresh()
            rounds.append((name, FusedRound(
                components=[], leaves=[], maps=maps,
                vreduces=[("r1", t.r, "m1", cond_name)],
                out_kind="scalar", out=Var("r1", "float"))))
            return Var(f"$scalar:{name}", "float")
        if isinstance(t, L.RBin):
            return Bin(t.op, lower_r(t.a), lower_r(t.b))
        if isinstance(t, L.RConst):
            return Lit(t.val, "float")
        if isinstance(t, L.ScalarRef):
            return Var(f"$scalar:{t.name}", "float")
        raise TypeError(t)

    def final_round(t, bind_name):
        if _is_r_term(t):
            expr = lower_r(t)
            rounds.append((bind_name, FusedRound(
                components=[], leaves=[], maps=[], vreduces=[],
                out_kind="scalar", out=expr)))
        else:
            expr = lower_m(t)
            rounds.append((bind_name, FusedRound(
                components=[], leaves=[], maps=[("m1", expr)], vreduces=[],
                out_kind="vertex", out=Var("m1", "float"))))

    def walk(t, bind_name=None):
        if isinstance(t, L.LetRound):
            walk(t.bound, bind_name=t.name)
            walk(t.body, bind_name=bind_name)
        else:
            final_round(t, bind_name)

    walk(term)
    return FusedProgram(rounds=rounds, stats=stats)
