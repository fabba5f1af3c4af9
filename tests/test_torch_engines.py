"""The port's adaptive and dense engines and the handwritten kernel sets
against the JAX package's.

``engine="adaptive"`` and ``engine="dense"`` of ``repro_torch`` (torch
segment ops and dense reductions on the CPU) against the same engines of
``repro``: values bitwise for int/min/max/or/and rounds, with iterations,
edge work and the adaptive engine's pull iterations equal; allclose (rtol
1e-5, atol 1e-7) for float sums, whose reduction order differs, with equal
iteration counts.  The handwritten kernel sets (paper Fig. 11) run through
``run_direct`` on pull, adaptive and cuda (the kernels' plain versions; the
reference's pallas in interpret mode), bitwise."""
import numpy as np
import pytest
import torch

from conftest import norm_inf
from repro.core import engine as JE
from repro.core import fusion as JF
from repro.core import iterate as JI
from repro.core import synthesis as JSy
from repro.core import usecases as JU
from repro.graph import structure as JS
from repro_torch.core import engine as TE
from repro_torch.core import fusion as TF
from repro_torch.core import iterate as TI
from repro_torch.core import synthesis as TSy
from repro_torch.core import usecases as TU
from repro_torch.graph import structure as TS

EXACT = ["BFS", "SSSP", "WSP", "WP", "REACH", "CC"]


def _graphs(kind, undirected=False):
    jg = {"rmat": lambda: JS.rmat_graph(400, 3200, seed=11),
          "uniform": lambda: JS.uniform_graph(300, 1500, seed=5),
          "rmat64": lambda: JS.rmat_graph(64, 384, seed=4)}[kind]()
    if undirected:
        jg = JS.undirected(jg)
    return jg, TS.from_arrays(jg.n, *jg.host_edges(), device="cpu")


def _counters(s):
    return (s.iterations, s.edge_work, s.pull_iters)


def _float_sum(prog) -> bool:
    """Whether a fused program reduces a float sum or product anywhere."""
    def ops(plan):
        yield plan.op
        if hasattr(plan, "secondary"):
            yield from ops(plan.secondary)
    return any(op in ("sum", "prod") for _n, r in prog.rounds
               for leaf in r.leaves for op in ops(leaf.plan))


def _assert_values(got, want, exact):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# adaptive
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmat", "uniform"])
@pytest.mark.parametrize("name", EXACT)
def test_adaptive_matches_reference(name, kind):
    jg, tg = _graphs(kind, undirected=name == "CC")
    jr = JE.run_program(jg, JF.fuse(JU.ALL_SPECS[name]()), engine="adaptive")
    tr = TE.run_program(tg, TF.fuse(TU.ALL_SPECS[name]()), engine="adaptive",
                        device="cpu")
    _assert_values(tr.value, jr.value, exact=True)
    assert _counters(tr.stats) == _counters(jr.stats)
    assert tr.stats.engine_used == "adaptive" and tr.stats.fallbacks == ()


@pytest.mark.parametrize("name", ["NSP", "PageRank", "weighted PageRank"])
def test_adaptive_float_sums_match_reference(name):
    jg, tg = _graphs("rmat")
    if name == "NSP":
        jr = JE.run_program(jg, JF.fuse(JU.ALL_SPECS[name]()),
                            engine="adaptive")
        tr = TE.run_program(tg, TF.fuse(TU.ALL_SPECS[name]()),
                            engine="adaptive", device="cpu")
    else:
        weighted = name.startswith("weighted")
        jk = (JSy.weighted_pagerank_kernels if weighted
              else JSy.pagerank_kernels)(jg.n)
        tk = (TSy.weighted_pagerank_kernels if weighted
              else TSy.pagerank_kernels)(tg.n)
        jr = JE.run_direct(jg, jk, engine="adaptive")
        tr = TE.run_direct(tg, tk, engine="adaptive", device="cpu")
    _assert_values(tr.value, jr.value, exact=False)
    assert tr.stats.iterations == jr.stats.iterations
    assert tr.stats.pull_iters == jr.stats.pull_iters


def _sssp_round(iterate_pkg, fusion_pkg, usecases_pkg, synth_pkg):
    round_ = fusion_pkg.fuse(usecases_pkg.sssp(0)).rounds[0][1]
    comps = iterate_pkg.comp_runtimes(round_,
                                      synth_pkg.synthesize_round(round_))
    return comps, [leaf.plan for leaf in round_.leaves]


def test_adaptive_threshold_switches_direction():
    """As ``tests/test_grafs_core.py`` has it: at a 0.5 threshold the
    engine uses both directions, and the port flips on the same
    iterations."""
    jg, tg = _graphs("rmat")
    jres = JI.iterate_adaptive(jg, *_sssp_round(JI, JF, JU, JSy),
                               dense_threshold=0.5)
    tres = TI.iterate_adaptive(tg, *_sssp_round(TI, TF, TU, TSy),
                               dense_threshold=0.5)
    assert 0 < tres.pull_iters <= tres.iterations
    assert (tres.iterations, tres.pull_iters, tres.edge_work) == \
        (jres.iterations, jres.pull_iters, jres.edge_work)
    np.testing.assert_array_equal(tres.state[0].numpy(),
                                  np.asarray(jres.state[0]))


@pytest.mark.parametrize("name", ["SSSP", "BFS"])
def test_dense_threshold_hint_leaves_adaptive_unchanged(name):
    """The entry points call the adaptive engine without the plan's
    ``dense_threshold`` (the reference's behaviour): a hint resolves into
    the plan and changes nothing, in both packages."""
    jg, tg = _graphs("rmat")
    jp, tp = JF.fuse(JU.ALL_SPECS[name]()), TF.fuse(TU.ALL_SPECS[name]())
    j0 = JE.run_program(jg, jp, engine="adaptive")
    t0 = TE.run_program(tg, tp, engine="adaptive", device="cpu")
    jplan = JE.plan_execution(jg, jp, engine="adaptive", switch_k=None,
                              dense_threshold=0.5)
    tplan = TE.plan_execution(tg, tp, engine="adaptive", switch_k=None,
                              dense_threshold=0.5)
    assert jplan.dense_threshold == tplan.dense_threshold == 0.5
    j1 = JE.run_program(jg, jp, plan=jplan)
    t1 = TE.run_program(tg, tp, plan=tplan, device="cpu")
    for a, b in ((j0, j1), (t0, t1)):
        np.testing.assert_array_equal(np.asarray(a.value),
                                      np.asarray(b.value))
        assert _counters(a.stats) == _counters(b.stats)
    assert _counters(t1.stats) == _counters(j1.stats)


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(JU.ALL_SPECS))
def test_dense_matches_reference(name):
    jg, tg = _graphs("rmat64", undirected=name == "CC")
    jp, tp = JF.fuse(JU.ALL_SPECS[name]()), TF.fuse(TU.ALL_SPECS[name]())
    jr = JE.run_program(jg, jp, engine="dense")
    tr = TE.run_program(tg, tp, engine="dense", device="cpu")
    exact = not _float_sum(tp)
    _assert_values(tr.value, jr.value, exact)
    assert tr.stats.iterations == jr.stats.iterations
    assert tr.stats.edge_work == jr.stats.edge_work
    assert tr.stats.engine_used == "dense"


@pytest.mark.parametrize("weighted", [False, True])
def test_dense_pagerank_matches_reference(weighted):
    jg, tg = _graphs("rmat64")
    jk = (JSy.weighted_pagerank_kernels if weighted
          else JSy.pagerank_kernels)(jg.n)
    tk = (TSy.weighted_pagerank_kernels if weighted
          else TSy.pagerank_kernels)(tg.n)
    jr = JE.run_direct(jg, jk, engine="dense")
    tr = TE.run_direct(tg, tk, engine="dense", device="cpu")
    _assert_values(tr.value, jr.value, exact=False)
    assert tr.stats.iterations == jr.stats.iterations


def test_dense_engine_expands_views():
    """The per-vertex inputs of P are expanded views of [n] vectors, never
    [n, n] copies: a P that reads them allocates only its result."""
    _jg, tg = _graphs("rmat64")
    seen = {}

    def p_fn(env):
        seen.update({k: env[k] for k in ("esrc", "edst", "outdeg",
                                           "wdeg")})
        return env["n"] + env["w"]

    comp = TI.CompRuntime(0, "min", torch.float32, p_fn,
                          lambda v, s: torch.where(v == s, 0.0, np.inf), 0)
    from repro_torch.core.fusion import Prim
    TI.iterate_dense(tg, [comp], [Prim("min", 0)], max_iter=1)
    for name, t in seen.items():
        assert t.shape == (tg.n, tg.n), name
        assert 0 in t.stride(), f"{name} is materialised"


# ---------------------------------------------------------------------------
# handwritten kernel sets
# ---------------------------------------------------------------------------

_REF_ENGINE = {"pull": "pull", "adaptive": "adaptive", "cuda": "pallas"}


@pytest.mark.parametrize("engine", ["pull", "adaptive", "cuda"])
@pytest.mark.parametrize("name", ["SSSP", "BFS", "WP", "CC"])
def test_handwritten_matches_reference(name, engine):
    jg, tg = _graphs("rmat", undirected=name == "CC")
    jr = JE.run_direct(jg, JU.HANDWRITTEN[name](),
                       engine=_REF_ENGINE[engine])
    tr = TE.run_direct(tg, TU.HANDWRITTEN[name](), engine=engine,
                       device="cpu")
    _assert_values(tr.value, jr.value, exact=True)
    assert (tr.stats.iterations, tr.stats.edge_work, tr.stats.push_iters) \
        == (jr.stats.iterations, jr.stats.edge_work, jr.stats.push_iters)
    assert tr.stats.engine_used == engine


@pytest.mark.parametrize("engine", ["pull", "cuda"])
def test_handwritten_matches_synthesized(engine):
    """Fig. 11 premise (``tests/test_grafs_core.py``): handwritten kernel
    sets compute the synthesized values, ⊥-ish values collapsed to one
    token (the handwritten WP starts its source at +inf, the synthesized
    one at 1e30).  On the cuda engine the counters agree too."""
    _jg, tg = _graphs("uniform")
    _jgu, tgu = _graphs("uniform", undirected=True)
    specs = {"SSSP": TU.sssp(0), "BFS": TU.bfs_depth(0), "WP": TU.wp(0),
             "CC": TU.cc()}
    for name, spec in specs.items():
        g = tgu if name == "CC" else tg
        want = TE.run_program(g, TF.fuse(spec), engine=engine, device="cpu")
        got = TE.run_direct(g, TU.HANDWRITTEN[name](), engine=engine,
                            device="cpu")
        np.testing.assert_array_equal(norm_inf(got.value.numpy()),
                                      norm_inf(want.value.numpy()),
                                      err_msg=name)
        assert (got.stats.iterations, got.stats.edge_work,
                got.stats.push_iters) == (want.stats.iterations,
                                          want.stats.edge_work,
                                          want.stats.push_iters), name


@pytest.mark.parametrize("name", ["pagerank", "weighted_pagerank"])
def test_handwritten_pagerank_matches_reference(name):
    """The handwritten PageRank sets are synthesis' kernel sets, P
    included."""
    jg, tg = _graphs("rmat")
    tk = getattr(TU, f"handwritten_{name}")(tg.n)
    assert tk.p_expr == getattr(TSy, f"{name}_kernels")(tg.n).p_expr
    tr = TE.run_direct(tg, tk, engine="adaptive", device="cpu")
    jr = JE.run_direct(jg, getattr(JU, f"handwritten_{name}")(jg.n),
                       engine="adaptive")
    _assert_values(tr.value, jr.value, exact=False)
    assert tr.stats.iterations == jr.stats.iterations


def test_planner_resolves_new_engines():
    """adaptive and dense resolve their knobs as the reference's planner
    does, and ``explain=True`` reports them."""
    jg, tg = _graphs("rmat")
    jp, tp = JF.fuse(JU.ALL_SPECS["BFS"]()), TF.fuse(TU.ALL_SPECS["BFS"]())
    for eng in ("adaptive", "dense"):
        jx = JE.run_program(jg, jp, engine=eng, model="push",
                            fallback=True, explain=True)
        tx = TE.run_program(tg, tp, engine=eng, model="push",
                            fallback=True, explain=True, device="cpu")
        for field in ("engine", "model", "direction", "switch_k",
                      "dense_threshold", "push_resolution", "fallback"):
            assert getattr(tx.plan, field) == getattr(jx.plan, field), field
        assert tx.decisions["direction"] == jx.decisions["direction"]
    with pytest.raises(ValueError, match="unknown engine"):
        TE.run_program(tg, tp, engine="pallas", device="cpu")
