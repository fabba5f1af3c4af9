"""The port's engines end to end against the JAX package's.

``run_program(engine="cuda", device="cpu")`` (the kernels' plain versions)
against JAX ``engine="pallas"`` (Pallas in interpret mode): values bitwise
for int/min/max/or/and rounds and allclose (rtol 1e-5, atol 1e-7) for float
sums, whose reduction order differs; iterations, push/pull split and the
work counters equal.  The RM-XS targets are BENCH_pallas.json's direction
and resolution rows."""
import contextlib

import numpy as np
import pytest
import torch

from conftest import norm_inf
from repro.core import engine as JE
from repro.core import fusion as JF
from repro.core import synthesis as JSy
from repro.core import usecases as JU
from repro.graph import structure as JS
from repro_torch.core import engine as TE
from repro_torch.core import fusion as TF
from repro_torch.core import synthesis as TSy
from repro_torch.core import usecases as TU
from repro_torch.graph import structure as TS
from repro_torch.kernels import edge_reduce as TER

SPECS = ["BFS", "SSSP", "WSP", "WP", "CC", "REACH", "NSP"]


def _pair(weighted=True, undirected=False):
    jg = JS.rmat_graph(400, 3200, seed=11, weighted=weighted)
    if undirected:
        jg = JS.undirected(jg)
    return jg, TS.from_arrays(jg.n, *jg.host_edges(), device="cpu")


def _stats(s):
    return (s.iterations, s.push_iters, s.pull_iters, s.edge_work,
            s.resolve_work, s.gather_work)


@pytest.mark.parametrize("name", SPECS)
def test_cuda_engine_matches_pallas(name):
    jg, tg = _pair(undirected=name == "CC")
    jr = JE.run_program(jg, JF.fuse(JU.ALL_SPECS[name]()), engine="pallas")
    tr = TE.run_program(tg, TF.fuse(TU.ALL_SPECS[name]()), engine="cuda",
                        device="cpu")
    np.testing.assert_array_equal(tr.value.numpy(), np.asarray(jr.value))
    assert _stats(tr.stats) == _stats(jr.stats)
    assert tr.stats.engine_used == "cuda"


@pytest.mark.parametrize("model", [None, "push"])
@pytest.mark.parametrize("weighted", [False, True])
def test_pagerank_matches_pallas(weighted, model):
    jg, tg = _pair()
    jk = (JSy.weighted_pagerank_kernels if weighted
          else JSy.pagerank_kernels)(jg.n)
    tk = (TSy.weighted_pagerank_kernels if weighted
          else TSy.pagerank_kernels)(tg.n)
    jr = JE.run_direct(jg, jk, engine="pallas", model=model)
    tr = TE.run_direct(tg, tk, engine="cuda", model=model, device="cpu")
    np.testing.assert_allclose(tr.value.numpy(), np.asarray(jr.value),
                               rtol=1e-5, atol=1e-7)
    assert _stats(tr.stats) == _stats(jr.stats)


def test_rm_xs_targets():
    """BENCH_pallas.json RM-XS: unweighted BFS 6 iterations, 3 push, edge
    work 7854 auto / 9715 pull-only, resolve = gather work 6025; weighted
    SSSP 8 iterations (3 push, 5 pull), edge work 13703 / 16635."""
    _jg, tg = _pair(weighted=False)
    bfs = TF.fuse(TU.ALL_SPECS["BFS"]())
    auto = TE.run_program(tg, bfs, engine="cuda", device="cpu").stats
    pull = TE.run_program(tg, bfs, engine="cuda", model="pull",
                          device="cpu").stats
    assert (auto.iterations, auto.push_iters, auto.edge_work,
            auto.resolve_work, auto.gather_work) == (6, 3, 7854, 6025, 6025)
    assert (pull.iterations, pull.edge_work) == (6, 9715)
    _jg, tg = _pair(weighted=True)
    sssp = TF.fuse(TU.ALL_SPECS["SSSP"]())
    auto = TE.run_program(tg, sssp, engine="cuda", device="cpu").stats
    pull = TE.run_program(tg, sssp, engine="cuda", model="pull",
                          device="cpu").stats
    assert (auto.iterations, auto.push_iters, auto.pull_iters,
            auto.edge_work) == (8, 3, 5, 13703)
    assert pull.edge_work == 16635


def test_cuda_engine_pull_derives_tile_activity(monkeypatch):
    """Every idempotent pull iteration goes through the derived-activity
    pull (``pull_sweep_frontier``, one call each) and keeps the RM-XS
    counters; PageRank's pull− recompute walks the static tiles with the
    given activity (``pull_sweep``) instead."""
    derived, given = [], []

    def counting(fn, log):
        def spy(*args, **kwargs):
            log.append(1)
            return fn(*args, **kwargs)
        return spy

    monkeypatch.setattr(TER, "pull_sweep_frontier",
                        counting(TER.pull_sweep_frontier, derived))
    monkeypatch.setattr(TER, "pull_sweep", counting(TER.pull_sweep, given))
    _jg, tg = _pair(weighted=False)
    bfs = TF.fuse(TU.ALL_SPECS["BFS"]())
    auto = TE.run_program(tg, bfs, engine="cuda", device="cpu").stats
    assert (auto.iterations, auto.pull_iters, auto.edge_work) == (6, 3, 7854)
    assert len(derived) == auto.pull_iters and not given
    del derived[:]
    pull = TE.run_program(tg, bfs, engine="cuda", model="pull",
                          device="cpu").stats
    assert (pull.iterations, pull.edge_work) == (6, 9715)
    assert len(derived) == pull.iterations and not given
    del derived[:]
    pr = TE.run_direct(tg, TSy.pagerank_kernels(tg.n), engine="cuda",
                       device="cpu").stats
    assert not derived and len(given) == pr.iterations > 0


def test_cuda_engine_marks_sweep_steps_for_the_profiler():
    """Under torch.profiler every sweep step runs inside one
    ``grafs::pull`` or ``grafs::push`` range (a trace attributes the step's
    device time by them); without a profiler none is opened."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops as TO
    _jg, tg = _pair(weighted=False)
    bfs = TF.fuse(TU.ALL_SPECS["BFS"]())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        st = TE.run_program(tg, bfs, engine="cuda", device="cpu").stats
    names = [e.name for e in prof.events()]
    assert names.count("grafs::pull") == st.pull_iters == 3
    assert names.count("grafs::push") == st.push_iters == 3
    assert isinstance(TO._step_range("pull"), contextlib.nullcontext)


def test_weighted_pagerank_push_equals_pull_bitwise():
    _jg, tg = _pair()
    dk = TSy.weighted_pagerank_kernels(tg.n)
    pull = TE.run_direct(tg, dk, engine="cuda", device="cpu")
    push = TE.run_direct(tg, dk, engine="cuda", model="push", device="cpu")
    assert torch.equal(pull.value, push.value)
    assert push.stats.push_iters == push.stats.iterations > 0


@pytest.mark.parametrize("engine", ["pull", "push"])
@pytest.mark.parametrize("name", ["BFS", "SSSP", "WSP", "NSP", "DRR", "RDS"])
def test_reference_engines_match_jax(small_graphs, engine, name):
    jg = small_graphs["rmat"]
    tg = TS.from_arrays(jg.n, *jg.host_edges(), device="cpu")
    jr = JE.run_program(jg, JF.fuse(JU.ALL_SPECS[name]()), engine=engine)
    tr = TE.run_program(tg, TF.fuse(TU.ALL_SPECS[name]()), engine=engine,
                        device="cpu")
    np.testing.assert_allclose(norm_inf(tr.value.numpy()),
                               norm_inf(np.asarray(jr.value)), rtol=1e-5)
    assert (tr.stats.iterations, tr.stats.edge_work) == \
        (jr.stats.iterations, jr.stats.edge_work)


def test_cuda_engine_matches_path_oracle(small_graphs):
    from repro_torch.core.lang import paths_semantics
    tg = TS.from_arrays(small_graphs["line"].n,
                        *small_graphs["line"].host_edges(), device="cpu")
    for name in ("SSSP", "BFS", "WP"):
        spec = TU.ALL_SPECS[name]()
        got = TE.run_program(tg, TF.fuse(spec), engine="cuda",
                             device="cpu").value.numpy()
        want = np.array(paths_semantics(spec, tg), dtype=np.float64)
        np.testing.assert_allclose(norm_inf(got), norm_inf(want))


def test_entry_points_guard_device_and_later_kwargs(monkeypatch):
    _jg, tg = _pair()
    prog = TF.fuse(TU.ALL_SPECS["BFS"]())
    # a mesh must be a ShardMesh (the sharded engines' mesh), on any engine
    with pytest.raises(TypeError, match="ShardMesh"):
        TE.run_program(tg, prog, engine="cuda", device="cpu",
                       mesh=object())
    with pytest.raises(ValueError, match="graph lives on"):
        TE.run_program(tg, prog, engine="cuda", device="meta")
    plan = TE.run_program(tg, prog, engine="auto", device="cpu",
                          explain=True).plan
    assert plan.engine == "cuda" and plan.push_resolution == "sorted"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TE.run_program(tg, prog, engine="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TE.run_direct(tg, TSy.pagerank_kernels(tg.n), engine="cuda")


@pytest.mark.parametrize("name", ["BFS", "SSSP"])
@pytest.mark.parametrize("edges", [([], []), ([0, 1, 2], [0, 1, 2])],
                         ids=["zero-edge", "self-loops"])
def test_degenerate_graphs_match_pallas(edges, name):
    """Graphs outside the synthesis contract (no edges, so c_min = 0) take
    the termination-precondition probe before any sweep."""
    src, dst = (np.array(a, np.int32) for a in edges)
    jg = JS.from_edges(3, src, dst)
    tg = TS.from_arrays(3, *jg.host_edges(), device="cpu")
    jr = JE.run_program(jg, JF.fuse(JU.ALL_SPECS[name]()), engine="pallas")
    tr = TE.run_program(tg, TF.fuse(TU.ALL_SPECS[name]()), engine="cuda",
                        device="cpu")
    np.testing.assert_array_equal(tr.value.numpy(), np.asarray(jr.value))
    assert _stats(tr.stats) == _stats(jr.stats)
