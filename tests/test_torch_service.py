"""The continuous-batching analytics service: the port against the JAX
package's.

The counterparts of ``tests/test_analytics_service.py`` (every case, on
its sizes and seeds) on ``repro_torch.launch.service`` with the ``cuda``
engine on the CPU (``device="cpu"``: the plain versions of the kernels),
each scenario run on both packages over the same graph (carried across
with ``from_arrays``) and the same seeded trace, the reference on
``pallas`` in interpret mode as its own tests run it.  Both services must
agree on ``metrics()`` (every key but ``wall_*``), the completion order,
each request's lane, iterations, chunks, joined launch and virtual
arrival and completion times, and each answer bitwise.  ``fuse_many``
answers, rejections and FRPAIR counts are held to the reference's.

Port-only checks: the RM-XS ``serving_rows`` of ``BENCH_pallas.json`` met
exactly; a retired answer and its memo row keep their bits when the slot
is reused; the carried lane state and the memo stay tensors on the
graph's device on every chunk; ``add_graph`` refuses a graph on another
device and ``ServiceConfig()`` without a card raises.  The mutation and
planner cases, and the ``analytics`` driver, are in
``tests/test_torch_service_mutate.py``.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core import fusion as JF
from repro.core import usecases as JU
from repro.graph import structure as JS
from repro.launch import service as JSV
from repro_torch.core import engine as TE
from repro_torch.core import fusion as TF
from repro_torch.core import usecases as TU
from repro_torch.graph import structure as TS
from repro_torch.launch import service as TSV

pytestmark = pytest.mark.service

BENCH = Path(__file__).resolve().parents[1] / "BENCH_pallas.json"
FIELDS = ("rid", "lane", "iterations", "chunks", "joined_launch", "arrival",
          "completed")


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    yield
    TE.clear_program_caches()


def _port(jg):
    return TS.from_arrays(jg.n, *jg.host_edges(), device="cpu")


class _Side:
    """One package's service over one graph: ``S`` the service module,
    ``U`` the use cases, ``E`` the engine module."""

    def __init__(self, ref: bool, g, gname="g", max_batch=4, chunk_iters=3,
                 **kw):
        self.ref = ref
        self.S, self.U, self.E = (JSV, JU, JE) if ref else (TSV, TU, TE)
        cfg = self.S.ServiceConfig(
            max_batch=max_batch, chunk_iters=chunk_iters,
            **(dict(engine="pallas") if ref else dict(device="cpu")), **kw)
        self.svc = self.S.AnalyticsService(cfg)
        self.g = g
        self.svc.add_graph(gname, g)
        self.svc.register("BFS", self.U.bfs)
        self.svc.register("SSSP", self.U.sssp)


def _pair(jg, **kw):
    return _Side(True, jg, **kw), _Side(False, _port(jg), **kw)


def _drain(svc, limit=10_000):
    steps = 0
    while svc.step():
        steps += 1
        assert steps < limit, "service failed to drain"
    return steps


def _no_wall(m):
    return {k: v for k, v in m.items() if not k.startswith("wall")}


def _same_value(want, got):
    if isinstance(want, float):
        assert isinstance(got, float)
        assert np.float64(got).tobytes() == np.float64(want).tobytes()
        return
    want = np.asarray(want)
    assert isinstance(got, np.ndarray)
    assert (got.dtype, got.shape) == (want.dtype, want.shape)
    assert got.tobytes() == want.tobytes()


def _same_service(js, ts):
    """The port's service scheduled and answered as the reference's."""
    assert _no_wall(ts.svc.metrics()) == _no_wall(js.svc.metrics())
    assert [r.rid for r in ts.svc.completed] == \
        [r.rid for r in js.svc.completed]
    for jr, tr in zip(js.svc.completed, ts.svc.completed):
        assert tuple(getattr(tr, f) for f in FIELDS) == \
            tuple(getattr(jr, f) for f in FIELDS), jr.rid
        _same_value(jr.value, tr.value)


def _skewed_graph():
    """The reference test's graph: a 48-vertex line (SSSP from vertex 0
    walks ~47 rounds) plus a 6-vertex clique on vertices 48..53."""
    line_src = np.arange(47)
    line_dst = np.arange(1, 48)
    cl = np.arange(48, 54)
    a, b = np.meshgrid(cl, cl)
    keep = a.ravel() != b.ravel()
    src = np.concatenate([line_src, a.ravel()[keep]]).astype(np.int32)
    dst = np.concatenate([line_dst, b.ravel()[keep]]).astype(np.int32)
    w = np.ones(src.size, np.float32)
    return JS.from_edges(54, src, dst, weight=w)


# ---------------------------------------------------------------------------
# queue drain
# ---------------------------------------------------------------------------


def test_queue_drain_all_lanes(small_graphs):
    g = small_graphs["uniform2"]
    sides = _pair(g)
    for side in sides:
        S, U, svc = side.S, side.U, side.svc
        for i in range(6):                       # batch lane (two kinds)
            svc.submit("g", S.Request(rid=i, kind=("BFS", "SSSP")[i % 2],
                                      source=i % g.n))
        for i in range(6, 9):                    # scalar lane
            svc.submit("g", S.Request(rid=i,
                                      spec=U.radius(i % g.n, (i + 1) % g.n)))
        svc.submit("g", S.Request(rid=9, spec=U.rds(0, 1)))   # solo
        _drain(svc)
    ts = sides[1].svc
    assert {q.rid for q in ts.completed} == set(range(10))
    assert ts.solo_runs == 1
    assert ts.scalar_fused == 3 and ts.scalar_rounds == 1
    assert ts.batch_completed == 6
    assert not ts._has_work()
    _same_service(*sides)


def test_submit_validation(small_graphs):
    for side in _pair(small_graphs["uniform"]):
        S, svc = side.S, side.svc
        with pytest.raises(KeyError, match="not resident"):
            svc.submit("nope", S.Request(rid=0, kind="BFS", source=0))
        with pytest.raises(KeyError, match="unregistered"):
            svc.submit("g", S.Request(rid=0, kind="PAGERANK", source=0))
        with pytest.raises(ValueError, match="kind or a spec"):
            svc.submit("g", S.Request(rid=0))


# ---------------------------------------------------------------------------
# batch-join determinism
# ---------------------------------------------------------------------------


def _open_loop(side, n, rate, seed, make=None):
    make = make or side.S.standard_mix("g", side.g.n)
    arrivals = side.S.open_loop_arrivals(n, rate=rate, seed=seed,
                                         make_request=make)
    return side.svc.run_open_loop(arrivals)


@pytest.mark.parametrize("seed", [0, 11])
def test_open_loop_replay_is_deterministic(small_graphs, seed):
    """Two port replays of one trace agree on every metric and answer, and
    with the reference's run of it."""
    g = small_graphs["rmat"]
    js, t1 = _pair(g, max_batch=3, chunk_iters=2)
    t2 = _Side(False, t1.g, max_batch=3, chunk_iters=2)
    for side in (js, t1, t2):
        _open_loop(side, 16, 800.0, seed)
    _same_service(js, t1)
    _same_service(js, t2)


# ---------------------------------------------------------------------------
# bitwise equivalence to sequential execution
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 5, 9])
def test_open_loop_bitwise_vs_sequential(small_graphs, seed):
    sides = _pair(small_graphs["uniform2"], max_batch=3, chunk_iters=4)
    for side in sides:
        m = _open_loop(side, 14, 6000.0, seed)
        assert m["completed"] == 14
        assert side.S.verify_sequential(side.svc) == 14
        assert m["queries_per_launch"] > 1.0
    _same_service(*sides)


# ---------------------------------------------------------------------------
# convergence skew: short queries never wait for long batchmates
# ---------------------------------------------------------------------------


def test_short_query_retires_before_long_batchmate():
    sides = _pair(_skewed_graph(), max_batch=4, chunk_iters=4)
    for side in sides:
        S, svc = side.S, side.svc
        long_q = S.Request(rid=0, kind="SSSP", source=0)
        short_q = S.Request(rid=1, kind="SSSP", source=50)
        svc.submit("g", long_q)
        svc.submit("g", short_q)
        _drain(svc)
        assert long_q.joined_launch == short_q.joined_launch
        assert short_q.chunks == 1
        assert long_q.chunks > 3
        assert short_q.completed < long_q.completed
        assert S.verify_sequential(svc) == 2
    _same_service(*sides)


def test_late_joiner_into_live_batch_matches_solo():
    sides = _pair(_skewed_graph(), max_batch=2, chunk_iters=4)
    for side in sides:
        S, svc = side.S, side.svc
        svc.submit("g", S.Request(rid=0, kind="SSSP", source=0))
        svc.submit("g", S.Request(rid=1, kind="SSSP", source=48))
        assert svc.step()
        assert len(svc.completed) == 1 and svc.completed[0].rid == 1
        late = S.Request(rid=2, kind="SSSP", source=52)
        svc.submit("g", late)
        _drain(svc)
        assert late.joined_launch > 0
        assert len(svc.completed) == 3
        assert S.verify_sequential(svc) == 3
    _same_service(*sides)


@pytest.mark.parametrize("seed", [3, 17])
@pytest.mark.parametrize("ref_engine", ["cuda", "pull"])
def test_late_joiner_values_across_engines(small_graphs, seed, ref_engine):
    """Joins at random chunk boundaries: the served answers match solo runs
    bitwise on the serving engine and value-wise (rtol 1e-6, as the
    reference test holds it) on the port's independent pull engine."""
    g = small_graphs["uniform2"]
    sides = _pair(g, max_batch=2, chunk_iters=2)
    for side in sides:
        S = side.S

        def make(r, i, S=S):
            kind = ("BFS", "SSSP")[int(r.integers(2))]
            return "g", S.Request(kind=kind, source=int(r.integers(g.n)))

        _open_loop(side, 10, 600.0, seed, make)
        assert len(side.svc.completed) == 10
    _same_service(*sides)
    ts = sides[1]
    if ref_engine == "cuda":
        assert TSV.verify_sequential(ts.svc) == 10
    else:
        for req in ts.svc.completed:
            _, prog, _ = ts.svc._kinds[req.kind]
            ref = TE.run_program(ts.g, prog, engine="pull", source=req.source,
                                 device="cpu").value
            np.testing.assert_allclose(
                np.asarray(req.value, np.float64),
                ref.double().numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# graph LRU / cache-eviction bounds
# ---------------------------------------------------------------------------


def test_graph_lru_eviction_bounds_caches():
    graphs = [JS.uniform_graph(10 + i, 24, seed=i) for i in range(4)]
    ported = [_port(g) for g in graphs]
    js = _Side(True, graphs[0], gname="g0", max_graphs=2)
    ts = _Side(False, ported[0], gname="g0", max_graphs=2)
    per_graph = {}
    for side, gs in ((js, graphs), (ts, ported)):
        S, svc = side.S, side.svc
        svc.submit("g0", S.Request(rid=0, kind="BFS", source=0))
        _drain(svc)
        per_graph[side.ref] = side.E.program_cache_stats()["ell_layouts"]
        assert per_graph[side.ref] > 0
        for i in (1, 2, 3):
            svc.add_graph(f"g{i}", gs[i])
            svc.submit(f"g{i}", S.Request(rid=i, kind="BFS", source=0))
            _drain(svc)
        assert len(svc.graphs) <= 2
        assert svc.graph_evictions == 2
        assert set(svc.graphs) == {"g2", "g3"}
        stats = side.E.program_cache_stats()
        assert stats["ell_layouts"] <= 2 * per_graph[side.ref]
        checked = S.verify_sequential(
            svc, graphs={f"g{i}": gs[i] for i in range(4)})
        assert checked == 4
    assert per_graph[False] == per_graph[True]
    assert TE.program_cache_stats()["ell_layouts"] == \
        JE.program_cache_stats()["ell_layouts"]
    _same_service(js, ts)


def test_busy_graph_is_never_evicted(small_graphs):
    js = _Side(True, small_graphs["uniform"], max_graphs=1)
    ts = _Side(False, _port(small_graphs["uniform"]), max_graphs=1)
    for side in (js, ts):
        S, svc = side.S, side.svc
        conv = (lambda g: g) if side.ref else _port
        svc.submit("g", S.Request(rid=0, kind="SSSP", source=0))
        svc.add_graph("g2", conv(small_graphs["uniform2"]))
        assert "g" in svc.graphs          # busy: capacity bound is soft
        _drain(svc)
        svc.add_graph("g3", conv(small_graphs["rmat"]))
        assert "g" not in svc.graphs      # idle now: evicted
        assert svc.graph_evictions >= 1
    _same_service(js, ts)


def test_clear_graph_caches_is_per_graph(small_graphs):
    g1, g2 = (_port(small_graphs[k]) for k in ("uniform", "uniform2"))
    for g in (g1, g2):
        TE.run_program(g, TF.fuse(TU.bfs(0)), engine="cuda", device="cpu")
    before = TE.program_cache_stats()["ell_layouts"]
    dropped = TE.clear_graph_caches(g1)
    assert dropped > 0
    after = TE.program_cache_stats()["ell_layouts"]
    assert 0 < after < before          # g2's layouts survived
    for g in (small_graphs["uniform"], small_graphs["uniform2"]):
        JE.run_program(g, JF.fuse(JU.bfs(0)), engine="pallas")
    assert JE.program_cache_stats()["ell_layouts"] == before
    JE.clear_graph_caches(small_graphs["uniform"])
    assert JE.program_cache_stats()["ell_layouts"] == after


# ---------------------------------------------------------------------------
# fuse_many: multi-value pairing
# ---------------------------------------------------------------------------


def test_fuse_many_per_request_answers(small_graphs):
    jg = small_graphs["uniform2"]
    tg = _port(jg)
    keys = ("rad01", "drr23", "rad45")

    def reqs(U):
        return {"rad01": U.radius(0, 1), "drr23": U.drr(2, 3),
                "rad45": U.radius(4, 5)}

    jstats, tstats = JF.FusionStats(), TF.FusionStats()
    jres = JE.run_program(jg, JF.fuse_many(reqs(JU), stats=jstats),
                          engine="pallas")
    tres = TE.run_program(tg, TF.fuse_many(reqs(TU), stats=tstats),
                          engine="cuda", device="cpu")
    assert set(tres.value) == set(keys)
    solo_work = 0.0
    for k, spec in reqs(TU).items():
        solo = TE.run_program(tg, TF.fuse(spec), engine="cuda", device="cpu")
        assert float(tres.value[k]) == float(solo.value)
        _same_value(float(np.asarray(jres.value[k])), float(tres.value[k]))
        solo_work += solo.stats.edge_work
    assert tres.stats.edge_work < solo_work
    assert (tres.stats.iterations, tres.stats.edge_work) == \
        (jres.stats.iterations, jres.stats.edge_work)
    assert tstats.frpair > 0
    assert (tstats.frpair, tstats.fmpair, tstats.fpnest, tstats.fmred) == \
        (jstats.frpair, jstats.fmpair, jstats.fpnest, jstats.fmred)


def test_fuse_many_rejects_non_scalar_and_empty():
    for F, U in ((TF, TU), (JF, JU)):
        with pytest.raises(ValueError, match="at least one"):
            F.fuse_many([])
        with pytest.raises(TypeError, match="single-round scalar"):
            F.fuse_many({"v": U.bfs(0)})
        with pytest.raises(TypeError, match="single-round scalar"):
            F.fuse_many({"lr": U.rds(0, 1)})


def test_fuse_many_single_request_matches_fuse(small_graphs):
    jg = small_graphs["line"]
    tg = _port(jg)
    res = TE.run_program(tg, TF.fuse_many({"r": TU.radius(0, 3)}),
                         engine="cuda", device="cpu")
    solo = TE.run_program(tg, TF.fuse(TU.radius(0, 3)), engine="cuda",
                          device="cpu")
    assert float(res.value["r"]) == float(solo.value)
    jres = JE.run_program(jg, JF.fuse_many({"r": JU.radius(0, 3)}),
                          engine="pallas")
    _same_value(float(np.asarray(jres.value["r"])), float(res.value["r"]))


def test_fuse_many_widest_round_matches_reference(small_graphs):
    """A full scalar round (``max_scalar_fuse`` = 8 radius/drr requests,
    16 distinct sources): every answer, the round's counters and the
    fusion counts equal the reference's."""
    jg = small_graphs["rmat"]
    tg = _port(jg)

    def reqs(U):
        return [(i, (U.radius if i % 2 else U.drr)(2 * i, 2 * i + 1))
                for i in range(8)]

    jstats, tstats = JF.FusionStats(), TF.FusionStats()
    jres = JE.run_program(jg, JF.fuse_many(reqs(JU), stats=jstats),
                          engine="pallas")
    tres = TE.run_program(tg, TF.fuse_many(reqs(TU), stats=tstats),
                          engine="cuda", device="cpu")
    for i in range(8):
        _same_value(float(np.asarray(jres.value[i])), float(tres.value[i]))
    assert (tres.stats.iterations, tres.stats.edge_work) == \
        (jres.stats.iterations, jres.stats.edge_work)
    assert (tstats.frpair, tstats.fmpair) == (jstats.frpair, jstats.fmpair)


# ---------------------------------------------------------------------------
# engine-level batch-join hooks
# ---------------------------------------------------------------------------


def test_batchable_program_classification():
    for F, U, E in ((TF, TU, TE), (JF, JU, JE)):
        assert E.batchable_program(F.fuse(U.bfs(0)))
        assert E.batchable_program(F.fuse(U.sssp(0)))
        assert not E.batchable_program(F.fuse(U.rds(0, 1)))
        assert not E.batchable_program(F.fuse(U.cc()))


def test_chunked_warm_resume_matches_monolithic(small_graphs):
    jg = small_graphs["uniform2"]
    g = _port(jg)
    prog = TF.fuse(TU.sssp(0))
    srcs = [0, 3, 7]
    mono = TE.run_program_batch(g, prog, srcs, device="cpu")
    outs, state = TE.run_program_batch(
        g, prog, srcs, max_iter=2, on_nonconverge="ignore",
        return_state=True, device="cpu")
    guard = 0
    while not all(o.stats.converged for o in outs):
        outs, state = TE.run_program_batch(
            g, prog, srcs, max_iter=2, on_nonconverge="ignore",
            init_state=state, return_state=True, device="cpu")
        guard += 1
        assert guard < 64
    ref = JE.run_program_batch(jg, JF.fuse(JU.sssp(0)), srcs,
                               engine="pallas")
    for m, c, r in zip(mono, outs, ref):
        assert torch.equal(m.value, c.value)
        _same_value(np.asarray(r.value), c.value.numpy())


def test_init_state_requires_cuda_single_round(small_graphs):
    g = _port(small_graphs["uniform"])
    prog = TF.fuse(TU.sssp(0))
    init = TE.batch_init_state(g, prog, [0, 1])
    with pytest.raises(ValueError, match="cuda"):
        TE.run_program_batch(g, prog, [0, 1], engine="pull",
                             init_state=init, device="cpu")
    with pytest.raises(ValueError, match="fallback"):
        TE.run_program_batch(g, prog, [0, 1], engine="cuda",
                             init_state=init, fallback=True, device="cpu")
    multi = TF.fuse(TU.rds(0, 1))
    with pytest.raises(ValueError, match="single"):
        TE.run_program_batch(g, multi, [0, 1], engine="cuda",
                             return_state=True, device="cpu")


# ---------------------------------------------------------------------------
# The port's own: RM-XS serving rows, carried state, devices
# ---------------------------------------------------------------------------


def _bench_rows():
    rows = json.loads(BENCH.read_text())["serving_rows"]
    return [pytest.param(r, id="w" if r["weighted"] else "unw")
            for r in rows]


# launches_traced and exec_entries count JAX traces: not the port's to meet
SERVING_FIELDS = ("completed", "batch_launches", "queries_per_launch",
                  "occupancy", "scalar_rounds", "scalar_fused", "solo_runs",
                  "total_iterations", "v_p50_ms", "v_p99_ms", "v_qps")


def serve_rm_xs(weighted: bool, device="cpu"):
    """The reference bench's serving config on ``rmat_graph(400, 3200,
    seed=11)``: 6 slots, chunks of 4, 16 requests of ``standard_mix``,
    seed 0, at 16 requests per chunk's virtual time."""
    g = TS.rmat_graph(400, 3200, seed=11, weighted=weighted, device=device)
    cfg = TSV.ServiceConfig(max_batch=6, chunk_iters=4, device=device)
    svc = TSV.AnalyticsService(cfg)
    svc.add_graph("RM-XS", g)
    svc.register("BFS", TU.bfs)
    svc.register("SSSP", TU.sssp)
    rate = 16.0 / (cfg.launch_overhead_s + cfg.chunk_iters * cfg.iter_cost_s)
    m = svc.run_open_loop(TSV.open_loop_arrivals(
        16, rate=rate, seed=0, make_request=TSV.standard_mix("RM-XS", g.n)))
    return svc, m


@pytest.mark.parametrize("row", _bench_rows())
def test_rm_xs_serving_rows(row):
    svc, m = serve_rm_xs(row["weighted"])
    assert {k: m[k] for k in SERVING_FIELDS} == \
        {k: row[k] for k in SERVING_FIELDS}
    assert TSV.verify_sequential(svc) == row["requests"]


def test_retired_answer_keeps_its_bits_when_its_slot_is_reused():
    """A short query retires while its batchmate runs on; a late joiner
    takes its slot (fresh init rows spliced into the carried state) and a
    repeat of it joins warm from the memo.  The retired answer and its
    memo row keep their bits through both."""
    g = _port(_skewed_graph())
    svc = _Side(False, g, max_batch=2, chunk_iters=4).svc
    svc.submit("g", TSV.Request(rid=0, kind="SSSP", source=0))
    short = TSV.Request(rid=1, kind="SSSP", source=48)
    svc.submit("g", short)
    assert svc.step() and svc.completed == [short]
    answer = short.value.tobytes()
    memo = [r.clone() for r in svc._retired[("g", "SSSP", 48)]]
    assert isinstance(short.value, np.ndarray)
    svc.submit("g", TSV.Request(rid=2, kind="SSSP", source=52))
    assert svc.step()                  # rid 2 took rid 1's retired slot
    svc.submit("g", TSV.Request(rid=3, kind="SSSP", source=48))
    _drain(svc)
    assert svc.warm_joins == 1
    assert short.value.tobytes() == answer
    assert all(torch.equal(a, b) for a, b in
               zip(memo, svc._retired[("g", "SSSP", 48)]))
    assert TSV.verify_sequential(svc) == 4


def test_lane_state_and_memo_stay_tensors_on_the_graph_device(
        small_graphs, monkeypatch):
    """Every chunk takes and gives its carried state as tensors on the
    graph's device; the memo holds tensors there; the answers are host
    copies."""
    side = _Side(False, _port(small_graphs["uniform2"]), max_batch=3,
                 chunk_iters=2)
    seen = []
    real = TE.run_program_batch

    def spy(g, prog, sources, **kw):
        init = kw.get("init_state")
        outs, state = real(g, prog, sources, **kw)
        seen.append((init, state))
        return outs, state

    monkeypatch.setattr(TE, "run_program_batch", spy)
    _open_loop(side, 14, 6000.0, 5)
    assert len(seen) == side.svc.batch_launches
    assert any(init is not None for init, _ in seen)
    dev = side.g.device
    for init, state in seen:
        for t in (init or ()) + tuple(state):
            assert isinstance(t, torch.Tensor) and t.device == dev
    assert side.svc._retired
    for rows in side.svc._retired.values():
        assert all(isinstance(r, torch.Tensor) and r.device == dev
                   for r in rows)
    for req in side.svc.completed:
        assert isinstance(req.value, (np.ndarray, float))
    assert side.svc.state_bytes()["memo_bytes"] == sum(
        r.numel() * r.element_size() for rows in side.svc._retired.values()
        for r in rows)
    assert TSV.verify_sequential(side.svc) == 14


def test_add_graph_refuses_a_graph_on_another_device(small_graphs):
    svc = TSV.AnalyticsService(TSV.ServiceConfig(device="cpu"))
    g = _port(small_graphs["uniform"])
    svc.add_graph("g", g)
    other = TSV.AnalyticsService(TSV.ServiceConfig(device="meta"))
    with pytest.raises(ValueError, match="lives on cpu"):
        other.add_graph("g", g)


def test_service_config_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSV.ServiceConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSV.AnalyticsService()
    assert TSV.ServiceConfig(device="cpu").device == torch.device("cpu")
