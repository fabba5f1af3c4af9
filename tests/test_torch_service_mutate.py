"""The analytics service under graph mutation and adaptive planning, and
its ``analytics`` driver: the port against the JAX package's.

The counterparts of ``tests/test_incremental.py``'s three service tests
(at its ``uniform_graph(32, 160, seed=3)``) and of
``tests/test_planner.py::test_service_adaptive_serving_stays_bitwise``,
each run on both packages (the port on ``engine="cuda"``,
``device="cpu"``; the reference on ``pallas`` in interpret mode) with the
same edits and traces: equal ``metrics()`` but ``wall_*``, completion
order, per-request scheduling fields and bitwise answers, each answer also
bitwise a solo query on the graph that served it.  Then
``python -m repro_torch.launch.analytics --smoke --device cpu`` exits 0
with the reference ``run_smoke``'s metrics (``--dryrun`` is held in
``tests/test_torch_dryrun.py``).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import engine as JE
from repro.core import usecases as JU
from repro.graph import structure as JS
from repro.launch import service as JSV
from repro_torch.core import engine as TE
from repro_torch.core import fusion as TF
from repro_torch.core import usecases as TU
from repro_torch.graph import structure as TS
from repro_torch.launch import service as TSV

pytestmark = pytest.mark.service

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("rid", "lane", "iterations", "chunks", "joined_launch", "arrival",
          "completed")


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    yield
    TE.clear_program_caches()


@pytest.fixture
def g():
    return JS.uniform_graph(32, 160, seed=3, weighted=True)


def _port(jg):
    return TS.from_arrays(jg.n, *jg.host_edges(), device="cpu")


def _services(jg, kinds=("BFS",), **kw):
    """(reference, port) services over ``jg`` and its port."""
    out = []
    for S, U, cfg, gg in (
            (JSV, JU, dict(engine="pallas"), jg),
            (TSV, TU, dict(device="cpu"), _port(jg))):
        svc = S.AnalyticsService(S.ServiceConfig(**cfg, **kw))
        svc.add_graph("g", gg)
        for kind in kinds:
            svc.register(kind, getattr(U, kind.lower()))
        out.append((S, svc))
    return out


def _drain(svc, limit=10_000):
    steps = 0
    while svc.step():
        steps += 1
        assert steps < limit, "service failed to drain"


def _no_wall(m):
    return {k: v for k, v in m.items() if not k.startswith("wall")}


def _same_service(jsvc, tsvc):
    assert _no_wall(tsvc.metrics()) == _no_wall(jsvc.metrics())
    assert [r.rid for r in tsvc.completed] == [r.rid for r in jsvc.completed]
    for jr, tr in zip(jsvc.completed, tsvc.completed):
        assert tuple(getattr(tr, f) for f in FIELDS) == \
            tuple(getattr(jr, f) for f in FIELDS), jr.rid
        if isinstance(jr.value, float):
            assert isinstance(tr.value, float)
            assert np.float64(tr.value).tobytes() == \
                np.float64(jr.value).tobytes()
        else:
            want = np.asarray(jr.value)
            assert (tr.value.dtype, tr.value.shape) == (want.dtype,
                                                        want.shape)
            assert tr.value.tobytes() == want.tobytes()


def _solo_bits(tg, req):
    return TE.run_program(tg, TF.fuse(TU.bfs(0)), engine="cuda",
                          source=req.source, device="cpu").value.numpy() \
        .tobytes()


def test_service_mutate_drains_patches_and_warm_joins(g):
    (JS_, jsvc), (TS_, tsvc) = _services(g, max_batch=4, chunk_iters=3)
    mds = []
    for S, svc in ((JS_, jsvc), (TS_, tsvc)):
        for i in range(3):
            svc.submit("g", S.Request(rid=i, kind="BFS", source=i))
        _drain(svc)
        for i, s in enumerate((0, 1, 9)):
            svc.submit("g", S.Request(rid=10 + i, kind="BFS", source=s))
        md = svc.mutate_graph("g", insert=([2, 4], [6, 8], [0.5, 0.5]))
        assert md.inserted == 2 and md.patched_layouts >= 1
        mds.append((md.inserted, md.patched_layouts, md.rebuilt_layouts))
        _drain(svc)
        m = svc.metrics()
        assert m["completed"] == 6 and m["mutations"] == 1
        assert m["patched_layouts"] >= 1 and m["rebuilt_layouts"] == 0
        assert m["warm_joins"] >= 2
    assert mds[0] == mds[1]
    _same_service(jsvc, tsvc)
    # every port answer is a solo query's on the graph that served it
    new = tsvc.graphs["g"]
    old_port = _port(g)
    for req in tsvc.completed:
        served_on = old_port if req.rid < 10 else new
        assert req.value.tobytes() == _solo_bits(served_on, req), req.rid


def test_service_deletes_invalidate_retired_memo(g):
    (JS_, jsvc), (TS_, tsvc) = _services(g, max_batch=4, chunk_iters=3)
    src, dst, _w, _c = g.host_edges()
    for S, svc in ((JS_, jsvc), (TS_, tsvc)):
        svc.submit("g", S.Request(rid=0, kind="BFS", source=0))
        _drain(svc)
        assert len(svc._retired) == 1
        md = svc.mutate_graph("g", delete=(src[:1], dst[:1]))
        assert md.has_deletes
        assert len(svc._retired) == 0
        svc.submit("g", S.Request(rid=1, kind="BFS", source=0))
        _drain(svc)
        assert svc.metrics()["warm_joins"] == 0
    _same_service(jsvc, tsvc)
    req = tsvc.completed[-1]
    assert req.value.tobytes() == _solo_bits(tsvc.graphs["g"], req)


def test_service_mutate_unknown_graph_raises(g):
    for _S, svc in _services(g, max_batch=4, chunk_iters=3):
        with pytest.raises(KeyError, match="not resident"):
            svc.mutate_graph("nope", insert=([0], [1]))


def test_service_adaptive_serving_stays_bitwise():
    jg = JS.uniform_graph(16, 48, seed=5, weighted=True)
    pair = _services(jg, kinds=("BFS", "SSSP"), max_batch=4, chunk_iters=3,
                     adaptive=True)
    for (S, svc), E in zip(pair, (JE, TE)):
        arrivals = S.open_loop_arrivals(
            24, rate=800.0, seed=11,
            make_request=S.standard_mix("g", jg.n))
        svc.run_open_loop(arrivals)
        assert S.verify_sequential(svc) == 24
        assert E.program_cache_stats()["feedback"] >= 1
    _same_service(pair[0][1], pair[1][1])


# ---------------------------------------------------------------------------
# The analytics driver
# ---------------------------------------------------------------------------


def test_analytics_smoke_on_cpu_matches_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.analytics", "--smoke",
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    text = out.stdout
    start = text.index("[analytics --smoke] {") + len("[analytics --smoke] ")
    port = json.JSONDecoder().raw_decode(text[start:])[0]
    from repro.launch import analytics as JA
    ref = JA.run_smoke(verbose=False)
    assert _no_wall(port) == _no_wall(ref)
    assert port["verified_bitwise"] == 24

