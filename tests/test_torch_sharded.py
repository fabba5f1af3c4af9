"""The sharded engines of the port against the JAX package's.

The counterparts of ``tests/test_pallas_sharded.py`` and
``tests/test_distributed.py`` on the port's ``graph.partition``
(``ShardMesh``, ``partition_edges``), its sharded layouts and resolutions,
``segment.psum_like``, ``engine="cuda_sharded"`` (``ops.iterate_cuda_sharded``)
and ``engine="distributed"`` (``iterate.iterate_distributed``), on the CPU:
k shards on one CPU device (``ShardMesh.on("cpu", k)``), the plain versions
of the kernels, graphs at RM-XS size or below carried across with
``from_arrays``.

- Partitions, per-shard layouts and resolutions: bitwise the reference's
  ``[k, …]`` stacks, shard by shard.
- ``cuda_sharded`` against the reference's single-device ``pallas`` engine
  (Pallas in interpret mode): idempotent rounds bitwise with equal
  iterations and push iterations; float sums (NSP, NWR, PageRank) within
  atol / rtol 1e-5 with equal iterations.
- The sharded counters (``shard_work``, ``cross_combines``,
  ``shard_launches``, ``resolve_work``) equal the reference's
  ``pallas_sharded`` on forced host devices (``distributed`` marker).
- ``distributed`` against the port's ``pull`` engine (the reference's own
  ``distributed`` oracle test fails, ROADMAP Queue 3)."""
import json

import numpy as np
import pytest
import torch

from conftest import run_forced_devices
from repro.core import engine as JE
from repro.core import fusion as JF
from repro.core import iterate as JI
from repro.core import usecases as JU
from repro.graph import partition as JP
from repro.graph import structure as JS
from repro_torch.core import engine as TE
from repro_torch.core import fusion as TF
from repro_torch.core import guard
from repro_torch.core import iterate as TI
from repro_torch.core import usecases as TU
from repro_torch.graph import partition as TP
from repro_torch.graph import segment as TSeg
from repro_torch.graph import structure as TS
from repro_torch.kernels import ops as kops


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    yield
    TE.clear_program_caches()


def _port_graph(jg):
    return TS.from_arrays(jg.n, *jg.host_edges(), device="cpu")


def _mesh(k):
    return TP.ShardMesh.on("cpu", k)


def _stack(parts):
    return np.stack([p.numpy() for p in parts])


def _layout_graphs():
    return {"rmat": JS.rmat_graph(50, 300, seed=2),
            "line": JS.line_graph(4)}       # 3 edges: k = 5 leaves empties


# ---------------------------------------------------------------------------
# Partitions and layouts, bitwise.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["contiguous", "dst_hash"])
@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_sharded_layouts_match_reference(k, strategy):
    """``partition_edges``, both directions' per-shard layouts and the
    per-shard resolutions are the reference's arrays, shard by shard
    (dtypes included; ``row_deg`` is int64 where the reference's is
    float32, equal in value)."""
    for gname, jg in _layout_graphs().items():
        tg = _port_graph(jg)
        jp, tp = JP.partition_edges(jg, k, strategy), \
            TP.partition_edges(tg, k, strategy)
        assert tp.k == jp.k and tp.e_pad == jp.e_pad
        for f in ("src", "dst", "weight", "capacity", "mask"):
            a, b = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), (gname, f)
        for direction in ("in", "out"):
            je = JS.to_sharded_ell(jg, k, strategy, direction=direction)
            te = TS.to_sharded_ell(tg, k, strategy, direction=direction)
            assert (te.k, te.n_pad, te.width, te.num_edges) == \
                (je.k, je.n_pad, je.width, je.num_edges)
            for f in ("nbrs", "weight", "capacity", "mask", "tile_nnz"):
                a, b = np.asarray(getattr(je, f)), _stack(getattr(te, f))
                assert a.dtype == b.dtype and np.array_equal(a, b), \
                    (gname, direction, f)
            assert np.array_equal(np.asarray(je.row_deg),
                                  _stack(te.row_deg).astype(np.float32))
            assert all(r.dtype == torch.int64 for r in te.row_deg)
        jr = JS.to_sharded_push_resolution(jg, k, strategy)
        tr = TS.to_sharded_push_resolution(tg, k, strategy)
        assert (tr.width, tr.out_width) == (jr.width, jr.out_width)
        for f in ("in2out", "valid", "src_tile", "tile_nnz", "contrib"):
            a, b = np.asarray(getattr(jr, f)), _stack(getattr(tr, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), (gname, f)
        if gname == "line" and k == 5:
            per_shard = _stack(te.mask).sum(axis=(1, 2))
            assert (per_shard == 0).sum() == 2
            assert (_stack(te.tile_nnz)[per_shard == 0] == 0).all()


def test_shard_mesh_and_devices():
    """``ShardMesh`` repeats a device, mirrors a mesh's one data axis, and
    places shard j's layouts on ``devices[j]``; a mesh over another device
    count or axis is refused."""
    mesh = TP.ShardMesh.on("cpu", 3)
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.axis_names == ("data",) and mesh.shape == {"data": 3}
    assert mesh.device_count == 3 and TP.mesh_shards(mesh, "data") == 3
    with pytest.raises(ValueError, match="not axes of the mesh"):
        TP.mesh_shards(mesh, ("model",))
    with pytest.raises(ValueError, match="k >= 1"):
        TP.ShardMesh.on("cpu", 0)
    with pytest.raises(TypeError, match="ShardMesh"):
        TP.check_mesh(object())
    tg = _port_graph(JS.rmat_graph(50, 300, seed=2))
    ell = TS.to_sharded_ell(tg, 3, devices=mesh.devices)
    assert all(s.nbrs.device == torch.device("cpu") for s in ell.shards)
    with pytest.raises(ValueError, match="2 devices for 3 shards"):
        TS.to_sharded_ell(tg, 3, devices=mesh.devices[:2])


# ---------------------------------------------------------------------------
# psum_like and the replication check.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["min", "max", "sum", "prod", "or", "and"])
def test_psum_like_folds_in_shard_order(op):
    """``psum_like`` is ``segment.combine`` folded over the shards in order
    0…k−1 (``or`` / ``and`` as int32 max / min), handed back once per
    shard; a float sum keeps that order's bits."""
    rng = np.random.default_rng(5)
    k, n = 4, 33
    if op in ("or", "and"):
        parts = [torch.from_numpy(rng.random(n) < 0.4) for _ in range(k)]
    else:
        parts = [torch.from_numpy(rng.normal(size=n).astype(np.float32))
                 for _ in range(k)]
    out = TSeg.psum_like(op, parts, _mesh(k))
    assert len(out) == k
    want = parts[0]
    for p in parts[1:]:
        if op in ("or", "and"):
            want = TSeg.combine("max" if op == "or" else "min",
                                want.to(torch.int32), p.to(torch.int32)) \
                .to(torch.bool)
        else:
            want = TSeg.combine(op, want, p)
    for o in out:
        assert o.dtype == parts[0].dtype
        assert torch.equal(o, want)
    with pytest.raises(ValueError, match="unknown reduction"):
        TSeg.psum_like("mean", parts, _mesh(k))


def test_check_shard_replication_message():
    """The reference's message: per-shard values, the majority and the
    offending shard ids."""
    TI.check_shard_replication([3, 3, 3], "iteration count", "cuda_sharded")
    with pytest.raises(RuntimeError) as port:
        TI.check_shard_replication([4, 4, 5, 4], "iteration count",
                                   "cuda_sharded")
    with pytest.raises(RuntimeError) as ref:
        JI.check_shard_replication(np.array([4, 4, 5, 4]),
                                   "iteration count", "cuda_sharded")
    assert str(port.value) == str(ref.value)
    assert "offending shard ids [2]" in str(port.value)


# ---------------------------------------------------------------------------
# cuda_sharded against the reference's single-device pallas engine.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["contiguous", "dst_hash"])
@pytest.mark.parametrize("name", ["BFS", "SSSP"])
def test_cuda_sharded_idempotent_bitwise(name, strategy, small_graphs):
    """BFS and SSSP, k ∈ {2, 4}, model None / pull / push: the reference's
    single-device bits, iterations and push iterations (the global
    direction switch takes the same sequence)."""
    for gname in ("uniform", "rmat"):
        jg = small_graphs[gname]
        tg = _port_graph(jg)
        for model in (None, "pull", "push"):
            r1 = JE.run_program(jg, JF.fuse(JU.ALL_SPECS[name]()),
                                engine="pallas", model=model)
            for k in (2, 4):
                rs = TE.run_program(tg, TF.fuse(TU.ALL_SPECS[name]()),
                                    engine="cuda_sharded", mesh=_mesh(k),
                                    model=model, shard_strategy=strategy,
                                    device="cpu")
                label = f"{gname}/{model}/k{k}"
                assert np.array_equal(np.asarray(r1.value),
                                      rs.value.numpy()), label
                assert rs.stats.iterations == r1.stats.iterations, label
                assert rs.stats.push_iters == r1.stats.push_iters, label
                assert rs.stats.shards == k and \
                    len(rs.stats.shard_work) == k, label
                assert sum(rs.stats.shard_work) == rs.stats.edge_work
                assert rs.stats.engine_used == "cuda_sharded"
                assert rs.stats.plan.shard_strategy == strategy


def _allclose(a, b):
    return np.allclose(np.nan_to_num(np.asarray(a, np.float64)),
                       np.nan_to_num(np.asarray(b, np.float64)),
                       atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("strategy", ["contiguous", "dst_hash"])
def test_cuda_sharded_float_sums_allclose(strategy, small_graphs):
    """NSP and NWR (pull− with has-pred) and direct PageRank: the shards'
    float partials fold in shard order, so within atol / rtol 1e-5 of the
    reference's single-device answer, with equal iterations."""
    jg = small_graphs["uniform2"]
    tg = _port_graph(jg)
    for name in ("NSP", "NWR"):
        r1 = JE.run_program(jg, JF.fuse(JU.ALL_SPECS[name]()),
                            engine="pallas")
        for k in (2, 4):
            rs = TE.run_program(tg, TF.fuse(TU.ALL_SPECS[name]()),
                                engine="cuda_sharded", mesh=_mesh(k),
                                shard_strategy=strategy, device="cpu")
            assert _allclose(r1.value, rs.value.numpy()), (name, k)
            assert rs.stats.iterations == r1.stats.iterations, (name, k)
    r1 = JE.run_direct(jg, JU.handwritten_pagerank(jg.n), engine="pallas")
    for k in (2, 4):
        rs = TE.run_direct(tg, TU.handwritten_pagerank(tg.n),
                           engine="cuda_sharded", mesh=_mesh(k),
                           shard_strategy=strategy, device="cpu")
        assert _allclose(r1.value, rs.value.numpy()), k
        assert rs.stats.iterations == r1.stats.iterations, k
        assert rs.stats.cross_combines == 2 * rs.stats.iterations


def test_cuda_sharded_k1_matches_cuda_bitwise(small_graphs):
    """A one-shard mesh is the single-device cuda engine: bits and every
    counter."""
    tg = _port_graph(small_graphs["uniform"])
    for name in ("BFS", "SSSP", "NSP", "WSP"):
        prog = TF.fuse(TU.ALL_SPECS[name]())
        r1 = TE.run_program(tg, prog, engine="cuda", device="cpu")
        rs = TE.run_program(tg, prog, engine="cuda_sharded", mesh=_mesh(1),
                            device="cpu")
        assert torch.equal(r1.value, rs.value), name
        for f in ("iterations", "push_iters", "pull_iters", "edge_work",
                  "resolve_work", "gather_work"):
            assert getattr(rs.stats, f) == getattr(r1.stats, f), (name, f)
        assert rs.stats.shards == 1 and \
            rs.stats.shard_work == (r1.stats.edge_work,)


def test_cuda_sharded_empty_shards(small_graphs):
    """k = 5 on a 3-edge line graph: two all-padding shards sweep nothing
    and the answer is the single-device one's, pushing and pulling."""
    jg = JS.line_graph(4)
    tg = _port_graph(jg)
    for model in (None, "pull", "push"):
        r1 = JE.run_program(jg, JF.fuse(JU.bfs(0)), engine="pallas",
                            model=model)
        rs = TE.run_program(tg, TF.fuse(TU.bfs(0)), engine="cuda_sharded",
                            mesh=_mesh(5), model=model, device="cpu")
        assert np.array_equal(np.asarray(r1.value), rs.value.numpy())
        assert rs.stats.iterations == r1.stats.iterations
        assert rs.stats.push_iters == r1.stats.push_iters
        assert sorted(rs.stats.shard_work)[:2] == [0, 0]


_REF_STATS = """
    import numpy as np, jax, json
    from jax.sharding import Mesh
    from repro.graph.structure import uniform_graph, rmat_graph
    from repro.core import usecases as U, fusion, engine
    graphs = {'uniform': uniform_graph(9, 18, seed=3),
              'rmat': rmat_graph(16, 48, seed=5)}
    out = {}
    for gname, g in graphs.items():
        for name, models in (('BFS', (None, 'push')), ('SSSP', (None,)),
                             ('NSP', (None,))):
            prog = fusion.fuse(U.ALL_SPECS[name]())
            for k in (2, 4):
                mesh = Mesh(np.asarray(jax.devices()[:k]), ('data',))
                for model in models:
                    st = engine.run_program(g, prog, engine='pallas_sharded',
                                            mesh=mesh, model=model).stats
                    out[f'{gname}/{name}/k{k}/{model}'] = [
                        st.iterations, st.push_iters, list(st.shard_work),
                        st.cross_combines, st.shard_launches,
                        st.resolve_work, st.gather_work, st.shards]
    print(json.dumps(out))
"""


@pytest.mark.distributed
def test_cuda_sharded_counters_match_reference_sharded(small_graphs):
    """``shard_work``, ``cross_combines``, ``shard_launches`` and the
    resolve / gather work of the port's sharded queries equal the
    reference's ``pallas_sharded`` run on 4 forced host devices."""
    ref = json.loads(run_forced_devices(_REF_STATS, 4).strip()
                     .splitlines()[-1])
    assert len(ref) == 16
    for key, want in ref.items():
        gname, name, k, model = key.split("/")
        k = int(k[1:])
        model = None if model == "None" else model
        tg = _port_graph(small_graphs[gname])
        st = TE.run_program(tg, TF.fuse(TU.ALL_SPECS[name]()),
                            engine="cuda_sharded", mesh=_mesh(k),
                            model=model, device="cpu").stats
        got = [st.iterations, st.push_iters, list(st.shard_work),
               st.cross_combines, st.shard_launches, st.resolve_work,
               st.gather_work, st.shards]
        assert got == want, key


# ---------------------------------------------------------------------------
# The distributed engine against the port's pull engine.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 4])
def test_distributed_matches_pull(k, small_graphs):
    """BFS, SSSP and WP bitwise with the pull engine's iterations and edge
    work (summed over the shards); PageRank within atol / rtol 1e-5 with
    equal iterations."""
    for gname in ("uniform", "uniform2"):
        tg = _port_graph(small_graphs[gname])
        for name in ("BFS", "SSSP", "WP"):
            prog = TF.fuse(TU.ALL_SPECS[name]())
            rp = TE.run_program(tg, prog, engine="pull", device="cpu")
            rd = TE.run_program(tg, prog, engine="distributed",
                                mesh=_mesh(k), device="cpu")
            assert torch.equal(rp.value, rd.value), (gname, name)
            assert rd.stats.iterations == rp.stats.iterations
            assert rd.stats.edge_work == rp.stats.edge_work
            assert rd.stats.shards == k and \
                sum(rd.stats.shard_work) == rd.stats.edge_work
        dk = TU.handwritten_pagerank(tg.n)
        rp = TE.run_direct(tg, dk, engine="pull", device="cpu")
        rd = TE.run_direct(tg, dk, engine="distributed", mesh=_mesh(k),
                           device="cpu")
        assert torch.allclose(rp.value, rd.value, atol=1e-5, rtol=1e-5)
        assert rd.stats.iterations == rp.stats.iterations


# ---------------------------------------------------------------------------
# Planner, knobs, caches and the fallback chain.
# ---------------------------------------------------------------------------


def test_sharded_knob_validation(small_graphs):
    tg = _port_graph(small_graphs["uniform"])
    prog = TF.fuse(TU.bfs(0))
    mesh = _mesh(2)
    with pytest.raises(ValueError, match="push_resolution"):
        TE.run_program(tg, prog, engine="cuda_sharded", mesh=mesh,
                       push_resolution="radix", device="cpu")
    with pytest.raises(ValueError, match="strategy"):
        TE.run_program(tg, prog, engine="cuda_sharded", mesh=mesh,
                       shard_strategy="nope", device="cpu")
    for eng in ("cuda_sharded", "distributed"):
        with pytest.raises(AssertionError, match="mesh"):
            TE.run_program(tg, prog, engine=eng, device="cpu")
    for bad in (object(), [torch.device("cpu")] * 2):
        with pytest.raises(TypeError, match="ShardMesh"):
            TE.run_program(tg, prog, engine="cuda_sharded", mesh=bad,
                           device="cpu")
    with pytest.raises(ValueError, match="strategy"):
        kops.iterate_cuda_sharded(tg, [], [], mesh, strategy="nope")
    with pytest.raises(ValueError, match="init_state"):
        TE.run_program(tg, prog, engine="cuda_sharded", mesh=mesh,
                       init_state=(np.zeros(tg.n, np.int32),), device="cpu")
    # both resolutions run the sharded engine and agree
    rs = TE.run_program(tg, prog, engine="cuda_sharded", mesh=mesh,
                        model="push", push_resolution="sorted", device="cpu")
    rc = TE.run_program(tg, prog, engine="cuda_sharded", mesh=mesh,
                        model="push", push_resolution="scatter",
                        device="cpu")
    assert torch.equal(rs.value, rc.value)
    assert 0 < rs.stats.resolve_work == rs.stats.gather_work
    assert rc.stats.gather_work == 0 and \
        rc.stats.resolve_work > rs.stats.resolve_work


def test_auto_picks_cuda_sharded_on_a_mesh(small_graphs):
    tg = _port_graph(small_graphs["uniform"])
    prog = TF.fuse(TU.bfs(0))
    ex = TE.run_program(tg, prog, engine="auto", mesh=_mesh(4),
                        device="cpu", explain=True)
    assert ex.plan.engine == "cuda_sharded"
    assert ex.decisions["engine"] == \
        "auto: mesh with 4 devices → shard-local fused sweeps"
    assert TE.run_program(tg, prog, engine="auto", mesh=_mesh(1),
                          device="cpu", explain=True).plan.engine == "cuda"
    r = TE.run_program(tg, prog, engine="auto", mesh=_mesh(4),
                       shard_strategy="dst_hash", device="cpu")
    assert r.stats.engine_used == "cuda_sharded" and r.stats.shards == 4
    plan = r.stats.plan
    assert plan.shard_strategy == "dst_hash" and plan.axes == ("data",)
    down = TE._plan.degrade_plan(plan, "cuda")
    assert down.engine == "cuda" and down.shard_strategy == "contiguous"


@pytest.mark.parametrize("engine", ["cuda_sharded", "distributed"])
def test_sharded_batches_run_sequentially(engine, small_graphs):
    """``run_direct(sources=…)`` and ``run_program_batch`` on a sharded
    engine run one solo query per source, each with the batch
    degradation event, each equal to its solo query."""
    tg = _port_graph(small_graphs["rmat"])
    mesh = _mesh(2)
    dk = TU.handwritten_sssp(0)
    outs = TE.run_direct(tg, dk, engine=engine, mesh=mesh, sources=[0, 3],
                         device="cpu")
    ev = guard.batch_degradation(engine, 2).as_tuple()
    for s, o in zip([0, 3], outs):
        solo = TE.run_direct(tg, dk, engine=engine, mesh=mesh, source=s,
                             device="cpu")
        assert torch.equal(o.value, solo.value)
        assert o.stats.fallbacks == (ev,)
        assert o.stats.plan.batch_lane == "sequential"
    outs = TE.run_program_batch(tg, TF.fuse(TU.bfs(0)), [1, 2],
                                engine=engine, mesh=mesh, device="cpu")
    assert [o.stats.fallbacks for o in outs] == [(ev,), (ev,)]
    assert all(o.stats.shards == 2 for o in outs)


def test_sharded_cache_stats_and_clear(small_graphs):
    g1 = _port_graph(small_graphs["uniform2"])
    g2 = _port_graph(small_graphs["uniform"])
    a = TS.sharded_ell_cached(g1, 2, direction="in")
    assert TS.sharded_ell_cached(g1, 2, direction="in") is a
    assert TS.sharded_ell_cached(g1, 2, direction="out") is not a
    r = TS.sharded_push_resolution_cached(g1, 2)
    assert TS.sharded_push_resolution_cached(g1, 2) is r
    assert TS.sharded_push_resolution_cached(g1, 3) is not r
    TS.sharded_push_resolution_cached(g2, 2)
    stats = TE.program_cache_stats()
    assert stats["sharded_layouts"] == 2
    assert stats["sharded_resolutions"] == 3
    assert TE.clear_graph_caches(g1) >= 4
    stats = TE.program_cache_stats()
    assert stats["sharded_layouts"] == 0
    assert stats["sharded_resolutions"] == 1         # g2's survives
    TE.clear_program_caches()
    assert TE.program_cache_stats()["sharded_resolutions"] == 0


def test_cuda_sharded_falls_back_to_cuda(monkeypatch, small_graphs):
    """``cuda_sharded → cuda``: a recoverable failure of the sharded engine
    ends on ``cuda`` with one event and the cuda answer; a kernel launch
    fault, and any failure inside the sharded loop (raised as one),
    propagate with ``fallback=True``."""
    tg = _port_graph(small_graphs["rmat"])
    prog = TF.fuse(TU.sssp(0))
    want = TE.run_program(tg, prog, engine="cuda", device="cpu")

    def raising(exc):
        def fn(*a, **kw):
            raise exc
        return fn

    monkeypatch.setattr(kops, "iterate_cuda_sharded",
                        raising(RuntimeError("transient")))
    r = TE.run_program(tg, prog, engine="cuda_sharded", mesh=_mesh(2),
                       fallback=True, device="cpu")
    assert r.stats.engine_used == "cuda"
    assert r.stats.fallbacks == (("cuda_sharded", "cuda",
                                  "RuntimeError: transient"),)
    assert torch.equal(r.value, want.value)
    monkeypatch.setattr(kops, "iterate_cuda_sharded", raising(
        guard.KernelLaunchError("CUDA pull kernel launch failed")))
    with pytest.raises(guard.KernelLaunchError):
        TE.run_program(tg, prog, engine="cuda_sharded", mesh=_mesh(2),
                       fallback=True, device="cpu")
    monkeypatch.undo()
    monkeypatch.setattr(kops, "_shard_sweep",
                        raising(RuntimeError("inside the loop")))
    with pytest.raises(guard.KernelLaunchError, match="inside the loop"):
        TE.run_program(tg, prog, engine="cuda_sharded", mesh=_mesh(2),
                       fallback=True, device="cpu")
