"""Batched queries of the port against the JAX package's.

The counterparts of ``tests/test_batched_queries.py``, the batch-join tests
of ``tests/test_analytics_service.py`` and the batched degradation of
``tests/test_checkpointed_fixpoint.py`` on the port's
``run_program_batch`` / ``run_direct(sources=…)`` with ``engine="cuda"``
on the CPU (the plain versions of the kernels), at RM-XS size or below:
the suite's ``small_graphs`` and ``line_graph(48, weighted=True, seed=3)``,
carried across with ``from_arrays``.  Against the reference's
``run_program_batch(engine="pallas")`` (Pallas in interpret mode) the
values are bitwise equal (bytes, so NaN equals NaN) with every per-query
counter equal: iterations, push and pull iterations, edge, resolve and
gather work.  Inside the port a batch equals its solo queries bitwise
with the same counters, one sweep call per direction per iteration."""
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core import fusion as JF
from repro.core import usecases as JU
from repro.graph.structure import line_graph
from repro_torch.core import engine as TE
from repro_torch.core import fusion as TF
from repro_torch.core import guard
from repro_torch.core import usecases as TU
from repro_torch.graph import structure as TS
from repro_torch.kernels import edge_reduce as TER
from repro_torch.kernels import ops as kops

BATCHABLE = ["BFS", "SSSP", "WP"]


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    yield
    TE.clear_program_caches()


def _port_graph(jg):
    return TS.from_arrays(jg.n, *jg.host_edges(), device="cpu")


def _sources(n, k, seed):
    rng = np.random.default_rng(seed)
    return [int(s) for s in rng.choice(n, size=min(k, n), replace=False)]


def _bytes(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x) \
        .tobytes()


def _counters(s):
    return (s.iterations, s.push_iters, s.pull_iters, int(s.edge_work),
            int(s.resolve_work), int(s.gather_work))


def _assert_same(port, ref, label):
    assert len(port) == len(ref)
    for i, (p, r) in enumerate(zip(port, ref)):
        assert _bytes(p.value) == _bytes(r.value), f"{label} query {i}"
        assert _counters(p.stats) == _counters(r.stats), f"{label} query {i}"


def _both(jg, name, srcs, **kw):
    """The port's and the reference's batch of one use case."""
    port = TE.run_program_batch(_port_graph(jg),
                                TF.fuse(TU.ALL_SPECS[name]()), srcs,
                                engine="cuda", device="cpu", **kw)
    ref = JE.run_program_batch(jg, JF.fuse(JU.ALL_SPECS[name]()), srcs,
                               engine="pallas", **kw)
    return port, ref


@pytest.mark.parametrize("model", [None, "pull", "push"])
@pytest.mark.parametrize("name", BATCHABLE)
def test_batch_matches_reference_batch(name, model, small_graphs):
    jg = small_graphs["rmat"]
    srcs = _sources(jg.n, 6, seed=11)
    port, ref = _both(jg, name, srcs, model=model)
    _assert_same(port, ref, f"{name} model={model}")
    for p in port:
        assert p.stats.engine_used == "cuda" and p.stats.fallbacks == ()
        assert p.stats.plan.batch_lane == "vmapped"
        assert p.stats.plan.batch_size == len(srcs)


def test_batch_direction_switch_matches_reference():
    """BFS depth on a line graph, whose frontier goes sparse: queries take
    push iterations at different times, each as its solo query does."""
    jg = line_graph(48, weighted=True, seed=3)
    tg = _port_graph(jg)
    srcs = [0, 7, 23, 40]
    port = TE.run_program_batch(tg, TF.fuse(TU.bfs_depth(0)), srcs,
                                device="cpu")
    ref = JE.run_program_batch(jg, JF.fuse(JU.bfs_depth(0)), srcs,
                               engine="pallas")
    _assert_same(port, ref, "line BFS depth")
    solo = [TE.run_program(tg, TF.fuse(TU.bfs_depth(0)), engine="cuda",
                           source=s, device="cpu") for s in srcs]
    _assert_same(port, solo, "line BFS depth solo")
    assert any(p.stats.push_iters > 0 for p in port)
    assert len({p.stats.push_iters for p in port}) > 1


@pytest.mark.parametrize("name", ["NWR", "NSP", "CC", "WSP"])
def test_batch_other_rounds_match_reference(name, small_graphs):
    """NWR (two prims, NaN where unreachable: compared as bytes), NSP (the
    non-idempotent pull− with has-pred), CC (sourceless: every slot the
    same query) and WSP (a two-level lex)."""
    jg = small_graphs["rmat"]
    if name == "CC":
        from repro.graph.structure import undirected
        jg = undirected(jg)
    srcs = _sources(jg.n, 5, seed=4)
    port, ref = _both(jg, name, srcs)
    _assert_same(port, ref, name)
    if name == "NWR":
        assert any(np.isnan(p.value.numpy()).any() for p in port)


@pytest.mark.parametrize("resolution", ["sorted", "scatter"])
@pytest.mark.parametrize("name", ["BFS", "WSP", "NSP"])
def test_batch_matches_port_solo(name, resolution, small_graphs):
    """Batched ≡ solo inside the port, bitwise with every counter, under
    both push resolutions and every direction."""
    tg = _port_graph(small_graphs["uniform2"])
    prog = TF.fuse(TU.ALL_SPECS[name]())
    srcs = _sources(tg.n, 5, seed=2)
    for model in (None, "pull", "push"):
        batch = TE.run_program_batch(tg, prog, srcs, model=model,
                                     push_resolution=resolution,
                                     device="cpu")
        solo = [TE.run_program(tg, prog, engine="cuda", model=model,
                               source=s, push_resolution=resolution,
                               device="cpu") for s in srcs]
        _assert_same(batch, solo, f"{name} {model} {resolution}")


def _counting(monkeypatch, name):
    calls = []
    real = getattr(TER, name)

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(TER, name, counted)
    return calls


def test_one_sweep_call_per_direction_per_iteration(monkeypatch):
    """Each iteration calls each sweep wrapper at most once for the whole
    batch, and the batch calls them fewer times than its solo queries."""
    jg = line_graph(48, weighted=True, seed=3)
    tg = _port_graph(jg)
    prog = TF.fuse(TU.bfs_depth(0))
    srcs = [0, 7, 23, 40]
    names = ("pull_sweep_frontier", "push_sweep", "resolve_sweep")
    solo_calls = {nm: _counting(monkeypatch, nm) for nm in names}
    solo = [TE.run_program(tg, prog, engine="cuda", source=s, device="cpu")
            for s in srcs]
    monkeypatch.undo()
    calls = {nm: _counting(monkeypatch, nm) for nm in names}
    batch = TE.run_program_batch(tg, prog, srcs, device="cpu")
    iters = max(b.stats.iterations for b in batch)
    for nm in names:
        assert 0 < len(calls[nm]) <= iters, nm
        assert len(calls[nm]) < len(solo_calls[nm]), nm
    assert len(calls["push_sweep"]) == len(calls["resolve_sweep"])
    _assert_same(batch, solo, "counted")


def test_chunked_warm_resume_matches_monolithic(small_graphs):
    """``test_analytics_service.py``'s chunk loop: SSSP in chunks of 2
    iterations through ``return_state`` / ``init_state`` ends on the whole
    batch's bits, in the port and against the reference."""
    jg = small_graphs["uniform2"]
    tg = _port_graph(jg)
    prog = TF.fuse(TU.sssp(0))
    srcs = [0, 3, 7]
    mono = TE.run_program_batch(tg, prog, srcs, engine="cuda", device="cpu")
    outs, state = TE.run_program_batch(
        tg, prog, srcs, engine="cuda", max_iter=2, on_nonconverge="ignore",
        return_state=True, device="cpu")
    assert all(s.shape == (len(srcs), tg.n) for s in state)
    rounds = 0
    while not all(o.stats.converged for o in outs):
        outs, state = TE.run_program_batch(
            tg, prog, srcs, engine="cuda", max_iter=2,
            on_nonconverge="ignore", init_state=state, return_state=True,
            device="cpu")
        rounds += 1
        assert rounds < 64
    ref = JE.run_program_batch(jg, JF.fuse(JU.sssp(0)), srcs,
                               engine="pallas")
    for m, c, r in zip(mono, outs, ref):
        assert _bytes(m.value) == _bytes(c.value) == _bytes(r.value)


def test_retired_slot_takes_a_fresh_row(small_graphs):
    """Continuous batching: a converged slot is retired and a new query
    takes it with a ``batch_init_state`` row; its answer is its solo
    query's."""
    tg = _port_graph(small_graphs["rmat"])
    prog = TF.fuse(TU.sssp(0))
    srcs = [1, 4]
    queue = [9, 12, 2]
    answers = {}
    outs, state = TE.run_program_batch(
        tg, prog, srcs, max_iter=2, on_nonconverge="ignore",
        return_state=True, device="cpu")
    for _ in range(64):
        rows = list(state)
        for b, o in enumerate(outs):
            if o.stats.converged and srcs[b] not in answers:
                answers[srcs[b]] = o.value.clone()
                if queue:
                    srcs[b] = queue.pop(0)
                    fresh = TE.batch_init_state(tg, prog, [srcs[b]])
                    for r, f in zip(rows, fresh):
                        r[b] = f[0]
        if len(answers) == 5:
            break
        outs, state = TE.run_program_batch(
            tg, prog, srcs, max_iter=2, on_nonconverge="ignore",
            init_state=tuple(rows), return_state=True, device="cpu")
    assert sorted(answers) == [1, 2, 4, 9, 12]
    for s, got in answers.items():
        want = TE.run_program(tg, prog, engine="cuda", source=s,
                              device="cpu").value
        assert _bytes(got) == _bytes(want), s


def test_init_state_requires_cuda_single_round(small_graphs):
    tg = _port_graph(small_graphs["uniform"])
    prog = TF.fuse(TU.sssp(0))
    init = TE.batch_init_state(tg, prog, [0, 1])
    with pytest.raises(ValueError, match="cuda"):
        TE.run_program_batch(tg, prog, [0, 1], engine="pull",
                             init_state=init, device="cpu")
    with pytest.raises(ValueError, match="fallback"):
        TE.run_program_batch(tg, prog, [0, 1], engine="cuda",
                             init_state=init, fallback=True, device="cpu")
    multi = TF.fuse(TU.rds(0, 1))
    with pytest.raises(ValueError, match="single"):
        TE.run_program_batch(tg, multi, [0, 1], engine="cuda",
                             return_state=True, device="cpu")
    with pytest.raises(ValueError, match="expected \\(2, "):
        TE.run_program_batch(tg, prog, [0, 1], engine="cuda",
                             init_state=tuple(s[:1] for s in init),
                             device="cpu")


def test_batch_hooks_match_reference(small_graphs):
    for name in ("BFS", "SSSP", "WP", "WSP", "NSP", "CC", "NWR"):
        assert TE.batchable_program(TF.fuse(TU.ALL_SPECS[name]())) == \
            JE.batchable_program(JF.fuse(JU.ALL_SPECS[name]())), name
    assert not TE.batchable_program(TF.fuse(TU.rds(0, 1)))
    jg = small_graphs["rmat"]
    tg = _port_graph(jg)
    for name in ("BFS", "SSSP", "WSP"):
        port = TE.batch_init_state(tg, TF.fuse(TU.ALL_SPECS[name]()),
                                   [0, 5, 9])
        ref = JE.batch_init_state(jg, JF.fuse(JU.ALL_SPECS[name]()),
                                  [0, 5, 9])
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            assert p.shape == (3, tg.n)
            assert _bytes(p) == np.asarray(r).tobytes(), name
    with pytest.raises(ValueError, match="single-round"):
        TE.batch_init_state(tg, TF.fuse(TU.rds(0, 1)), [0])


def test_run_direct_sources_matches_solo(small_graphs):
    jg = small_graphs["rmat"]
    tg = _port_graph(jg)
    srcs = _sources(jg.n, 5, seed=7)
    for name in ("SSSP", "BFS", "WP"):
        dk = TU.HANDWRITTEN[name]()
        batch = TE.run_direct(tg, dk, engine="cuda", sources=srcs,
                              device="cpu")
        solo = [TE.run_direct(tg, dk, engine="cuda", source=s,
                              device="cpu") for s in srcs]
        _assert_same(batch, solo, name)
    ref = JE.run_direct(jg, JU.handwritten_sssp(0), engine="pallas",
                        sources=srcs)
    port = TE.run_direct(tg, TU.handwritten_sssp(0), engine="cuda",
                         sources=srcs, device="cpu")
    _assert_same(port, ref, "handwritten SSSP")
    with pytest.raises(ValueError, match="source-generic"):
        TE.run_direct(tg, TU.handwritten_cc(), engine="cuda", sources=[0],
                      device="cpu")
    with pytest.raises(ValueError, match="solo"):
        TE.run_direct(tg, TU.handwritten_sssp(0), engine="cuda",
                      sources=[0], init_state=(torch.zeros(tg.n),),
                      device="cpu")
    with pytest.raises(guard.GraphValidationError, match="out of range"):
        TE.run_direct(tg, TU.handwritten_sssp(0), engine="cuda",
                      sources=[0, tg.n], device="cpu")


def test_batch_rejects_2d_sources(small_graphs):
    tg = _port_graph(small_graphs["rmat"])
    with pytest.raises(ValueError, match="\\[B\\] vector"):
        TE.run_program_batch(tg, TF.fuse(TU.bfs(0)), [[0, 1], [2, 3]],
                             device="cpu")


def test_sequential_lane_records_degradation(small_graphs):
    jg = small_graphs["rmat"]
    tg = _port_graph(jg)
    srcs = [0, 3, 5]
    port = TE.run_program_batch(tg, TF.fuse(TU.sssp(0)), srcs,
                                engine="pull", device="cpu")
    ref = JE.run_program_batch(jg, JF.fuse(JU.sssp(0)), srcs, engine="pull")
    want = guard.batch_degradation("pull", 3).as_tuple()
    for p, r, s in zip(port, ref, srcs):
        assert p.stats.fallbacks == (want,) == r.stats.fallbacks
        assert p.stats.plan.batch_lane == "sequential" == \
            r.stats.plan.batch_lane
        assert _bytes(p.value) == np.asarray(r.value).tobytes()
        solo = TE.run_program(tg, TF.fuse(TU.sssp(0)), engine="pull",
                              source=s, device="cpu")
        assert _bytes(p.value) == _bytes(solo.value)
    ex = TE.run_program_batch(tg, TF.fuse(TU.sssp(0)), srcs, explain=True,
                              device="cpu")
    jx = JE.run_program_batch(jg, JF.fuse(JU.sssp(0)), srcs, engine="pallas",
                              explain=True)
    assert ex.plan.batch_lane == jx.plan.batch_lane == "vmapped"
    assert ex.plan.engine == "cuda" and "B=3" in ex.decisions["batch_lane"]


def test_batch_fallback_degrades_but_kernel_faults_propagate(small_graphs,
                                                             monkeypatch):
    """``test_checkpointed_fixpoint.py``'s batched degradation: a
    RuntimeError outside the kernel layer re-runs the batch on adaptive,
    one event per query; a kernel launch fault propagates."""
    jg = small_graphs["rmat"]
    tg = _port_graph(jg)
    dk = TU.handwritten_bfs_depth(0)
    srcs = [0, 3, 5]
    refs = TE.run_direct(tg, dk, engine="adaptive", sources=srcs,
                         device="cpu")

    def boom(*a, **kw):
        raise RuntimeError("forced batch failure")

    monkeypatch.setattr(kops, "iterate_cuda_batch", boom)
    for outs in (TE.run_direct(tg, dk, engine="cuda", sources=srcs,
                               fallback=True, device="cpu"),
                 TE.run_program_batch(tg, TF.fuse(TU.bfs_depth(0)), srcs,
                                      fallback=True, device="cpu")):
        assert len(outs) == 3
        for ref, out in zip(refs, outs):
            assert _bytes(ref.value) == _bytes(out.value)
            assert out.stats.engine_used == "adaptive"
            assert out.stats.fallbacks == (
                ("cuda", "adaptive", "RuntimeError: forced batch failure"),)
    with pytest.raises(RuntimeError, match="forced batch failure"):
        TE.run_direct(tg, dk, engine="cuda", sources=srcs, device="cpu")

    def launch_fault(*a, **kw):
        raise guard.KernelLaunchError("CUDA push kernel launch failed")

    monkeypatch.setattr(kops, "iterate_cuda_batch", launch_fault)
    with pytest.raises(guard.KernelLaunchError):
        TE.run_program_batch(tg, TF.fuse(TU.bfs_depth(0)), srcs,
                             fallback=True, device="cpu")
    monkeypatch.undo()
    # a fault inside the batched loop is a kernel fault
    monkeypatch.setattr(kops, "_batch_step", boom)
    with pytest.raises(guard.KernelLaunchError, match="forced batch"):
        TE.run_direct(tg, dk, engine="cuda", sources=srcs, fallback=True,
                      device="cpu")


def _sweep_inputs(name, seed):
    """A port round, the RM-XS layouts and three query slots' frontiers and
    states (a quarter ⊥)."""
    from repro_torch.core import iterate as TI
    from repro_torch.core.synthesis import synthesize_round
    tg = TS.rmat_graph(400, 3200, seed=11, device="cpu")
    (r,) = [r for _n, r in TF.fuse(TU.ALL_SPECS[name]()).rounds
            if r.leaves]
    rnd = kops.sweep_round(TI.comp_runtimes(r, synthesize_round(r)),
                           [leaf.plan for leaf in r.leaves])
    ein = TS.to_blocked_ell(tg, direction="in")
    eout = TS.to_blocked_ell(tg, direction="out")
    res = TS.to_push_resolution(tg)
    n_pad = ein.n_pad
    rng = np.random.default_rng(seed)
    act = torch.from_numpy((rng.random((3, n_pad)) < 0.2).astype(np.int32))
    act[:, tg.n:] = 0
    st = []
    for dt, ident in zip(rnd.dtypes, rnd.idents):
        v = rng.uniform(0.5, 9.0, (3, n_pad)).astype(np.float32) \
            if dt == torch.float32 else \
            rng.integers(0, 50, (3, n_pad)).astype(np.int32)
        v[rng.random((3, n_pad)) < 0.25] = ident
        st.append(torch.from_numpy(v))
    od = torch.ones(n_pad)
    wd = torch.ones(n_pad)
    return tg, rnd, ein, eout, res, act, st, od, wd


@pytest.mark.parametrize("name", ["BFS", "WSP"])
def test_batched_plain_sweeps_stack_solo_sweeps(name):
    """Each batched sweep (the wrappers on CPU tensors) equals its solo
    sweep per slot, with per-slot and with shared frontiers."""
    tg, rnd, ein, eout, res, act, st, od, wd = _sweep_inputs(name, 5)
    nv = float(tg.n)
    per_tiles = TER.tile_activity(ein.nbrs, ein.mask, ein.tile_nnz, act)
    assert per_tiles.shape == (3,) + tuple(ein.tile_nnz.shape)
    outs, derived = TER.pull_sweep_frontier(
        rnd, ein.tiles_static, ein.nbrs, ein.weight, ein.capacity, ein.mask,
        act, od, wd, st, nv, True)
    given = TER.pull_sweep(rnd, per_tiles, ein.nbrs, ein.weight,
                           ein.capacity, ein.mask, act, od, wd, st, nv, True)
    shared = TER.pull_sweep(rnd, ein.tiles_static, ein.nbrs, ein.weight,
                            ein.capacity, ein.mask, act[1], od, wd, st, nv)
    p_act = TER.tile_activity_push(eout.tile_nnz, act)
    cands = TER.push_sweep(rnd, p_act, eout.nbrs, eout.weight, eout.capacity,
                           eout.mask, act, od, wd, st, nv)
    r_act = TER.resolution_tile_activity(res.contrib, p_act, res.tile_nnz)
    resolved = TER.resolve_sweep(rnd, r_act, res.valid, res.in2out, cands,
                                 p_act, eout.width, st, True)
    red, _ = TER._fold_tile_candidates(rnd, given)
    for s in range(3):
        st_s = [x[s] for x in st]
        assert torch.equal(per_tiles[s], TER.tile_activity(
            ein.nbrs, ein.mask, ein.tile_nnz, act[s]))
        assert torch.equal(derived[s], per_tiles[s])
        want = TER.pull_sweep(rnd, per_tiles[s], ein.nbrs, ein.weight,
                              ein.capacity, ein.mask, act[s], od, wd, st_s,
                              nv, True)
        for a, b, c in zip(outs, given, want):
            assert torch.equal(a[s], c) and torch.equal(b[s], c)
        want_shared = TER.pull_sweep(rnd, ein.tiles_static, ein.nbrs,
                                     ein.weight, ein.capacity, ein.mask,
                                     act[1], od, wd, st_s, nv)
        for a, c in zip(shared, want_shared):
            assert torch.equal(a[s], c)
        assert torch.equal(p_act[s], TER.tile_activity_push(eout.tile_nnz,
                                                            act[s]))
        want_c = TER.push_sweep(rnd, p_act[s], eout.nbrs, eout.weight,
                                eout.capacity, eout.mask, act[s], od, wd,
                                st_s, nv)
        for a, c in zip(cands, want_c):
            assert torch.equal(a[s], c)
        assert torch.equal(r_act[s], TER.resolution_tile_activity(
            res.contrib, p_act[s], res.tile_nnz))
        want_r = TER.resolve_sweep(rnd, r_act[s], res.valid, res.in2out,
                                   want_c, p_act[s], eout.width, st_s, True)
        for a, c in zip(resolved, want_r):
            assert torch.equal(a[s], c)
        red_s, _ = TER._fold_tile_candidates(rnd, [c[s] for c in given])
        for c in red:
            assert torch.equal(red[c][s], red_s[c])
