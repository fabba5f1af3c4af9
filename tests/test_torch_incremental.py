"""Incremental fixpoints over mutated graphs: the port against the JAX
package's.

The counterparts of ``tests/test_incremental.py`` (all but its three
service tests, which come with the port of the service) on the port's
``graph.mutate.mutate_edges`` and the ``delta=`` paths of
``run_program`` / ``run_direct`` / ``ops.iterate_cuda`` on the CPU (the
plain versions of the kernels), at the reference test's size
(``uniform_graph(32, 160, seed=3)``) and at RM-XS (``rmat_graph(400, 3200,
seed=11)``), carried across with ``from_arrays``.  Against the reference
(``engine="pallas"``, Pallas in interpret mode):

- the patched in- and out-layouts and the resolution derived from their
  slots are bitwise the reference's patched ones, mutation counts equal;
- validation raises the reference's error text;
- insert-only delta queries give the reference's bits with its six
  counters, and bitwise the cold query on the mutated graph (and on a
  canonical rebuild); the planner's ``incremental`` decisions and their
  ``explain`` text are the reference's;
- PageRank's rescaled warm delta converges allclose (atol 1e-4, as the
  reference test holds it) to the cold query in no more iterations, and
  within rtol 1e-5 of the reference's warm delta;
- the RM-XS rows of ``BENCH_pallas.json`` (``incremental_rows``) are met.

Inside the port: the old graph's layouts and answers are untouched by a
mutation, and freed slots (mask off, neighbour 0) and emptied tiles leave
every answer and counter the reference's.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core import fusion as JF
from repro.core import usecases as JU
from repro.graph import mutate as JM
from repro.graph import structure as JS
from repro_torch.core import engine as TE
from repro_torch.core import fusion as TF
from repro_torch.core import iterate as TI
from repro_torch.core import usecases as TU
from repro_torch.core.guard import GraphValidationError
from repro_torch.graph import mutate as TM
from repro_torch.graph import structure as TS
from repro_torch.kernels import ops as TO

pytestmark = pytest.mark.incremental

BENCH = Path(__file__).resolve().parents[1] / "BENCH_pallas.json"
ELL_FIELDS = ("nbrs", "weight", "capacity", "mask", "tile_nnz")
RES_FIELDS = ("in2out", "valid", "src_tile", "tile_nnz", "contrib")


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    yield
    TE.clear_program_caches()


@pytest.fixture
def graphs():
    # 160 edges: a 4-edge batch sits well under the planner's 5 % delta
    # threshold, a half-|E| batch well over it
    jg = JS.uniform_graph(32, 160, seed=3, weighted=True)
    return jg, _port(jg)


def _port(jg):
    return TS.from_arrays(jg.n, *jg.host_edges(), device="cpu")


def _ref(jg, name, **kw):
    return JE.run_program(jg, JF.fuse(JU.ALL_SPECS[name]()), engine="pallas",
                          **kw)


def _run(tg, name, **kw):
    return TE.run_program(tg, TF.fuse(TU.ALL_SPECS[name]()), engine="cuda",
                          device="cpu", **kw)


def _canonical(tg):
    """The same edge multiset rebuilt from scratch: canonical slots, no
    patched caches."""
    return TS.from_arrays(tg.n, *tg.host_edges(), device="cpu")


def _insert(rng, n, k, weighted=True):
    parts = (rng.integers(0, n, size=k), rng.integers(0, n, size=k))
    if weighted:
        parts += ((0.1 + rng.random(k)).astype(np.float32),)
    return parts


def _counters(s):
    return (s.iterations, s.push_iters, s.pull_iters, int(s.edge_work),
            int(s.resolve_work), int(s.gather_work))


def _value(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(a, b, msg=""):
    np.testing.assert_array_equal(_value(a), _value(b), err_msg=msg)


def _mutate_both(jg, tg, layouts=True, **kw):
    """One mutation in both packages: the same delta and edge lists, and,
    where both graphs cached the same layouts (``layouts``), the same
    patched and rebuilt counts."""
    j2, jmd = JM.mutate_edges(jg, **kw)
    t2, tmd = TM.mutate_edges(tg, **kw)
    fields = ("inserted", "deleted", "has_deletes")
    if layouts:
        fields += ("patched_layouts", "rebuilt_layouts")
    for f in fields:
        assert getattr(tmd, f) == getattr(jmd, f), f
    _equal(tmd.touched, jmd.touched)
    assert tmd.touched.dtype == np.int64
    for a, b in zip(t2.host_edges(), j2.host_edges()):
        _equal(a, b)
    return j2, jmd, t2, tmd


def _same_caches(jg2, tg2):
    """Every layout, resolution and slot map cached for the mutated graph
    is bitwise the reference's, and the two packages cache the same keys."""
    def keys(cache, g):
        return sorted(k[1:] for k, (ref, _v) in cache.items()
                      if k[0] == id(g) and ref() is g)
    for jc, tc in ((JS._ELL_CACHE, TS._ELL_CACHE),
                   (JS._RES_CACHE, TS._RES_CACHE),
                   (JS._SLOT_CACHE, TS._SLOT_CACHE)):
        assert keys(tc, tg2) == keys(jc, jg2)
    for k in keys(TS._ELL_CACHE, tg2):
        je = JS._ELL_CACHE[(id(jg2),) + k][1]
        te = TS._ELL_CACHE[(id(tg2),) + k][1]
        assert (te.n_pad, te.width) == (je.n_pad, je.width)
        for f in ELL_FIELDS:
            _equal(getattr(te, f), getattr(je, f), f"{k} {f}")
    for k in keys(TS._RES_CACHE, tg2):
        jr = JS._RES_CACHE[(id(jg2),) + k][1]
        tr = TS._RES_CACHE[(id(tg2),) + k][1]
        assert (tr.width, tr.out_width) == (jr.width, jr.out_width)
        for f in RES_FIELDS:
            want = np.asarray(getattr(jr, f))
            got = getattr(tr, f).numpy()
            assert got.dtype == want.dtype, f
            _equal(got, want, f"resolution {f}")
    for k in keys(TS._SLOT_CACHE, tg2):
        for a, b in zip(TS._SLOT_CACHE[(id(tg2),) + k][1],
                        JS._SLOT_CACHE[(id(jg2),) + k][1]):
            _equal(a, b)


def _same_as_canonical(tg2):
    """Each patched layout holds, row by row, the canonical rebuild's edges
    (slot order aside), and as many real slots per row tile."""
    ref = _canonical(tg2)
    for d in ("in", "out"):
        p = TS._ELL_CACHE[(id(tg2), 8, 128, d)][1]
        c = TS.blocked_ell_cached(ref, direction=d)
        assert torch.equal(p.tile_nnz.sum(1), c.tile_nnz.sum(1))
        for r in range(tg2.n):
            def row(e):
                m = e.mask[r]
                return sorted(zip(e.nbrs[r][m].tolist(),
                                  e.weight[r][m].tolist(),
                                  e.capacity[r][m].tolist()))
            assert row(p) == row(c), (d, r)


# ---------------------------------------------------------------------------
# Layout patching: bitwise the reference's patch, value-equal to a rebuild
# ---------------------------------------------------------------------------

def test_patched_layouts_match_canonical_rebuild(graphs):
    jg, tg = graphs
    for name in ("BFS", "CC"):
        _ref(jg, name)
        _run(tg, name)                      # warm the layout caches
    src, dst, _w, _c = tg.host_edges()
    TM.reset_mutation_stats()
    jg2, jmd, tg2, md = _mutate_both(
        jg, tg, insert=([1, 2, 3], [4, 5, 6]), delete=(src[:2], dst[:2]))
    assert md.inserted == 3 and md.deleted == 2 and md.has_deletes
    assert md.patched_layouts == 3 and md.rebuilt_layouts == 0
    _same_caches(jg2, tg2)
    _same_as_canonical(tg2)
    ref = _canonical(tg2)
    for name in ("BFS", "CC"):
        a = _run(tg2, name)                 # served by the patched caches
        b = _run(ref, name)                 # canonical lazy build
        _equal(a.value, b.value, name)
        _equal(a.value, _ref(jg2, name).value, name)


def test_chained_mutations_keep_patching_from_real_slots(graphs):
    """Patched slots are non-canonical; a second mutation patches from the
    RECORDED positions (``structure._SLOT_CACHE``), as the reference's."""
    jg, tg = graphs
    _ref(jg, "BFS")
    _run(tg, "BFS")
    jg1, _jmd1, tg1, md1 = _mutate_both(jg, tg, insert=([0, 1], [2, 3]))
    assert md1.patched_layouts >= 1
    _same_caches(jg1, tg1)
    src, dst, _w, _c = tg1.host_edges()
    jg2, _jmd2, tg2, md2 = _mutate_both(jg1, tg1, insert=([4], [5]),
                                        delete=(src[:1], dst[:1]))
    assert md2.patched_layouts >= 1
    _same_caches(jg2, tg2)
    _same_as_canonical(tg2)
    a = _run(tg2, "BFS")
    _equal(a.value, _run(_canonical(tg2), "BFS").value)
    _equal(a.value, _ref(jg2, "BFS").value)


def test_row_overflow_falls_back_to_counted_rebuild(graphs):
    jg, tg = graphs
    _ref(jg, "BFS")
    _run(tg, "BFS")                         # warm the layout caches
    TM.reset_mutation_stats()
    # 200 inserts all landing on dst=0 overflow row 0's padded in-width:
    # the in-layout falls back to a counted rebuild, the out-layout and the
    # resolution are patched, and values stay canonical
    k = 200
    rng = np.random.default_rng(0)
    ins = (rng.integers(1, tg.n, size=k), np.zeros(k, np.int64))
    jg2, _jmd, tg2, md = _mutate_both(jg, tg, insert=ins)
    assert md.rebuilt_layouts == 1 and md.patched_layouts == 2
    assert TM.MUTATION_STATS["rebuilt_layouts"] == md.rebuilt_layouts
    assert (id(tg2), 8, 128, "in") not in TS._ELL_CACHE
    _same_caches(jg2, tg2)
    a = _run(tg2, "BFS")
    _equal(a.value, _run(_canonical(tg2), "BFS").value)
    _equal(a.value, _ref(jg2, "BFS").value)


def test_old_graph_untouched_by_a_mutation(graphs):
    """The patch never writes the old graph's tensors: its layouts,
    resolution and answers stay as they were."""
    _jg, tg = graphs
    before = {name: _run(tg, name) for name in ("BFS", "SSSP")}
    ells = {d: TS.blocked_ell_cached(tg, direction=d) for d in ("in", "out")}
    res = TS.push_resolution_cached(tg)
    saved = {(d, f): getattr(e, f).clone() for d, e in ells.items()
             for f in ELL_FIELDS}
    saved_res = {f: getattr(res, f).clone() for f in RES_FIELDS}
    src, dst, _w, _c = tg.host_edges()
    tg2, md = TM.mutate_edges(tg, insert=([0, 5, 9], [7, 7, 2]),
                              delete=(src[:3], dst[:3]))
    assert md.patched_layouts == 3
    for d, e in ells.items():
        assert TS.blocked_ell_cached(tg, direction=d) is e
        for f in ELL_FIELDS:
            assert torch.equal(getattr(e, f), saved[(d, f)]), (d, f)
        assert TS.blocked_ell_cached(tg2, direction=d) is not e
    for f in RES_FIELDS:
        assert torch.equal(getattr(res, f), saved_res[f]), f
    for name, r in before.items():
        again = _run(tg, name)
        _equal(again.value, r.value, name)
        assert _counters(again.stats) == _counters(r.stats)


# ---------------------------------------------------------------------------
# Freed slots and emptied tiles on the sweeps' path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["BFS", "SSSP", "WP"])
def test_freed_slots_keep_counters_of_the_reference(graphs, name):
    """Deletes leave freed slots (mask off, neighbour 0) in rows that hold
    no edge from vertex 0.  Seeded with vertex 0 alone, the pull tile
    activity must ignore them, so edge, resolve and gather work stay the
    reference's on the same patched graph, in the pull direction and on
    the default switch."""
    jg, tg = graphs
    _ref(jg, name)
    _run(tg, name)
    src, dst, _w, _c = tg.host_edges()
    far = np.flatnonzero(~np.isin(dst, dst[src == 0]) & (src != 0))[::4]
    jg2, _jmd, tg2, _md = _mutate_both(jg, tg, delete=(src[far], dst[far]))
    in2 = TS._ELL_CACHE[(id(tg2), 8, 128, "in")][1]
    freed = (in2.nbrs == 0) & ~in2.mask
    freed[tg.n:] = False
    assert int(freed.sum()) >= far.size
    _jr, jstate = _ref(jg2, name, return_state=True)
    _r, state = _run(tg2, name, return_state=True)
    seed = np.array([0], np.int64)
    for model in ("pull", None):
        want = _ref(jg2, name, init_state=jstate, delta=seed, model=model)
        got = _run(tg2, name, init_state=state, delta=seed, model=model)
        _equal(got.value, want.value, name)
        assert _counters(got.stats) == _counters(want.stats), model


def test_emptied_tiles_keep_answers_and_counters(graphs):
    """A patch that takes a tile's ``tile_nnz`` to 0 in both layouts and
    the resolution: the patched layout derives its walk afresh and the
    sweeps emit identities there (PageRank's pull− walks the static tiles)."""
    jg, tg = graphs
    for name in ("BFS", "SSSP"):
        _ref(jg, name)
        _run(tg, name)
    src, dst, _w, _c = tg.host_edges()
    rows = np.arange(8, 16)
    hit = np.isin(dst, rows) | np.isin(src, rows)
    jg2, _jmd, tg2, _md = _mutate_both(jg, tg, delete=(src[hit], dst[hit]))
    _same_caches(jg2, tg2)
    for d in ("in", "out"):
        e = TS._ELL_CACHE[(id(tg2), 8, 128, d)][1]
        assert int(e.tile_nnz[1].sum()) == 0
        assert int(e.tiles_static[1].sum()) == 0
        assert int(e.row_tile_walk[1][1]) == 0
    assert int(TS._RES_CACHE[(id(tg2), 8, 128)][1].tile_nnz[1].sum()) == 0
    for name in ("BFS", "SSSP", "WP"):
        want = _ref(jg2, name)
        got = _run(tg2, name)
        _equal(got.value, want.value, name)
        assert _counters(got.stats) == _counters(want.stats), name
    dk_t, dk_j = TU.pagerank_kernels(tg.n), JU.pagerank_kernels(jg.n)
    got = TE.run_direct(tg2, dk_t, engine="cuda", device="cpu")
    want = JE.run_direct(jg2, dk_j, engine="pallas")
    np.testing.assert_allclose(_value(got.value), _value(want.value),
                               rtol=1e-5, atol=1e-7)
    assert _counters(got.stats) == _counters(want.stats)


# ---------------------------------------------------------------------------
# Mutation edge cases: policies and missing edges, the reference's text
# ---------------------------------------------------------------------------

def _same_error(call_j, call_t, exc_t, exc_j=None):
    with pytest.raises(exc_j or exc_t) as ej:
        call_j()
    with pytest.raises(exc_t) as et:
        call_t()
    assert str(et.value) == str(ej.value)
    return str(et.value)


def test_duplicate_insert_under_both_policies(graphs):
    jg, tg = graphs
    src, dst, _w, _c = tg.host_edges()
    dup = ([int(src[0])], [int(dst[0])])
    _jg2, _jmd, tg2, md = _mutate_both(jg, tg, insert=dup,
                                       duplicates="allow")
    assert md.inserted == 1 and tg2.num_edges == tg.num_edges + 1
    msg = _same_error(
        lambda: JM.mutate_edges(jg, insert=dup, duplicates="error"),
        lambda: TM.mutate_edges(tg, insert=dup, duplicates="error"),
        GraphValidationError, ValueError)
    assert "duplicate" in msg


def test_self_loop_policies(graphs):
    """``self_loops="drop"`` filters a self-loop insert (and counts nothing
    inserted for it); ``"error"`` raises the reference's text."""
    jg, tg = graphs
    loops = ([3, 4], [3, 9])
    _jg2, _jmd, _tg2, md = _mutate_both(jg, tg, insert=loops,
                                        self_loops="drop")
    assert md.inserted == 1
    msg = _same_error(
        lambda: JM.mutate_edges(jg, insert=loops, self_loops="error"),
        lambda: TM.mutate_edges(tg, insert=loops, self_loops="error"),
        GraphValidationError, ValueError)
    assert "self-loops" in msg


def test_delete_missing_edge_raises(graphs):
    jg, tg = graphs
    src, dst, _w, _c = tg.host_edges()
    present = set(zip(src.tolist(), dst.tolist()))
    missing = next((s, d) for s in range(tg.n) for d in range(tg.n)
                   if (s, d) not in present)
    msg = _same_error(
        lambda: JM.mutate_edges(jg, delete=([missing[0]], [missing[1]])),
        lambda: TM.mutate_edges(tg, delete=([missing[0]], [missing[1]])),
        GraphValidationError, ValueError)
    assert "not present" in msg
    # a k-fold request needs k occurrences: one real edge twice is missing
    # unless the graph holds a parallel copy
    if (int(src[0]), int(dst[0])) not in \
            set(zip(src[1:].tolist(), dst[1:].tolist())):
        twice = ([int(src[0])] * 2, [int(dst[0])] * 2)
        msg = _same_error(lambda: JM.mutate_edges(jg, delete=twice),
                          lambda: TM.mutate_edges(tg, delete=twice),
                          GraphValidationError, ValueError)
        assert "not present" in msg


def test_parallel_edge_deletes_consume_by_rank():
    """A k-fold delete of a parallel edge consumes its occurrences in
    order; the surviving copy keeps its weight, as in the reference."""
    src = np.array([0, 0, 0, 1, 2], np.int32)
    dst = np.array([1, 1, 1, 2, 0], np.int32)
    w = np.array([1, 2, 3, 4, 5], np.float32)
    jg = JS.from_edges(3, src, dst, w, w)
    tg = _port(jg)
    _ref(jg, "SSSP")
    _run(tg, "SSSP")
    jg2, _jmd, tg2, md = _mutate_both(jg, tg, delete=([0, 0], [1, 1]))
    assert md.deleted == 2
    _same_caches(jg2, tg2)
    _equal(tg2.host_edges()[2], jg2.host_edges()[2])


def test_empty_mutation_rejected(graphs):
    jg, tg = graphs
    msg = _same_error(lambda: JM.mutate_edges(jg),
                      lambda: TM.mutate_edges(tg), ValueError)
    assert "insert batch" in msg


# ---------------------------------------------------------------------------
# Delta-seeded fixpoints: bitwise the cold recompute and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["BFS", "SSSP", "CC", "WP"])
def test_insert_only_delta_bitwise_equals_cold(graphs, name):
    jg, tg = graphs
    _jr0, jstate = _ref(jg, name, return_state=True)
    _r0, state = _run(tg, name, return_state=True)
    ins = _insert(np.random.default_rng(1), tg.n, 4)
    jg2, jmd, tg2, md = _mutate_both(jg, tg, insert=ins)
    assert not md.has_deletes
    _same_caches(jg2, tg2)
    warm = _run(tg2, name, init_state=state, delta=md)
    assert warm.stats.plan.incremental == "delta"
    cold = _run(tg2, name)
    _equal(warm.value, cold.value, name)
    # ... and both agree with a from-scratch canonical graph
    _equal(cold.value, _run(_canonical(tg2), name).value, name)
    want = _ref(jg2, name, init_state=jstate, delta=jmd)
    _equal(warm.value, want.value, name)
    assert _counters(warm.stats) == _counters(want.stats)
    assert warm.stats.edge_work < cold.stats.edge_work


def test_deletes_plan_full_recompute_and_stay_correct(graphs):
    jg, tg = graphs
    _jr0, jstate = _ref(jg, "BFS", return_state=True)
    _r0, state = _run(tg, "BFS", return_state=True)
    src, dst, _w, _c = tg.host_edges()
    jg2, jmd, tg2, md = _mutate_both(jg, tg, delete=(src[:2], dst[:2]))
    assert md.has_deletes
    # idempotent round after deletions: stale monotone values cannot
    # retract, so the planner drops the warm hints and runs cold
    warm = _run(tg2, "BFS", init_state=state, delta=md)
    assert warm.stats.plan.incremental == "full"
    cold = _run(tg2, "BFS")
    _equal(warm.value, cold.value)
    assert _counters(warm.stats) == _counters(cold.stats)
    want = _ref(jg2, "BFS", init_state=jstate, delta=jmd)
    assert want.stats.plan.incremental == "full"
    _equal(warm.value, want.value)
    assert _counters(warm.stats) == _counters(want.stats)


def test_large_batch_plans_full(graphs):
    jg, tg = graphs
    _r0, state = _run(tg, "BFS", return_state=True)
    ins = _insert(np.random.default_rng(2), tg.n, tg.num_edges // 2)
    jg2, _jmd, tg2, md = _mutate_both(jg, tg, layouts=False, insert=ins)
    warm = _run(tg2, "BFS", init_state=state, delta=md)
    assert warm.stats.plan.incremental == "full"
    cold = _run(tg2, "BFS")
    _equal(warm.value, cold.value)
    _equal(warm.value, _ref(jg2, "BFS").value)


def test_explain_records_incremental_decision(graphs):
    jg, tg = graphs
    _r0, state = _run(tg, "BFS", return_state=True)
    jstate = [s.numpy() for s in state]
    jg2, jmd, tg2, md = _mutate_both(jg, tg, layouts=False,
                                     insert=([0, 1], [2, 3]))
    exp = _run(tg2, "BFS", init_state=state, delta=md, explain=True)
    jexp = _ref(jg2, "BFS", init_state=jstate, delta=jmd, explain=True)
    assert exp.plan.incremental == "delta" == jexp.plan.incremental
    assert exp.decisions["incremental"] == jexp.decisions["incremental"]
    assert "delta" in exp.decisions["incremental"]
    ins = _insert(np.random.default_rng(3), tg.n, tg.num_edges)
    jg3, jmd3, tg3, md3 = _mutate_both(jg, tg, layouts=False, insert=ins)
    exp3 = _run(tg3, "BFS", init_state=state, delta=md3, explain=True)
    jexp3 = _ref(jg3, "BFS", init_state=jstate, delta=jmd3, explain=True)
    assert exp3.plan.incremental == "full" == jexp3.plan.incremental
    assert exp3.decisions["incremental"] == jexp3.decisions["incremental"]
    src, dst, _w, _c = tg.host_edges()
    jg4, jmd4, tg4, md4 = _mutate_both(jg, tg, layouts=False,
                                       delete=(src[:1], dst[:1]))
    exp4 = _run(tg4, "BFS", init_state=state, delta=md4, explain=True)
    jexp4 = _ref(jg4, "BFS", init_state=jstate, delta=jmd4, explain=True)
    assert exp4.decisions["incremental"] == jexp4.decisions["incremental"]
    assert "after deletions" in exp4.decisions["incremental"]


def test_mutation_hint_keys_the_plan_cache(graphs):
    """The same graph with and without a mutation hint never shares a
    plan."""
    _jg, tg = graphs
    _r0, state = _run(tg, "BFS", return_state=True)
    tg2, md = TM.mutate_edges(tg, insert=([0], [5]))
    cold = _run(tg2, "BFS")
    warm = _run(tg2, "BFS", init_state=state, delta=md)
    again = _run(tg2, "BFS")
    assert cold.stats.plan.incremental is None
    assert warm.stats.plan.incremental == "delta"
    assert again.stats.plan is cold.stats.plan


def test_raw_delta_array_is_honored_verbatim(graphs):
    """A raw vertex-id delta bypasses the planner's mutation heuristic: no
    MutationDelta, no incremental decision; the warm hints run as given."""
    jg, tg = graphs
    _jr0, jstate = _ref(jg, "BFS", return_state=True)
    _r0, state = _run(tg, "BFS", return_state=True)
    jg2, _jmd, tg2, _md = _mutate_both(jg, tg, insert=([0, 1], [2, 3]))
    ids = np.array([0, 1, 2, 3], np.int64)
    warm = _run(tg2, "BFS", init_state=state, delta=ids)
    assert warm.stats.plan.incremental is None
    _equal(warm.value, _run(tg2, "BFS").value)
    want = _ref(jg2, "BFS", init_state=jstate, delta=ids)
    _equal(warm.value, want.value)
    assert _counters(warm.stats) == _counters(want.stats)


# ---------------------------------------------------------------------------
# Non-idempotent (PageRank-style) rounds: rescaled warm start
# ---------------------------------------------------------------------------

def test_pagerank_warm_delta_converges_to_tolerance(graphs):
    jg, tg = graphs
    dk, jdk = TU.handwritten_pagerank(tg.n), JU.handwritten_pagerank(jg.n)
    prev = TE.run_direct(tg, dk, engine="cuda", device="cpu")
    jprev = JE.run_direct(jg, jdk, engine="pallas")
    ins = ([1, 2], [3, 4], [0.4, 0.6])
    jg2, jmd, tg2, md = _mutate_both(jg, tg, insert=ins)
    cold = TE.run_direct(tg2, dk, engine="cuda", device="cpu")
    warm = TE.run_direct(tg2, dk, engine="cuda", device="cpu",
                         init_state=[prev.value], delta=md.touched)
    assert warm.stats.engine_used == "cuda"
    np.testing.assert_allclose(_value(warm.value), _value(cold.value),
                               atol=1e-4)
    # the converged neighbouring state must not be slower than cold: the
    # regression the mass-preserving rescale exists to prevent
    assert warm.stats.iterations <= cold.stats.iterations
    want = JE.run_direct(jg2, jdk, engine="pallas",
                         init_state=[np.asarray(jprev.value)],
                         delta=np.asarray(jmd.touched))
    np.testing.assert_allclose(_value(warm.value), _value(want.value),
                               rtol=1e-5, atol=1e-7)
    assert warm.stats.iterations == want.stats.iterations


def test_rescale_warm_state_matches_reference():
    """Non-finite entries of a sum component take the finite mean, and the
    state is rescaled to the retired mass, with the reference's bits; an
    all-finite state and a min component pass untouched."""
    from repro.core import engine as je
    from repro_torch.core import engine as te
    rng = np.random.default_rng(5)
    a = rng.random(40).astype(np.float32)
    a[[3, 17]] = np.inf
    a[9] = np.nan
    b = rng.random(40).astype(np.float32)

    class Comp:
        def __init__(self, op):
            self.op = op
    comps = [Comp("sum"), Comp("min")]
    g = TS.line_graph(40, device="cpu")
    got = te._rescale_warm_state([torch.from_numpy(a), b], comps, g)
    want = je._rescale_warm_state([a, b], comps, 40)
    for x, y in zip(got, want):
        assert x.device == g.device
        assert x.numpy().tobytes() == np.asarray(y).tobytes()
    fine = te._rescale_warm_state([b, b], comps, g)
    assert fine[0].numpy().tobytes() == b.tobytes()


def test_delta_validation_guards(graphs):
    jg, tg = graphs
    _r0, state = _run(tg, "BFS", return_state=True)
    jstate = [s.numpy() for s in state]

    def both(call_t, call_j, match):
        with pytest.raises(ValueError, match=match) as et:
            call_t()
        with pytest.raises(ValueError) as ej:
            call_j()
        assert str(et.value) == str(ej.value).replace("pallas", "cuda")

    both(lambda: _run(tg, "BFS", delta=np.array([0, 1])),
         lambda: _ref(jg, "BFS", delta=np.array([0, 1])), "init_state")
    both(lambda: _run(tg, "BFS", init_state=state,
                      delta=np.array([tg.n + 5])),
         lambda: _ref(jg, "BFS", init_state=jstate,
                      delta=np.array([jg.n + 5])), "out of range")
    with pytest.raises(ValueError, match="cuda"):
        TE.run_program(tg, TF.fuse(TU.bfs(0)), engine="pull", device="cpu",
                       init_state=state)
    with pytest.raises(ValueError, match="cuda"):
        TE.run_program(tg, TF.fuse(TU.bfs(0)), engine="adaptive",
                       device="cpu", init_state=state, delta=[0])
    with pytest.raises(ValueError, match="single-round"):
        TE.run_program(tg, TF.fuse(TU.rds(0, 1)), engine="cuda",
                       device="cpu", init_state=state, delta=np.array([0]))
    # non-idempotent + tol=0: bitwise convergence is not a meaningful
    # contract for a contraction, so the engine refuses
    dk0, jdk0 = TU.pagerank_kernels(tg.n, tol=0.0), \
        JU.pagerank_kernels(jg.n, tol=0.0)
    start = [np.full(tg.n, 1.0 / tg.n, np.float32)]
    both(lambda: TE.run_direct(tg, dk0, engine="cuda", device="cpu",
                               init_state=start, delta=np.array([0])),
         lambda: JE.run_direct(jg, jdk0, engine="pallas", init_state=start,
                               delta=np.array([0])), "tol > 0")
    dk = TU.handwritten_sssp(0)
    both(lambda: TE.run_direct(tg, dk, engine="cuda", device="cpu",
                               sources=[0, 1], delta=np.array([0])),
         lambda: JE.run_direct(jg, JU.handwritten_sssp(0), engine="pallas",
                               sources=[0, 1], delta=np.array([0])),
         "solo-query")
    with pytest.raises(ValueError, match="cuda"):
        TE.run_direct(tg, dk, engine="pull", device="cpu",
                      init_state=[state[0]], delta=np.array([0]))
    with pytest.raises(TypeError, match="delta"):
        TE.run_program_batch(tg, TF.fuse(TU.bfs(0)), [0, 1], device="cpu",
                             delta=np.array([0]))


# ---------------------------------------------------------------------------
# Checkpointed fixpoint across a mutation: kill mid-delta-run, resume
# ---------------------------------------------------------------------------

class _Kill(Exception):
    pass


def test_mutation_then_kill_and_resume_bitwise(graphs, tmp_path):
    jg, tg = graphs
    dk = TU.handwritten_sssp(0)
    comp = TI.CompRuntime(idx=0, op=dk.rop, dtype=TI.DTYPES[dk.dtype],
                          p_fn=dk.p_fn, init_fn=dk.init_fn, source=dk.source,
                          e_fn=dk.e_fn, p_expr=dk.p_expr)
    plans = [TF.Prim(dk.rop, 0)]
    base = TO.iterate_cuda(tg, [comp], plans)
    state = [s.clone() for s in base.state]
    ins = ([0, 3], [5, 7], [0.2, 0.3])
    jg2, jmd, tg2, md = _mutate_both(jg, tg, layouts=False, insert=ins)
    ref = TO.iterate_cuda(tg2, [comp], plans, init_state=state,
                          delta=md.touched)
    d = str(tmp_path / "mut")

    def killer(k):
        raise _Kill

    with pytest.raises(_Kill):
        TO.iterate_cuda(tg2, [comp], plans, init_state=state,
                        delta=md.touched, checkpoint_every=1, ckpt_dir=d,
                        fault_hook=killer)
    resumed = TO.iterate_cuda(tg2, [comp], plans, init_state=state,
                              delta=md.touched, checkpoint_every=1,
                              ckpt_dir=d, resume=True)
    assert resumed.iterations == ref.iterations
    assert (resumed.edge_work, resumed.push_iters, resumed.resolve_work) == \
        (ref.edge_work, ref.push_iters, ref.resolve_work)
    for a, b in zip(ref.state, resumed.state):
        assert torch.equal(a, b)
    # ... and the uninterrupted delta query is the reference's
    want = JE.run_direct(jg2, JU.handwritten_sssp(0), engine="pallas",
                         init_state=[s.numpy() for s in state],
                         delta=np.asarray(jmd.touched))
    _equal(ref.state[0], want.value)
    assert ref.iterations == want.stats.iterations
    assert ref.edge_work == int(want.stats.edge_work)


# ---------------------------------------------------------------------------
# Cache accounting: slot maps in the stats surface, cleared with the rest
# ---------------------------------------------------------------------------

def test_slot_cache_stats_and_clear(graphs):
    _jg, tg = graphs
    _run(tg, "BFS")                         # warm the layout caches
    TM.reset_mutation_stats()
    tg2, md = TM.mutate_edges(tg, insert=([0], [1]))
    assert md.patched_layouts >= 1
    stats = TE.program_cache_stats()
    assert stats["slot_maps"] >= 1
    assert TM.MUTATION_STATS["mutations"] == 1
    assert TE.clear_graph_caches(tg2) >= 4   # in, out, resolution, slots
    assert TE.program_cache_stats()["slot_maps"] == 0
    TM.mutate_edges(tg, insert=([0], [1]))
    TE.clear_program_caches()
    stats = TE.program_cache_stats()
    assert stats["slot_maps"] == 0
    assert TM.MUTATION_STATS["mutations"] == 0


# ---------------------------------------------------------------------------
# RM-XS: the incremental rows of BENCH_pallas.json
# ---------------------------------------------------------------------------

def _bench_rows():
    rows = json.loads(BENCH.read_text())["incremental_rows"]
    return [pytest.param(r, id=f"{r['usecase']}-"
                         f"{'w' if r['weighted'] else 'unw'}") for r in rows]


@pytest.mark.parametrize("row", _bench_rows())
def test_rm_xs_incremental_rows(row):
    """The reference bench's perturbation (seed 7, 0.5 % of |E| random
    inserts, weights 0.1 + U[0, 1) on the weighted graph) of
    ``rmat_graph(400, 3200, seed=11)``: delta and full iterations and edge
    work, patched and rebuilt layouts, as the reference recorded them."""
    jg = JS.rmat_graph(400, 3200, seed=11, weighted=row["weighted"])
    tg = _port(jg)
    name = row["usecase"]
    _r0, state = _run(tg, name, return_state=True)
    rng = np.random.default_rng(7)
    k = max(2, int(tg.num_edges * 0.005))
    ins = _insert(rng, tg.n, k, weighted=row["weighted"])
    tg2, md = TM.mutate_edges(tg, insert=ins)
    delta = _run(tg2, name, init_state=state, delta=md)
    full = _run(tg2, name)
    _equal(delta.value, full.value, name)
    got = {"num_edges": tg.num_edges, "inserted": md.inserted,
           "touched": int(md.touched.size),
           "plan_incremental": delta.stats.plan.incremental,
           "iterations_delta": delta.stats.iterations,
           "iterations_full": full.stats.iterations,
           "edge_work_delta": float(delta.stats.edge_work),
           "edge_work_full": float(full.stats.edge_work),
           "patched_layouts": md.patched_layouts,
           "rebuilt_layouts": md.rebuilt_layouts}
    assert got == {k: row[k] for k in got}
