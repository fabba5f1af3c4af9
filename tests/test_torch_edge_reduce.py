"""The plain versions of the three CUDA sweeps against the JAX package's
Pallas sweeps (interpret mode, as tests/test_kernels.py runs them).  The
CUDA kernels themselves are held against these plain versions on the card
by tests/test_torch_gpu.py.

Tolerances: int/min/max/or/and candidates and every per-edge push candidate
are compared bitwise; float sums allclose (rtol 1e-5, atol 1e-7), because
XLA's ``jnp.sum`` adds the 128 slots of a tile in another order than the
kernels' fixed lane-then-tree order."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import engine as JE
from repro.core import fusion as JF
from repro.core import synthesis as JSy
from repro.core import usecases as JU
from repro.graph import structure as JS
from repro.kernels import edge_reduce as JER
from repro_torch.core import engine as TE
from repro_torch.core import fusion as TF
from repro_torch.core import iterate as TI
from repro_torch.core import synthesis as TSy
from repro_torch.core import usecases as TU
from repro_torch.graph import structure as TS
from repro_torch.kernels import edge_reduce as TER
from repro_torch.kernels import ops as TO

DENSITIES = [0.0, 0.05, 0.3, 1.0]
# int min lex (BFS), int min → float max lex (WSP), int sum (NSP), float
# sum (weighted PageRank)
ROUNDS = ["BFS", "WSP", "NSP", "WPR"]


def _round(name, n):
    """(JAX comps, plans), (port comps, plans) of one round."""
    if name == "WPR":
        from repro.core import iterate as JI
        from repro.core.fusion import Prim as JPrim
        from repro_torch.core.fusion import Prim as TPrim
        jk, tk = JSy.weighted_pagerank_kernels(n), \
            TSy.weighted_pagerank_kernels(n)
        jc = JI.CompRuntime(0, "sum", JI.DTYPES["float"], jk.p_fn,
                            jk.init_fn, None, jk.e_fn)
        tc = TI.CompRuntime(0, "sum", TI.DTYPES["float"], tk.p_fn,
                            tk.init_fn, None, tk.e_fn, p_expr=tk.p_expr)
        return ([jc], [JPrim("sum", 0)]), ([tc], [TPrim("sum", 0)])
    jr = JF.fuse(JU.ALL_SPECS[name]()).rounds[-1][1]
    tr = TF.fuse(TU.ALL_SPECS[name]()).rounds[-1][1]
    return JE._round_runtime(jr, JSy.synthesize_round(jr)), \
        TE._round_runtime(tr, TSy.synthesize_round(tr))


def _states(comps, n_pad, seed):
    """Random states per component, a quarter of them ⊥."""
    rng = np.random.default_rng(seed)
    out = {}
    for cr in comps:
        if np.dtype(cr.ident.dtype).kind == "f":
            v = rng.uniform(0.5, 9.0, n_pad).astype(np.float32)
        else:
            v = rng.integers(0, 50, n_pad).astype(np.int32)
        v[rng.random(n_pad) < 0.25] = cr.ident
        out[cr.idx] = v
    return out


def _setup(name, density, seed=3):
    jg = JS.rmat_graph(400, 3200, seed=11)
    tg = TS.from_arrays(jg.n, *jg.host_edges(), device="cpu")
    (jc, jp), (tc, tp) = _round(name, jg.n)
    rnd = TO.sweep_round(tc, tp)
    ell_in = JS.to_blocked_ell(jg)
    n_pad = ell_in.n_pad
    rng = np.random.default_rng(seed)
    active = (rng.random(n_pad) < density).astype(np.int32)
    active[jg.n:] = 0
    outdeg = np.zeros(n_pad, np.float32)
    outdeg[:jg.n] = np.maximum(np.asarray(jg.out_deg), 1)
    wdeg = np.ones(n_pad, np.float32)
    wdeg[:jg.n] = np.asarray(JS.w_out_deg(jg))
    states = _states(jc, n_pad, seed)
    return jg, tg, jc, jp, rnd, active, outdeg, wdeg, states


def _float_sum_levels(rnd):
    return [op == "sum" and rnd.dtypes[pos].is_floating_point
            for spec in rnd.plan_specs for pos, op in spec]


def _assert_levels(got, want, loose):
    for g, w, lz in zip(got, want, loose):
        if lz:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
        else:
            np.testing.assert_array_equal(g, w)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("name", ROUNDS)
def test_pull_plain_matches_pallas(name, density):
    jg, tg, jc, jp, rnd, active, outdeg, wdeg, states = _setup(name, density)
    from repro.kernels.ops import _plan_levels
    levels = tuple(tuple(_plan_levels(p)) for p in jp)
    ell = JS.to_blocked_ell(jg)
    tile_act = JER.tile_activity(ell.srcs, ell.mask, ell.tile_nnz,
                                 jnp.asarray(active), 8, 128)
    by = {cr.idx: cr for cr in jc}
    _red, _hp, want = JER.fused_ell_sweep(
        ell.srcs, ell.weight, ell.capacity, ell.mask, tile_act,
        {c: jnp.asarray(s) for c, s in states.items()}, jnp.asarray(active),
        jnp.asarray(outdeg), plans=levels,
        idents={c: by[c].ident for c in by},
        p_fns={c: by[c].p_fn for c in by}, nv=float(jg.n),
        need_haspred=True, wdeg=jnp.asarray(wdeg), return_candidates=True)
    tell = TS.to_blocked_ell(tg)
    t_tile = TER.tile_activity(tell.nbrs, tell.mask, tell.tile_nnz,
                               _t(active))
    np.testing.assert_array_equal(t_tile.numpy(), np.asarray(tile_act))
    got = TER.pull_sweep(rnd, t_tile, tell.nbrs, tell.weight, tell.capacity,
                         tell.mask, _t(active), _t(outdeg), _t(wdeg),
                         [_t(states[c]) for c in rnd.comps_order],
                         float(jg.n), need_hp=True)
    loose = _float_sum_levels(rnd) + [False] * len(rnd.comps_order)
    _assert_levels([g.numpy() for g in got], [np.asarray(w) for w in want],
                   loose)


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("name", ROUNDS)
def test_push_and_resolve_plain_match_pallas(name, density):
    jg, tg, jc, jp, rnd, active, outdeg, wdeg, states = _setup(name, density)
    from repro.kernels.ops import _plan_levels
    levels = tuple(tuple(_plan_levels(p)) for p in jp)
    ell = JS.to_blocked_ell(jg, direction="out")
    res = JS.to_push_resolution(jg)
    tile_act = JER.tile_activity_push(ell.tile_nnz, jnp.asarray(active), 8)
    res_act = JER.resolution_tile_activity(res.contrib, tile_act,
                                           res.tile_nnz)
    by = {cr.idx: cr for cr in jc}
    want_red, _hp, want = JER.fused_ell_push_sweep(
        ell.nbrs, ell.weight, ell.capacity, ell.mask, tile_act,
        {c: jnp.asarray(s) for c, s in states.items()}, jnp.asarray(active),
        jnp.asarray(outdeg), plans=levels,
        idents={c: by[c].ident for c in by},
        p_fns={c: by[c].p_fn for c in by}, nv=float(jg.n),
        wdeg=jnp.asarray(wdeg), resolution="sorted",
        res=(res.in2out, res.valid, res_act), return_candidates=True)
    tell = TS.to_blocked_ell(tg, direction="out")
    tres = TS.to_push_resolution(tg)
    t_tile = TER.tile_activity_push(tell.tile_nnz, _t(active))
    t_res_act = TER.resolution_tile_activity(tres.contrib, t_tile,
                                             tres.tile_nnz)
    np.testing.assert_array_equal(t_res_act.numpy(), np.asarray(res_act))
    cands = TER.push_sweep(rnd, t_tile, tell.nbrs, tell.weight,
                           tell.capacity, tell.mask, _t(active), _t(outdeg),
                           _t(wdeg), [_t(states[c]) for c in rnd.comps_order],
                           float(jg.n))
    for g, w in zip(cands, want):                 # elementwise: bitwise
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    outs = TER.resolve_sweep(rnd, t_res_act, tres.valid, tres.in2out, cands)
    red, _ = TER._fold_tile_candidates(rnd, outs)
    loose = [rnd.dtypes[rnd.comps_order.index(c)].is_floating_point
             and op == "sum" for spec in rnd.plans for c, op in spec]
    _assert_levels([red[c].numpy() for spec in rnd.plans for c, _ in spec],
                   [np.asarray(want_red[c]) for spec in rnd.plans
                    for c, _ in spec], loose)


@pytest.mark.parametrize("name", ROUNDS)
def test_sorted_push_equals_pull_bitwise(name):
    """With every source active, the resolve sweep over the push candidates
    reproduces the pull sweep's per-tile candidates bit for bit — float sums
    included (same rectangle, same lex chain, same reduction order)."""
    _jg, tg, _jc, _jp, rnd, active, outdeg, wdeg, states = _setup(name, 1.0)
    active[: tg.n] = 1
    st = [_t(states[c]) for c in rnd.comps_order]
    ein = TS.to_blocked_ell(tg)
    eout = TS.to_blocked_ell(tg, direction="out")
    res = TS.to_push_resolution(tg)
    pull = TER.pull_sweep(rnd, TER.tile_activity(ein.nbrs, ein.mask,
                                                 ein.tile_nnz, _t(active)),
                          ein.nbrs, ein.weight, ein.capacity, ein.mask,
                          _t(active), _t(outdeg), _t(wdeg), st, float(tg.n))
    p_tile = TER.tile_activity_push(eout.tile_nnz, _t(active))
    cands = TER.push_sweep(rnd, p_tile, eout.nbrs, eout.weight, eout.capacity,
                           eout.mask, _t(active), _t(outdeg), _t(wdeg), st,
                           float(tg.n))
    got = TER.resolve_sweep(
        rnd, TER.resolution_tile_activity(res.contrib, p_tile, res.tile_nnz),
        res.valid, res.in2out, cands)
    for a, b in zip(got, pull):
        assert torch.equal(a, b)


def test_cpu_tensor_takes_plain_version_and_counts_nothing():
    TER.reset_launches()
    _jg, tg, _jc, _jp, rnd, active, outdeg, wdeg, states = _setup("BFS", 0.3)
    ein = TS.to_blocked_ell(tg)
    TER.pull_sweep(rnd, TER.tile_activity(ein.nbrs, ein.mask, ein.tile_nnz,
                                          _t(active)),
                   ein.nbrs, ein.weight, ein.capacity, ein.mask, _t(active),
                   _t(outdeg), _t(wdeg),
                   [_t(states[c]) for c in rnd.comps_order], float(tg.n))
    assert TER.LAUNCHES == {"pull": 0, "push": 0, "resolve": 0}
