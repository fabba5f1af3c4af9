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


@pytest.mark.parametrize("density", [0.0, 0.05, 1.0])
@pytest.mark.parametrize("name", ROUNDS)
def test_pull_frontier_plain_matches_pallas(name, density):
    """The derived-activity pull (its plain version: ``tile_activity`` then
    ``_pull_plain``) against the reference's ``tile_activity`` and Pallas
    ``_fused_kernel``: candidates, has-pred and the activity array, on a
    graph with empty tiles and rows without a real slot."""
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
    assert bool((tell.tile_nnz == 0).any())
    assert bool((~tell.mask.any(dim=1)).any())
    np.testing.assert_array_equal(tell.tiles_static.numpy(),
                                  (np.asarray(ell.tile_nnz) > 0)
                                  .astype(np.int32))
    got, t_tile = TER.pull_sweep_frontier(
        rnd, tell.tiles_static, tell.nbrs, tell.weight, tell.capacity,
        tell.mask, _t(active), _t(outdeg), _t(wdeg),
        [_t(states[c]) for c in rnd.comps_order], float(jg.n), need_hp=True)
    assert t_tile.dtype == torch.int32
    np.testing.assert_array_equal(t_tile.numpy(), np.asarray(tile_act))
    assert len(got) == rnd.n_levels + len(rnd.comps_order)
    loose = _float_sum_levels(rnd) + [False] * len(rnd.comps_order)
    _assert_levels([g.numpy() for g in got], [np.asarray(w) for w in want],
                   loose)


def _pull_inputs(name, density):
    """The pull side of one round on the RM-XS graph: (rnd, in-layout, the
    arguments after the tile list)."""
    _jg, tg, _jc, _jp, rnd, active, outdeg, wdeg, states = _setup(name,
                                                                  density)
    ein = TS.to_blocked_ell(tg)
    rest = (ein.nbrs, ein.weight, ein.capacity, ein.mask, _t(active),
            _t(outdeg), _t(wdeg), [_t(states[c]) for c in rnd.comps_order],
            float(tg.n))
    return rnd, ein, rest


def test_pull_rejects_tiles_off_the_layout():
    rnd, ein, rest = _pull_inputs("BFS", 0.3)
    tiles = ein.tiles_static
    for bad in (tiles[:-1], tiles[:, :1], tiles.bool()):
        with pytest.raises(ValueError, match="tiles_static must be int32 of "
                                             "the layout's tile grid"):
            TER.pull_sweep_frontier(rnd, bad, *rest)
        with pytest.raises(ValueError, match="tile_act must be int32 of the "
                                             "layout's tile grid"):
            TER.pull_sweep(rnd, bad, *rest)
    with pytest.raises(ValueError,
                       match=f"out needs {rnd.n_levels + 1} arrays"):
        TER.pull_sweep_frontier(rnd, tiles, *rest,
                                out=[torch.empty(1, dtype=torch.int32)])


@pytest.mark.parametrize("mode", ["given", "derived"])
def test_pull_sweep_writes_into_out(mode):
    rnd, ein, rest = _pull_inputs("WSP", 0.3)
    act = TER.tile_activity(ein.nbrs, ein.mask, ein.tile_nnz, rest[4])
    if mode == "given":
        want = TER.pull_sweep(rnd, act, *rest, need_hp=True)
        out = [torch.empty_like(w) for w in want]
        got = TER.pull_sweep(rnd, act, *rest, need_hp=True, out=out)
    else:
        w_outs, w_act = TER.pull_sweep_frontier(rnd, ein.tiles_static, *rest,
                                                need_hp=True)
        want = [*w_outs, w_act]
        out = [torch.empty_like(w) for w in want]
        g_outs, g_act = TER.pull_sweep_frontier(rnd, ein.tiles_static, *rest,
                                                need_hp=True, out=out)
        got = [*g_outs, g_act]
        assert torch.equal(w_act, act)
    assert len(got) == len(out) == rnd.n_levels + len(rnd.comps_order) + \
        (mode == "derived")
    assert all(g is o for g, o in zip(got, out))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


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
    outs = TER.resolve_sweep(rnd, t_res_act, tres.valid, tres.in2out, cands,
                             t_tile, tell.width)
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
        res.valid, res.in2out, cands, p_tile, eout.width)
    for a, b in zip(got, pull):
        assert torch.equal(a, b)


def _push_inputs(name, density):
    """The push side of one round on the RM-XS graph: (rnd, out-layout,
    resolution, push tile activity, resolution tile activity, states, push
    sweep arguments)."""
    _jg, tg, _jc, _jp, rnd, active, outdeg, wdeg, states = _setup(name,
                                                                  density)
    eout = TS.to_blocked_ell(tg, direction="out")
    res = TS.to_push_resolution(tg)
    p_tile = TER.tile_activity_push(eout.tile_nnz, _t(active))
    r_tile = TER.resolution_tile_activity(res.contrib, p_tile, res.tile_nnz)
    st = [_t(states[c]) for c in rnd.comps_order]
    args = (rnd, p_tile, eout.nbrs, eout.weight, eout.capacity, eout.mask,
            _t(active), _t(outdeg), _t(wdeg), st, float(tg.n))
    return rnd, eout, res, p_tile, r_tile, st, args


@pytest.mark.parametrize("name", ROUNDS)
def test_push_sorted_haspred_matches_pallas(name):
    """The push− has-pred of the sorted path, now computed inside the
    resolve sweep over the static resolution-tile activity (every live
    tile), equals the JAX reference's ``hp`` bit for bit."""
    jg, tg, jc, jp, rnd, active, outdeg, wdeg, states = _setup(name, 1.0)
    from repro.kernels.ops import _plan_levels
    levels = tuple(tuple(_plan_levels(p)) for p in jp)
    ell = JS.to_blocked_ell(jg, direction="out")
    res = JS.to_push_resolution(jg)
    ones = np.zeros_like(active)
    ones[:jg.n] = 1
    tiles = (np.asarray(ell.tile_nnz) > 0).astype(np.int32)
    res_act = JER.resolution_tile_activity(res.contrib, jnp.asarray(tiles),
                                           res.tile_nnz)
    by = {cr.idx: cr for cr in jc}
    _red, want_hp = JER.fused_ell_push_sweep(
        ell.nbrs, ell.weight, ell.capacity, ell.mask, jnp.asarray(tiles),
        {c: jnp.asarray(s) for c, s in states.items()}, jnp.asarray(ones),
        jnp.asarray(outdeg), plans=levels,
        idents={c: by[c].ident for c in by},
        p_fns={c: by[c].p_fn for c in by}, nv=float(jg.n),
        need_haspred=True, wdeg=jnp.asarray(wdeg), resolution="sorted",
        res=(res.in2out, res.valid, res_act))
    tell = TS.to_blocked_ell(tg, direction="out")
    tres = TS.to_push_resolution(tg)
    t_tiles = (tell.tile_nnz > 0).to(torch.int32)
    t_res_act = TER.resolution_tile_activity(tres.contrib, t_tiles,
                                             tres.tile_nnz)
    _red, hp = TER.fused_ell_push_sweep(
        rnd, tell.nbrs, tell.weight, tell.capacity, tell.mask, t_tiles,
        {c: _t(s) for c, s in states.items()}, _t(ones), _t(outdeg),
        _t(wdeg), float(tg.n), need_haspred=True, resolution="sorted",
        res=(tres.in2out, tres.valid, t_res_act))
    assert sorted(hp) == sorted(want_hp) == sorted(rnd.comps_order)
    for c in rnd.comps_order:
        np.testing.assert_array_equal(hp[c].numpy(), np.asarray(want_hp[c]))


@pytest.mark.parametrize("density", [0.05, 1.0])
@pytest.mark.parametrize("name", ROUNDS)
def test_push_scatter_matches_pallas(name, density):
    """The scatter resolution (its push buffers identity-filled through
    ``out=``) against the reference's scatter path, has-pred included."""
    jg, tg, jc, jp, rnd, active, outdeg, wdeg, states = _setup(name, density)
    from repro.kernels.ops import _plan_levels
    levels = tuple(tuple(_plan_levels(p)) for p in jp)
    ell = JS.to_blocked_ell(jg, direction="out")
    tile_act = JER.tile_activity_push(ell.tile_nnz, jnp.asarray(active), 8)
    by = {cr.idx: cr for cr in jc}
    want_red, want_hp = JER.fused_ell_push_sweep(
        ell.nbrs, ell.weight, ell.capacity, ell.mask, tile_act,
        {c: jnp.asarray(s) for c, s in states.items()}, jnp.asarray(active),
        jnp.asarray(outdeg), plans=levels,
        idents={c: by[c].ident for c in by},
        p_fns={c: by[c].p_fn for c in by}, nv=float(jg.n),
        need_haspred=True, wdeg=jnp.asarray(wdeg), resolution="scatter")
    tell = TS.to_blocked_ell(tg, direction="out")
    red, hp = TER.fused_ell_push_sweep(
        rnd, tell.nbrs, tell.weight, tell.capacity, tell.mask,
        TER.tile_activity_push(tell.tile_nnz, _t(active)),
        {c: _t(s) for c, s in states.items()}, _t(active), _t(outdeg),
        _t(wdeg), float(tg.n), need_haspred=True, resolution="scatter")
    loose = [rnd.dtypes[rnd.comps_order.index(c)].is_floating_point
             and op == "sum" for spec in rnd.plans for c, op in spec]
    _assert_levels([red[c].numpy() for spec in rnd.plans for c, _ in spec],
                   [np.asarray(want_red[c]) for spec in rnd.plans
                    for c, _ in spec], loose)
    for c in rnd.comps_order:
        np.testing.assert_array_equal(hp[c].numpy(), np.asarray(want_hp[c]))


def _resolve_all_candidates(rnd, tile_act, valid, in2out, cands, states):
    """The resolution as it was before the push activity became an
    argument: every valid slot reads its candidate, whatever tile it is in,
    and the has-pred probe gathers the source rows' states in torch."""
    n_pad, width_out = cands[0].shape
    every = torch.ones((n_pad // TER.BLOCK_V, width_out // TER.BLOCK_E),
                       dtype=torch.int32)
    outs = TER._resolve_plain(rnd, tile_act, valid, in2out, cands, every,
                              width_out)
    src = torch.div(in2out.long(), width_out, rounding_mode="floor")
    live = TER._tiles_to_rows(tile_act)
    for st, ident in zip(states, rnd.idents):
        nb = (valid & (st[src] != ident)).to(torch.int32)
        outs.append(torch.where(live, TER._tile_reduce("max", nb), 0))
    return outs


@pytest.mark.parametrize("density", [0.05, 0.3, 1.0])
@pytest.mark.parametrize("name", ROUNDS)
def test_resolve_push_activity_args_keep_outputs(name, density):
    """With the push tile activity and ``width_out``, the plain resolution
    gives what it gave when it read every candidate of the identity-filled
    push buffer, has-pred included."""
    rnd, eout, res, p_tile, r_tile, st, args = _push_inputs(name, density)
    cands = TER.push_sweep(*args)
    got = TER.resolve_sweep(rnd, r_tile, res.valid, res.in2out, cands,
                            p_tile, eout.width, st, need_hp=True)
    want = _resolve_all_candidates(rnd, r_tile, res.valid, res.in2out, cands,
                                   st)
    assert len(got) == rnd.n_levels + len(rnd.comps_order)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.parametrize("density", [0.05, 0.3])
@pytest.mark.parametrize("name", ROUNDS)
def test_resolve_ignores_poisoned_skipped_tiles(name, density):
    """A push buffer whose skipped tiles hold a NaN payload (as the card
    leaves them undefined) resolves bit for bit like the identity-filled
    one."""
    rnd, eout, res, p_tile, r_tile, st, args = _push_inputs(name, density)
    assert bool((p_tile == 0).any() & (eout.tile_nnz > 0).any())
    cands = TER.push_sweep(*args)
    skipped = ~TER._tiles_to_rows(p_tile).repeat_interleave(TER.BLOCK_E,
                                                            dim=1)
    poison = torch.tensor(0x7fc0dead, dtype=torch.int32)
    poisoned = [torch.where(skipped, poison, c.view(torch.int32))
                .view(c.dtype) for c in cands]
    assert all(not torch.equal(a, b) for a, b in zip(poisoned, cands))
    for c, p in zip(cands, poisoned):
        assert torch.equal(c[~skipped], p[~skipped])
    want = TER.resolve_sweep(rnd, r_tile, res.valid, res.in2out, cands,
                             p_tile, eout.width, st, need_hp=True)
    got = TER.resolve_sweep(rnd, r_tile, res.valid, res.in2out, poisoned,
                            p_tile, eout.width, st, need_hp=True)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_resolve_rejects_push_activity_off_the_out_layout():
    rnd, eout, res, p_tile, r_tile, st, args = _push_inputs("BFS", 0.3)
    cands = TER.push_sweep(*args)
    with pytest.raises(ValueError, match="push_tile_act has shape"):
        TER.resolve_sweep(rnd, r_tile, res.valid, res.in2out, cands,
                          p_tile[:-1], eout.width)
    with pytest.raises(ValueError, match="cands\\[0\\] has shape"):
        TER.resolve_sweep(rnd, r_tile, res.valid, res.in2out, cands,
                          p_tile, eout.width + TER.BLOCK_E)
    with pytest.raises(ValueError, match="not a positive multiple"):
        TER.resolve_sweep(rnd, r_tile, res.valid, res.in2out, cands,
                          p_tile, eout.width - 1)


def test_push_sweep_writes_into_out():
    rnd, _eout, _res, _p, _r, _st, args = _push_inputs("WSP", 0.3)
    want = TER.push_sweep(*args)
    out = [torch.empty_like(c) for c in want]
    got = TER.push_sweep(*args, out=out)
    assert all(g is o for g, o in zip(got, out))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cpu_tensor_takes_plain_version_and_counts_nothing():
    TER.reset_launches()
    _jg, tg, _jc, _jp, rnd, active, outdeg, wdeg, states = _setup("BFS", 0.3)
    ein = TS.to_blocked_ell(tg)
    TER.pull_sweep(rnd, TER.tile_activity(ein.nbrs, ein.mask, ein.tile_nnz,
                                          _t(active)),
                   ein.nbrs, ein.weight, ein.capacity, ein.mask, _t(active),
                   _t(outdeg), _t(wdeg),
                   [_t(states[c]) for c in rnd.comps_order], float(tg.n))
    TER.ell_level_reduce(ein, "min", [rnd.p_exprs[0]],
                         [_t(states[rnd.comps_order[0]])], [rnd.idents[0]],
                         _t(active), _t(outdeg))
    assert TER.LAUNCHES == {"pull": 0, "push": 0, "resolve": 0, "level": 0}
