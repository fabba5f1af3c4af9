"""The port on the card (``gpu`` marker; they skip without a CUDA device).

This module imports neither JAX nor the JAX package, so it also runs on a
machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each CUDA kernel is held against its plain PyTorch version on the same card
tensors: the edge sweeps, the level sweep and the embedding bag bitwise
(float sums included: the plain versions repeat the kernels' reduction
order and the kernels are built with --fmad=false); the ELL softmax within
1e-6 (another summation order) and flash attention within 1e-5 + 1e-5 of
the element in float32 (whole matrix products against the kernel's online
recurrence).  Both compute in float32 and round the result once, so in
bfloat16 they are held to one bfloat16 step of the element (2^-7 of it)
plus that float32 difference; the bfloat16 route's tensor cores take P as
a high and a low bfloat16 part, which keeps it inside that difference, and
the float32 route's take every operand as a high and a low TF32 part
(3xTF32), which keeps it within the float32 limit.
The cuda engine, the adaptive and dense engines and the handwritten kernel
sets are held against the port's pull engine; under ``fallback=True`` an
injected ``RuntimeError`` outside the kernel layer and an out-of-memory
error end on adaptive, while a ``KernelLaunchError`` and a fault inside the
kernel layer (a library without its entry point) propagate."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import engine as TE
from repro_torch.core import fusion as TF
from repro_torch.core import iterate as TI
from repro_torch.core import synthesis as TSy
from repro_torch.core import usecases as TU
from repro_torch.core.fusion import Prim
from repro_torch.graph import structure as TS
from repro_torch.core.kernel_lang import FLT, INT, Bin, Lit, Var
from repro_torch.kernels import edge_reduce as TER
from repro_torch.kernels import embedding_bag as TEB
from repro_torch.kernels import flash_attention as TFA
from repro_torch.kernels import ops as TO
from repro_torch.kernels import segment_softmax as TSS


@pytest.fixture(autouse=True)
def _fresh_program_caches():
    """Overrides the suite's fixture of that name, which clears the JAX
    package's caches: this module clears the port's only."""
    yield
    TE.clear_program_caches()


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import/collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card (README.md)")
    return torch.device("cuda")


def _round(name, n):
    if name == "WPR":
        dk = TSy.weighted_pagerank_kernels(n)
        comp = TI.CompRuntime(0, "sum", TI.DTYPES["float"], dk.p_fn,
                              dk.init_fn, None, dk.e_fn, p_expr=dk.p_expr)
        return TO.sweep_round([comp], [Prim("sum", 0)])
    (rnd,) = [r for _n, r in TF.fuse(TU.ALL_SPECS[name]()).rounds
              if r.leaves]
    return TO.sweep_round(TI.comp_runtimes(rnd, TSy.synthesize_round(rnd)),
                          [leaf.plan for leaf in rnd.leaves])


def _counters(s):
    return (s.iterations, s.push_iters, s.pull_iters, s.edge_work,
            s.resolve_work, s.gather_work)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


_POISON = 0x7fc0dead                 # a NaN payload (as float32)


def _slots_of_tiles(tile_act):
    """[n_i, n_j] tile activity → [n_pad, width] bool per slot."""
    return tile_act.repeat_interleave(8, dim=0) \
        .repeat_interleave(128, dim=1) != 0


def _card_inputs(dev, name, density):
    """The RM-XS graph on the card, one round's sweep shape, a frontier of
    the given density and random states (a quarter ⊥): (g, rnd, active,
    outdeg, wdeg, states)."""
    g = TS.rmat_graph(400, 3200, seed=11, device=dev)
    rnd = _round(name, g.n)
    n_pad = TS.to_blocked_ell(g).n_pad
    rng = np.random.default_rng(3)
    act = torch.from_numpy((rng.random(n_pad) < density).astype(np.int32))
    act[g.n:] = 0
    act = act.to(dev)
    od = torch.ones(n_pad, device=dev)
    od[:g.n] = g.out_deg.clamp(min=1).float()
    wd = torch.ones(n_pad, device=dev)
    wd[:g.n] = TS.w_out_deg(g)
    st = []
    for dt, ident in zip(rnd.dtypes, rnd.idents):
        v = rng.uniform(0.5, 9.0, n_pad).astype(np.float32) \
            if dt == torch.float32 else \
            rng.integers(0, 50, n_pad).astype(np.int32)
        v[rng.random(n_pad) < 0.25] = ident
        st.append(torch.from_numpy(v).to(dev))
    return g, rnd, act, od, wd, st


def _poisoned_like(ts):
    """Buffers of the shapes and dtypes of ``ts``, every word the NaN
    payload."""
    return [torch.full(tuple(t.shape), _POISON, dtype=torch.int32,
                       device=t.device).view(t.dtype) for t in ts]


@pytest.mark.gpu
@pytest.mark.parametrize("density", [0.0, 0.05, 1.0])
@pytest.mark.parametrize("name", ["BFS", "WSP", "WPR"])
def test_pull_frontier_matches_plain_on_card(cuda_device, name, density):
    """The derived-activity pull against its plain version (the torch
    ``tile_activity``, then ``_pull_plain``), bitwise: candidates, has-pred
    and the activity array, into fresh buffers and into buffers poisoned
    with a NaN payload (every word must be overwritten: the walk writes the
    static tiles, the grid-stride pass the empty ones).  The given-activity
    pull from poisoned buffers too."""
    dev = cuda_device
    g, rnd, act, od, wd, st = _card_inputs(dev, name, density)
    e = TS.to_blocked_ell(g)
    assert bool((e.tile_nnz == 0).any())
    args = (e.nbrs, e.weight, e.capacity, e.mask, act, od, wd, st,
            float(g.n))
    TER.reset_launches()
    outs, t_act = TER.pull_sweep_frontier(rnd, e.tiles_static, *args,
                                          need_hp=True)
    torch.cuda.synchronize()
    assert TER.LAUNCHES["pull"] == 1
    want_act = TER.tile_activity(e.nbrs, e.mask, e.tile_nnz, act)
    want = TER._pull_plain(rnd, want_act, *args, True)
    assert len(outs) == len(want) == rnd.n_levels + len(rnd.comps_order)
    assert t_act.dtype == torch.int32 and torch.equal(t_act, want_act)
    for a, b in zip(outs, want):
        assert torch.equal(_bits(a), _bits(b))
    p_outs, p_act = TER.pull_sweep_frontier(
        rnd, e.tiles_static, *args, need_hp=True,
        out=_poisoned_like([*outs, t_act]))
    g_outs = TER.pull_sweep(rnd, want_act, *args, need_hp=True,
                            out=_poisoned_like(outs))
    torch.cuda.synchronize()
    assert TER.LAUNCHES["pull"] == 3
    assert torch.equal(p_act, want_act)
    for a, b, c in zip(p_outs, g_outs, want):
        assert torch.equal(_bits(a), _bits(c))
        assert torch.equal(_bits(b), _bits(c))


@pytest.mark.gpu
@pytest.mark.parametrize("density", [0.05, 1.0])
@pytest.mark.parametrize("name", ["BFS", "WSP", "WPR"])
def test_kernels_match_plain_on_card(cuda_device, name, density):
    """Pull in full; push on the tiles it runs (a skipped tile's candidates
    are undefined on the card); resolve and its has-pred in full, once from
    a fresh push buffer and once from one poisoned with a NaN payload before
    the push launch."""
    dev = cuda_device
    g, rnd, act, od, wd, st = _card_inputs(dev, name, density)
    _check_sweeps(rnd, act, od, wd, st, float(g.n), TS.to_blocked_ell(g),
                  TS.to_blocked_ell(g, direction="out"),
                  TS.to_push_resolution(g))


def _check_sweeps(rnd, act, od, wd, st, nv, ein, eout, res):
    """The pull, push and resolve kernels on layouts ``ein`` / ``eout`` and
    resolution ``res`` against their plain versions (the body of
    ``test_kernels_match_plain_on_card``)."""
    dev = act.device
    t_in = TER.tile_activity(ein.nbrs, ein.mask, ein.tile_nnz, act)
    t_out = TER.tile_activity_push(eout.tile_nnz, act)
    t_res = TER.resolution_tile_activity(res.contrib, t_out, res.tile_nnz)
    pull_args = (rnd, t_in, ein.nbrs, ein.weight, ein.capacity, ein.mask,
                 act, od, wd, st, nv, True)
    push_args = (rnd, t_out, eout.nbrs, eout.weight, eout.capacity,
                 eout.mask, act, od, wd, st, nv)
    res_args = (res.valid, res.in2out)
    res_kw = dict(push_tile_act=t_out, width_out=eout.width, states=st,
                  need_hp=True)
    TER.reset_launches()
    k_pull = TER.pull_sweep(*pull_args)
    k_push = TER.push_sweep(*push_args)
    k_res = TER.resolve_sweep(rnd, t_res, *res_args, k_push, **res_kw)
    torch.cuda.synchronize()
    assert TER.LAUNCHES == {"pull": 1, "push": 1, "resolve": 1, "level": 0}
    p_pull = TER._pull_plain(*pull_args)
    p_push = TER._push_plain(*push_args)
    p_res = TER._resolve_plain(rnd, t_res, *res_args, p_push, **res_kw)
    assert len(k_res) == rnd.n_levels + len(rnd.comps_order)
    for a, b in zip(k_pull + k_res, p_pull + p_res):
        assert torch.equal(_bits(a), _bits(b))
    ran = _slots_of_tiles(t_out)
    for a, b in zip(k_push, p_push):
        assert torch.equal(_bits(a)[ran], _bits(b)[ran])
    poisoned = [torch.full(tuple(eout.nbrs.shape), _POISON, dtype=torch.int32,
                           device=dev).view(dt) for dt in rnd.dtypes]
    k_push = TER.push_sweep(*push_args, out=poisoned)
    k_res = TER.resolve_sweep(rnd, t_res, *res_args, k_push, **res_kw)
    torch.cuda.synchronize()
    for a, b in zip(k_push, p_push):
        assert torch.equal(_bits(a)[ran], _bits(b)[ran])
        assert bool((_bits(a)[~ran] == _POISON).all())   # left untouched
    for a, b in zip(k_res, p_res):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.gpu
@pytest.mark.parametrize("resolution", ["sorted", "scatter"])
def test_push_resolutions_match_pull_engine_on_card(cuda_device, resolution):
    """Both push resolutions give the pull engine's answer: BFS bitwise,
    weighted PageRank under push− allclose."""
    g = TS.rmat_graph(400, 3200, seed=11, device=cuda_device)
    prog = TF.fuse(TU.ALL_SPECS["BFS"]())
    TER.reset_launches()
    got = TE.run_program(g, prog, engine="cuda", push_resolution=resolution)
    torch.cuda.synchronize()
    assert got.stats.push_iters > 0 and TER.LAUNCHES["push"] > 0
    assert TER.LAUNCHES["resolve"] == (TER.LAUNCHES["push"]
                                       if resolution == "sorted" else 0)
    want = TE.run_program(g, prog, engine="pull")
    assert torch.equal(got.value, want.value)
    dk = TSy.weighted_pagerank_kernels(g.n)
    push = TE.run_direct(g, dk, engine="cuda", model="push",
                         push_resolution=resolution)
    pull = TE.run_direct(g, dk, engine="pull")
    assert push.stats.iterations == pull.stats.iterations
    torch.testing.assert_close(push.value, pull.value, rtol=1e-5, atol=1e-8)


@pytest.mark.gpu
def test_resolve_wrapper_rejects_off_layout_push_activity(cuda_device):
    g = TS.rmat_graph(64, 256, seed=1, device=cuda_device)
    rnd = _round("BFS", g.n)
    e = TS.to_blocked_ell(g, direction="out")
    res = TS.to_push_resolution(g)
    act = torch.ones(e.n_pad, dtype=torch.int32, device=cuda_device)
    od = torch.ones(e.n_pad, device=cuda_device)
    st = [torch.zeros(e.n_pad, dtype=dt, device=cuda_device)
          for dt in rnd.dtypes]
    t_out = TER.tile_activity_push(e.tile_nnz, act)
    cands = TER.push_sweep(rnd, t_out, e.nbrs, e.weight, e.capacity, e.mask,
                           act, od, od, st, float(g.n))
    t_res = TER.resolution_tile_activity(res.contrib, t_out, res.tile_nnz)
    with pytest.raises(ValueError, match="push_tile_act has shape"):
        TER.resolve_sweep(rnd, t_res, res.valid, res.in2out, cands,
                          t_out[:, :0], e.width)
    with pytest.raises(ValueError, match="has shape"):
        TER.resolve_sweep(rnd, t_res, res.valid, res.in2out, cands, t_out,
                          e.width * 2)
    with pytest.raises(ValueError, match="push_tile_act must be torch.int32"):
        TER.resolve_sweep(rnd, t_res, res.valid, res.in2out, cands,
                          t_out.bool(), e.width)
    with pytest.raises(ValueError, match="out\\[0\\] must have shape"):
        TER.push_sweep(rnd, t_out, e.nbrs, e.weight, e.capacity, e.mask,
                       act, od, od, st, float(g.n),
                       out=[c[:-8] for c in cands])


@pytest.mark.gpu
def test_wrapper_rejects_bad_card_tensors(cuda_device):
    g = TS.rmat_graph(64, 256, seed=1, device=cuda_device)
    rnd = _round("BFS", g.n)
    e = TS.to_blocked_ell(g)
    act = torch.ones(e.n_pad, dtype=torch.int32, device=cuda_device)
    od = torch.ones(e.n_pad, device=cuda_device)
    st = [torch.zeros(e.n_pad, dtype=dt, device=cuda_device)
          for dt in rnd.dtypes]
    tile = TER.tile_activity(e.nbrs, e.mask, e.tile_nnz, act)
    with pytest.raises(ValueError, match="srcs must be torch.int32"):
        TER.pull_sweep(rnd, tile, e.nbrs.long(), e.weight, e.capacity,
                       e.mask, act, od, od, st, float(g.n))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        TER.pull_sweep(rnd, tile, e.nbrs, e.weight.cpu(), e.capacity,
                       e.mask, act, od, od, st, float(g.n))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["BFS", "SSSP", "WSP"])
def test_cuda_engine_on_card_matches_pull(cuda_device, name):
    g = TS.rmat_graph(400, 3200, seed=11, device=cuda_device)
    prog = TF.fuse(TU.ALL_SPECS[name]())
    TER.reset_launches()
    got = TE.run_program(g, prog, engine="cuda")
    torch.cuda.synchronize()
    assert TER.LAUNCHES["pull"] > 0 and TER.LAUNCHES["push"] > 0
    assert TER.LAUNCHES["resolve"] == TER.LAUNCHES["push"]
    assert TER.LAUNCHES["pull"] == got.stats.pull_iters
    want = TE.run_program(g, prog, engine="pull")
    assert torch.equal(got.value, want.value)
    assert got.stats.engine_used == "cuda"
    # the same query on the plain versions: equal answer and counters
    cpu = TE.run_program(TS.from_arrays(g.n, *g.host_edges(), device="cpu"),
                         prog, engine="cuda", device="cpu")
    assert torch.equal(got.value.cpu(), cpu.value)
    assert _counters(got.stats) == _counters(cpu.stats)


@pytest.mark.gpu
def test_weighted_pagerank_push_equals_pull_on_card(cuda_device):
    g = TS.rmat_graph(400, 3200, seed=11, device=cuda_device)
    dk = TSy.weighted_pagerank_kernels(g.n)
    pull = TE.run_direct(g, dk, engine="cuda")
    push = TE.run_direct(g, dk, engine="cuda", model="push")
    assert torch.equal(_bits(pull.value), _bits(push.value))
    ref = TE.run_direct(g, dk, engine="pull")
    torch.testing.assert_close(pull.value, ref.value, rtol=1e-5, atol=1e-8)


# ---------------------------------------------------------------------------
# The adaptive and dense engines, the handwritten kernel sets and the
# fallback chain.
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["adaptive", "dense"])
@pytest.mark.parametrize("name", ["BFS", "SSSP", "WSP", "WP", "CC"])
def test_reference_engines_on_card_match_pull(cuda_device, name, engine):
    g = TS.rmat_graph(400, 3200, seed=11, device=cuda_device)
    if name == "CC":
        g = TS.undirected(g)
    prog = TF.fuse(TU.ALL_SPECS[name]())
    got = TE.run_program(g, prog, engine=engine)
    want = TE.run_program(g, prog, engine="pull")
    assert torch.equal(_bits(got.value), _bits(want.value))
    assert (got.stats.engine_used, got.stats.fallbacks) == (engine, ())
    assert got.value.device.type == "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["adaptive", "dense"])
def test_reference_engines_on_card_pagerank(cuda_device, engine):
    g = TS.rmat_graph(400, 3200, seed=11, device=cuda_device)
    dk = TSy.pagerank_kernels(g.n)
    got = TE.run_direct(g, dk, engine=engine)
    want = TE.run_direct(g, dk, engine="pull")
    torch.testing.assert_close(got.value, want.value, rtol=1e-5, atol=1e-8)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["SSSP", "BFS", "WP", "CC"])
def test_handwritten_sets_on_card_match_pull(cuda_device, name):
    g = TS.rmat_graph(400, 3200, seed=11, device=cuda_device)
    if name == "CC":
        g = TS.undirected(g)
    dk = TU.HANDWRITTEN[name]()
    TER.reset_launches()
    got = TE.run_direct(g, dk, engine="cuda")
    torch.cuda.synchronize()
    assert TER.LAUNCHES["pull"] == got.stats.pull_iters > 0
    assert TER.LAUNCHES["push"] == got.stats.push_iters
    want = TE.run_direct(g, dk, engine="pull")
    assert torch.equal(_bits(got.value), _bits(want.value))
    assert (got.stats.engine_used, got.stats.fallbacks) == ("cuda", ())


@pytest.mark.gpu
def test_fallback_on_card_ends_on_adaptive(cuda_device, monkeypatch):
    g = TS.rmat_graph(400, 3200, seed=11, device=cuda_device)
    prog = TF.fuse(TU.ALL_SPECS["SSSP"]())
    want = TE.run_program(g, prog, engine="cuda")

    def boom(*a, **k):
        raise RuntimeError("injected fault")

    monkeypatch.setattr(TO, "iterate_cuda", boom)
    got = TE.run_program(g, prog, engine="cuda", fallback=True)
    assert got.stats.engine_used == "adaptive"
    assert got.stats.fallbacks == (
        ("cuda", "adaptive", "RuntimeError: injected fault"),)
    assert torch.equal(_bits(got.value), _bits(want.value))


@pytest.mark.gpu
def test_kernel_launch_error_propagates_on_card(cuda_device, monkeypatch):
    from repro_torch.core.guard import KernelLaunchError
    g = TS.rmat_graph(400, 3200, seed=11, device=cuda_device)
    calls = []

    def boom(*a, **k):
        calls.append(1)
        raise KernelLaunchError("CUDA pull kernel launch failed: "
                                "cudaError 700")

    monkeypatch.setattr(TO, "iterate_cuda", boom)
    with pytest.raises(KernelLaunchError, match="cudaError 700"):
        TE.run_direct(g, TU.HANDWRITTEN["SSSP"](), engine="cuda",
                      fallback=True)
    assert calls == [1]


@pytest.mark.gpu
def test_out_of_memory_fallback_on_card(cuda_device, monkeypatch):
    """An out-of-memory error inside the kernel layer takes the chain."""
    g = TS.rmat_graph(400, 3200, seed=11, device=cuda_device)
    prog = TF.fuse(TU.ALL_SPECS["SSSP"]())
    want = TE.run_program(g, prog, engine="cuda")

    def boom(*a, **k):
        raise torch.OutOfMemoryError("CUDA out of memory (injected)")

    monkeypatch.setattr(TO, "sweep_round", boom)
    got = TE.run_program(g, prog, engine="cuda", fallback=True)
    assert got.stats.engine_used == "adaptive"
    assert got.stats.fallbacks == (
        ("cuda", "adaptive",
         "OutOfMemoryError: CUDA out of memory (injected)"),)
    assert torch.equal(_bits(got.value), _bits(want.value))


@pytest.mark.gpu
def test_kernel_layer_fault_propagates_on_card(cuda_device, monkeypatch):
    """A round library without its entry points fails in the launch
    wrapper; the cuda engine raises that as a ``KernelLaunchError``, which
    the chain never takes."""
    from repro_torch.core.guard import KernelLaunchError
    g = TS.rmat_graph(400, 3200, seed=11, device=cuda_device)
    monkeypatch.setattr(TER.SweepRound, "library", lambda self: object())
    with pytest.raises(KernelLaunchError,
                       match="the cuda engine failed: AttributeError") as e:
        TE.run_direct(g, TU.HANDWRITTEN["SSSP"](), engine="cuda",
                      fallback=True)
    assert isinstance(e.value.__cause__, AttributeError)


# ---------------------------------------------------------------------------
# The level sweep, ELL softmax, embedding bag and flash attention.
# ---------------------------------------------------------------------------

def _rng_tensor(rng, shape, dev, dtype=torch.float32, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale)
                            .astype(np.float32)).to(dev, dtype)


def _level_inputs(dev, n_pad, n):
    """Frontier, degrees, the lex cases' prior state and the cases (op, P
    per level, states, identities, mode) of the level tests, for a layout
    of ``n_pad`` rows."""
    rng = np.random.default_rng(5)
    act = torch.from_numpy((rng.random(n_pad) < 0.7).astype(np.int32)) \
        .to(dev)
    od = torch.from_numpy(rng.integers(1, 5, n_pad).astype(np.float32)) \
        .to(dev)
    inf = float("inf")
    s_int = torch.from_numpy(rng.integers(0, 50, n_pad).astype(np.int32))
    s_int[rng.random(n_pad) < 0.2] = 2 ** 30 - 1
    s_max = torch.from_numpy(rng.integers(0, 9, n_pad).astype(np.float32))
    s_max[rng.random(n_pad) < 0.2] = -inf
    s_min = torch.from_numpy(rng.uniform(0, 9, n_pad).astype(np.float32))
    s_min[rng.random(n_pad) < 0.2] = inf
    # +0.0 and -0.0 states (⊥ where the sum's ⊥ is ±0.0) beside negative and
    # positive ones, whose n · 0 is -0.0 and +0.0
    s_pm0 = torch.from_numpy(rng.choice(
        np.array([0.0, -0.0, -1.5, -2.0, 3.0], np.float32), n_pad))
    s_prod = torch.from_numpy(rng.uniform(0.5, 1.5, n_pad)
                              .astype(np.float32))
    s_int, s_max, s_min, s_pm0, s_prod = (
        t.to(dev) for t in (s_int, s_max, s_min, s_pm0, s_prod))
    n1 = Bin("+", Var("n", INT), Lit(1, INT))
    nw = Bin("+", Var("n", FLT), Var("w", FLT))
    nc = Bin("min", Var("n", FLT), Var("c", FLT))
    pr = Bin("/", Var("n", FLT), Var("outdeg", FLT))
    n0 = Bin("*", Var("n", FLT), Lit(0.0, FLT))
    return act, od, s_max, [
        ("min", [n1], [s_int], [2 ** 30 - 1], "value"),
        ("min", [nw], [s_min], [inf], "value"),
        ("sum", [pr], [s_min.clamp(max=5.0)], [0.0], "value"),
        # a sum whose ⊥ is not 0 and a product whose ⊥ is not 1 visit the
        # empty tiles too
        ("sum", [pr], [s_min.clamp(max=5.0)], [0.5], "value"),
        ("prod", [pr], [s_prod], [2.0], "value"),
        # float sums of ±0.0 from a +0.0 and from a -0.0 identity
        ("sum", [n0], [s_pm0], [0.0], "value"),
        ("sum", [n0], [s_pm0], [-0.0], "value"),
        ("min", [nc, nw], [s_max, s_min], [-inf, inf], "value"),
        ("min", [n1, nw], [s_int, s_min], [2 ** 30 - 1, inf], "nonbot")]


def _check_level_cases(e, n, act, od, s_max, cases):
    """Every case on layout ``e``, bitwise against the plain version; the
    lex cases' prior level is the plain version's best of max min(n, c)."""
    n_pad = e.n_pad
    ones = torch.ones_like(od[:n_pad])
    nc = Bin("min", Var("n", FLT), Var("c", FLT))
    b0 = TER._level_plain("max", [nc], [s_max[:n_pad]], [-float("inf")],
                          e.srcs, e.weight, e.capacity, e.mask, act[:n_pad],
                          od[:n_pad], ones, [], "value", float(n))
    for op, ps, states, idents, mode in cases:
        states = [st[:n_pad] for st in states]
        bests = [] if len(ps) == 1 else [
            b0 if states[0].dtype == torch.float32 else b0.to(torch.int32)]
        got = TER.ell_level_reduce(e, op, ps, states, idents, act[:n_pad],
                                   od[:n_pad], bests=bests, mode=mode)
        torch.cuda.synchronize()
        want = TER._level_plain(
            op if mode == "value" else "max", ps, states, idents, e.srcs,
            e.weight, e.capacity, e.mask, act[:n_pad], od[:n_pad], ones,
            bests, mode, float(n))
        assert got.dtype == want.dtype
        assert torch.equal(_bits(got), _bits(want)), (e.block_v, e.block_e,
                                                      op, idents, mode)


@pytest.mark.gpu
def test_level_kernel_matches_plain_on_card(cuda_device):
    """Bitwise, on layouts tiled at (8, 128), (16, 128) and (8, 256): the
    walk skips the tiles that the layout's tile counts call empty."""
    dev = cuda_device
    g = TS.rmat_graph(400, 3200, seed=11, device=dev)
    act, od, s_max, cases = _level_inputs(dev, TS.to_blocked_ell(g).n_pad,
                                          g.n)
    TER.reset_launches()
    for bv, be in ((8, 128), (16, 128), (8, 256)):
        e = TS.to_blocked_ell(g, block_v=bv, block_e=be)
        assert bool((e.tile_nnz == 0).any())
        _check_level_cases(e, g.n, act, od, s_max, cases)
    assert TER.LAUNCHES["level"] == 3 * len(cases)


def _hub_layout(dev):
    """An rmat layout plus a hub whose row spans over 20 slot tiles, four
    of them emptied (mask and tile counts) between non-empty ones."""
    base = TS.rmat_graph(600, 3000, seed=12, device=dev)
    src, dst, w, c = (np.asarray(a) for a in base.host_edges())
    rng = np.random.default_rng(13)
    hub = rng.integers(0, 600, 2750).astype(src.dtype)
    g = TS.from_edges(600, np.concatenate([src, hub]),
                      np.concatenate([dst, np.full(2750, 37, dst.dtype)]),
                      np.concatenate([w, rng.uniform(0.5, 2.0, 2750)
                                      .astype(np.float32)]),
                      np.concatenate([c, rng.uniform(0.5, 2.0, 2750)
                                      .astype(np.float32)]), device=dev)
    e = TS.to_blocked_ell(g)
    mask = e.mask.clone()
    mask[37, 5 * 128:9 * 128] = False
    n_i, n_j = e.n_pad // 8, e.width // 128
    nnz = mask.view(n_i, 8, n_j, 128).sum((1, 3), dtype=torch.int32)
    e = dataclasses.replace(e, mask=mask, tile_nnz=nnz.contiguous())
    return g, e


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["hub", "one slot tile"])
def test_level_walk_matches_plain_on_card(cuda_device, layout):
    """The walk where one row tile holds most of the work (a hub row of over
    20 slot tiles, four of them empty between non-empty ones) and where every
    row is one slot tile (n_j = 1, the uniform layouts); bitwise."""
    dev = cuda_device
    if layout == "hub":
        g, e = _hub_layout(dev)
        hub_tiles = e.tile_nnz[37 // 8] > 0
        assert int(hub_tiles.nonzero().max()) >= 20
        assert not bool(hub_tiles[5:9].any()) and bool(hub_tiles[9:].all())
    else:
        g = TS.uniform_graph(3000, 12000, seed=14, device=dev)
        e = TS.to_blocked_ell(g)
        assert e.width == 128
    act, od, s_max, cases = _level_inputs(dev, e.n_pad, g.n)
    TER.reset_launches()
    _check_level_cases(e, g.n, act, od, s_max, cases)
    assert TER.LAUNCHES["level"] == len(cases)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ell_softmax_kernel_matches_plain_on_card(cuda_device, dtype):
    dev = cuda_device
    e = TS.to_blocked_ell(TS.rmat_graph(400, 3200, seed=11, device=dev))
    rng = np.random.default_rng(6)
    mask = e.mask.clone()
    mask[5] = False
    for scale in (5.0, 1e4):
        scores = _rng_tensor(rng, tuple(mask.shape), dev, dtype, scale)
        TSS.reset_launches()
        got = TSS.ell_softmax(scores, mask)
        torch.cuda.synchronize()
        assert TSS.LAUNCHES["softmax"] == 1
        want = TSS._softmax_plain(scores, mask)
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        assert bool((got[~mask] == 0).all())
        rtol = 0.0 if dtype == torch.float32 else 2.0 ** -7
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 8])
def test_embedding_bag_kernel_matches_plain_on_card(cuda_device, dtype, k):
    dev = cuda_device
    rng = np.random.default_rng(k)
    v = 1000
    table = _rng_tensor(rng, (v, 64), dev, dtype)
    idx = torch.from_numpy(rng.integers(-v - 5, v + 5, (300, k))
                           .astype(np.int32)).to(dev)
    w = _rng_tensor(rng, (300, k), dev)
    TEB.reset_launches()
    for mode, weights in (("sum", None), ("mean", None), ("sum", w),
                          ("mean", w)):
        got = TEB.embedding_bag(table, idx, weights=weights, mode=mode)
        torch.cuda.synchronize()
        want = TEB._bag_plain(table, idx, weights, mode)
        assert got.dtype == dtype
        assert torch.equal(got, want), (mode, weights is None)
    assert TEB.LAUNCHES["bag"] == 4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [
    (torch.float32, 1), (torch.float32, 3), (torch.float32, 4),
    (torch.float32, 64), (torch.float32, 65), (torch.float32, 128),
    (torch.bfloat16, 8), (torch.bfloat16, 12), (torch.bfloat16, 64)])
def test_embedding_bag_paths_match_plain_on_card(cuda_device, dtype, d):
    """The vector path (16 bytes a thread) where D allows it, the scalar
    path elsewhere, at K in {1, 3, 8, 9} (chunks of 8 slots), bitwise."""
    dev = cuda_device
    rng = np.random.default_rng(d)
    v, b = 500, 301
    table = _rng_tensor(rng, (v, d), dev, dtype)
    vec = 16 // table.element_size()
    assert TEB.vector_width(table) == (vec if d % vec == 0 else 1)
    TEB.reset_launches()
    for k in (1, 3, 8, 9):
        idx = torch.from_numpy(rng.integers(-v - 5, v + 5, (b, k))
                               .astype(np.int32)).to(dev)
        w = _rng_tensor(rng, (b, k), dev)
        for mode, weights in (("sum", None), ("mean", None), ("sum", w)):
            got = TEB.embedding_bag(table, idx, weights=weights, mode=mode)
            torch.cuda.synchronize()
            want = TEB._bag_plain(table, idx, weights, mode)
            assert got.dtype == dtype
            assert torch.equal(got, want), (k, mode, weights is None)
    assert TEB.LAUNCHES["bag"] == 12


@pytest.mark.gpu
def test_embedding_bag_unaligned_tables_on_card(cuda_device):
    """Table views whose base is not 16-byte aligned take the scalar path:
    rows [1:] of a D = 3 table, and a D = 4 table 4 bytes into its
    storage."""
    dev = cuda_device
    rng = np.random.default_rng(21)
    flat = _rng_tensor(rng, (4 * 300 + 1,), dev)
    for table in (_rng_tensor(rng, (300, 3), dev)[1:],
                  flat[1:].view(300, 4)):
        assert table.data_ptr() % 16 != 0
        assert TEB.vector_width(table) == 1
        idx = torch.from_numpy(rng.integers(0, table.shape[0], (77, 9))
                               .astype(np.int32)).to(dev)
        w = _rng_tensor(rng, (77, 9), dev)
        for mode, weights in (("sum", None), ("mean", w)):
            got = TEB.embedding_bag(table, idx, weights=weights, mode=mode)
            torch.cuda.synchronize()
            assert torch.equal(got, TEB._bag_plain(table, idx, weights,
                                                   mode))


_FLASH_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-4)}
_FLASH_ROUTE = {torch.float32: "flash_f32", torch.bfloat16: "flash_sm90"}


def _flash_case(dev, dtype, seed, b, h, hkv, s, t, d, causal, chunk,
                qscale=1.0):
    """One call against the plain version, on the route its dtype takes,
    held to the smoke's limits (rtol, atol) = _FLASH_TOL[dtype]; float32
    against the plain version in float64."""
    rng = np.random.default_rng(seed)
    q = _rng_tensor(rng, (b, h, s, d), dev, dtype, qscale)
    k = _rng_tensor(rng, (b, hkv, t, d), dev, dtype)
    v = _rng_tensor(rng, (b, hkv, t, d), dev, dtype)
    TFA.reset_launches()
    got = TFA.flash_attention(q, k, v, causal=causal, chunk=chunk)
    torch.cuda.synchronize()
    route = _FLASH_ROUTE[dtype]
    assert TFA.LAUNCHES == {"flash": 1, "flash_sm90": 0, "flash_f32": 0,
                            route: 1}
    if dtype == torch.float32:
        # the function's value: the plain version in float64 (in float32
        # its own products are 1.4 times the limit off it at qscale 8,
        # D = 128, so no float32 kernel could be held to it there)
        want = TFA._flash_plain(q.double(), k.double(), v.double(), causal,
                                chunk)
    else:
        want = TFA._flash_plain(q, k, v, causal, chunk).float()
    rtol, atol = _FLASH_TOL[dtype]
    assert got.dtype == dtype
    torch.testing.assert_close(got.to(want.dtype), want, rtol=rtol,
                               atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,s,t,d,causal,chunk", [
    (4, 4, 64, 64, 32, True, None), (4, 2, 200, 200, 128, True, None),
    (8, 1, 256, 256, 64, False, None), (2, 2, 130, 130, 16, True, 32),
    (4, 2, 48, 80, 128, True, None)])
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, h, hkv, s,
                                            t, d, causal, chunk):
    _flash_case(cuda_device, dtype, s + d, 2, h, hkv, s, t, d, causal, chunk)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,t,d,causal,chunk,qscale", [
    (2, 4, 2, 1, 80, 16, True, None, 1.0),         # one query row
    (1, 4, 4, 63, 80, 32, True, None, 1.0),        # ragged S and T
    (2, 4, 1, 65, 80, 64, False, None, 1.0),
    (1, 4, 2, 200, 80, 128, True, None, 1.0),      # S > T
    (2, 2, 1, 80, 200, 32, True, None, 1.0),       # S < T
    (1, 2, 1, 4097, 4096, 128, True, None, 1.0),   # one row past a tile
    (1, 4, 2, 100, 40, 64, True, None, 1.0),       # T < 64
    (1, 4, 4, 30, 30, 16, False, None, 1.0),
    (2, 8, 2, 300, 300, 128, True, 48, 1.0),       # chunk not a tile
    (1, 4, 1, 256, 256, 32, False, 48, 1.0),
    (1, 2, 2, 4096, 4096, 128, True, 1024, 1.0),
    (2, 4, 2, 256, 256, 128, True, None, 8.0),     # peaked softmax
    (1, 4, 4, 129, 129, 64, True, None, 8.0),
    (1, 6, 3, 200, 333, 16, True, 48, 8.0)])
def test_flash_sm90_kernel_matches_plain_on_card(cuda_device, dtype, b, h,
                                                 hkv, s, t, d, causal, chunk,
                                                 qscale):
    """Both tensor-core routes (bfloat16 and float32's 3xTF32) at every head
    dim, ragged S and T, Hkv in {1, 2, H}, chunks that cut KV tiles, and
    peaked softmaxes."""
    _flash_case(cuda_device, dtype, s + 7 * t + d, b, h, hkv, s, t, d,
                causal, chunk, qscale)


@pytest.mark.gpu
def test_fixed_wrappers_reject_bad_card_tensors(cuda_device):
    dev = cuda_device
    table = torch.zeros((10, 8), device=dev)
    idx = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="idx must be torch.int32"):
        TEB.embedding_bag(table, idx.long())
    with pytest.raises(ValueError, match="table must be contiguous"):
        TEB.embedding_bag(torch.zeros((8, 10), device=dev).T, idx)
    with pytest.raises(ValueError, match="weights must have"):
        TEB.embedding_bag(table, idx, weights=torch.ones((4, 3), device=dev))
    scores = torch.zeros((16, 128), device=dev)
    mask = torch.ones((16, 128), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="mask must be torch.bool"):
        TSS.ell_softmax(scores, mask.int())
    with pytest.raises(ValueError, match="scores must be float32"):
        TSS.ell_softmax(scores.half(), mask)
    with pytest.raises(ValueError, match="scores must be contiguous"):
        TSS.ell_softmax(torch.zeros((128, 16), device=dev).T, mask)
    q = torch.zeros((1, 4, 16, 32), device=dev)
    kv = torch.zeros((1, 2, 16, 32), device=dev)
    with pytest.raises(ValueError, match="k must be torch.float32"):
        TFA.flash_attention(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError, match="head dim 48"):
        z = torch.zeros((1, 2, 16, 48), device=dev)
        TFA.flash_attention(z, z, z)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        TFA.flash_attention(q, torch.zeros((1, 3, 16, 32), device=dev),
                            torch.zeros((1, 3, 16, 32), device=dev))
    with pytest.raises(ValueError, match="q must be contiguous"):
        TFA.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                            kv, kv)
    g = TS.rmat_graph(64, 256, seed=1, device=dev)
    e = TS.to_blocked_ell(g)
    st = torch.zeros(e.n_pad, device=dev)
    od = torch.ones(e.n_pad, device=dev)
    act = torch.ones(e.n_pad, dtype=torch.int32, device=dev)
    p = Bin("+", Var("n", FLT), Var("w", FLT))
    with pytest.raises(ValueError, match="state\\[0\\] must be float32 or "
                                         "int32"):
        TER.ell_level_reduce(e, "min", [p], [st.double()], [0.0], act, od)
    with pytest.raises(ValueError, match="outdeg must have shape"):
        TER.ell_level_reduce(e, "min", [p], [st], [0.0], act, od[:-8])
    with pytest.raises(ValueError, match="1 bests"):
        TER.ell_level_reduce(e, "min", [p, p], [st, st], [0.0, 0.0], act, od)


# ---------------------------------------------------------------------------
# Chunked, checkpointed and warm-started fixpoints on the card
# ---------------------------------------------------------------------------

_CHUNKED = {"BFS": ("auto", 2), "WPR push": ("push", 10)}


def _chunk_query(name, g, **kw):
    """``ops.iterate_cuda`` for BFS depth (direction switch) or weighted
    PageRank (push−), with the three sweep kernels' launches it made."""
    dk = (TU.handwritten_bfs_depth(0) if name == "BFS"
          else TSy.weighted_pagerank_kernels(g.n))
    comp = TI.CompRuntime(0, dk.rop, TI.DTYPES[dk.dtype], dk.p_fn,
                          dk.init_fn, dk.source, dk.e_fn, p_expr=dk.p_expr)
    TER.reset_launches()
    r = TO.iterate_cuda(g, [comp], [Prim(dk.rop, 0)], max_iter=dk.max_iter,
                        tol=dk.tol, direction=_CHUNKED[name][0], **kw)
    torch.cuda.synchronize()
    return r, {k: TER.LAUNCHES[k] for k in ("pull", "push", "resolve")}


def _same_run(a, b):
    assert _counters(a) == _counters(b)
    assert torch.equal(_bits(a.state[0]), _bits(b.state[0]))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(_CHUNKED))
def test_chunked_matches_monolithic_on_card(cuda_device, name, tmp_path):
    g = TS.rmat_graph(400, 3200, seed=11, device=cuda_device)
    mono, mono_l = _chunk_query(name, g)
    chunked, chunked_l = _chunk_query(name, g,
                                      checkpoint_every=_CHUNKED[name][1],
                                      ckpt_dir=str(tmp_path))
    assert mono.iterations > _CHUNKED[name][1]
    _same_run(mono, chunked)
    assert mono_l == chunked_l and sum(mono_l.values()) > 0
    assert chunked.state[0].device.type == "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(_CHUNKED))
def test_kill_and_resume_on_card(cuda_device, name, tmp_path, monkeypatch):
    """A run killed after its second chunk and resumed from the snapshot
    ends on the uninterrupted run's bits and counters, its launches and
    the killed run's summing to the uninterrupted run's; the restored
    carry's tensors lie on the card."""
    from repro_torch.checkpoint.fixpoint import FixpointCheckpointer

    class Kill(Exception):
        pass

    every = _CHUNKED[name][1]
    g = TS.rmat_graph(400, 3200, seed=11, device=cuda_device)
    mono, mono_l = _chunk_query(name, g)

    def killer(k):
        if k >= 2 * every:
            raise Kill()

    with pytest.raises(Kill):
        _chunk_query(name, g, checkpoint_every=every, ckpt_dir=str(tmp_path),
                     fault_hook=killer)
    killed_l = dict(TER.LAUNCHES)
    restored = []
    real = FixpointCheckpointer.restore

    def restore(self, carry_like):
        carry = real(self, carry_like)
        restored.append(carry)
        return carry

    monkeypatch.setattr(FixpointCheckpointer, "restore", restore)
    resumed, resumed_l = _chunk_query(name, g, checkpoint_every=every,
                                      ckpt_dir=str(tmp_path), resume=True)
    _same_run(mono, resumed)
    assert {k: killed_l[k] + resumed_l[k] for k in mono_l} == mono_l
    (carry,) = restored           # k and pushes are host counters
    assert int(carry[2]) == 2 * every
    on_card = list(carry[0]) + [carry[1], carry[3], *carry[5:]]
    assert all(t.device.type == "cuda" for t in on_card)


@pytest.mark.gpu
def test_warm_start_on_card(cuda_device):
    g = TS.rmat_graph(400, 3200, seed=11, device=cuda_device)
    prog = TF.fuse(TU.ALL_SPECS["SSSP"]())
    cold, state = TE.run_program(g, prog, engine="cuda", return_state=True)
    assert state[0].device.type == "cuda" and cold.stats.iterations > 1
    warm = TE.run_program(g, prog, engine="cuda", init_state=state)
    assert warm.stats.iterations == 1
    assert torch.equal(_bits(cold.value), _bits(warm.value))
    wd = TU.handwritten_sssp(0)
    direct = TE.run_direct(g, wd, engine="cuda",
                           init_state=[s.cpu().numpy() for s in state])
    assert direct.stats.iterations == 1
    assert torch.equal(_bits(direct.value), _bits(cold.value))


# ---------------------------------------------------------------------------
# Batched queries on the card: the sweep kernels' slot axis
# ---------------------------------------------------------------------------

def _batch_inputs(dev, name, slots, density=0.2):
    """The RM-XS graph on the card, one round's sweep shape and ``slots``
    query slots' frontiers and states (a quarter ⊥), made with numpy."""
    g = TS.rmat_graph(400, 3200, seed=11, device=dev)
    rnd = _round(name, g.n)
    n_pad = TS.to_blocked_ell(g).n_pad
    rng = np.random.default_rng(30 + slots)
    act = (rng.random((slots, n_pad)) < density).astype(np.int32)
    act[:, g.n:] = 0
    st = []
    for dt, ident in zip(rnd.dtypes, rnd.idents):
        v = rng.uniform(0.5, 9.0, (slots, n_pad)).astype(np.float32) \
            if dt == torch.float32 else \
            rng.integers(0, 50, (slots, n_pad)).astype(np.int32)
        v[rng.random((slots, n_pad)) < 0.25] = ident
        st.append(torch.from_numpy(v).to(dev))
    od = torch.ones(n_pad, device=dev)
    od[:g.n] = g.out_deg.clamp(min=1).float()
    wd = torch.ones(n_pad, device=dev)
    wd[:g.n] = TS.w_out_deg(g)
    return g, rnd, torch.from_numpy(act).to(dev), od, wd, st


@pytest.mark.gpu
@pytest.mark.parametrize("order", ["tile-major", "slot-major"])
@pytest.mark.parametrize("slots", [1, 3, 8])
@pytest.mark.parametrize("name", ["BFS", "WSP", "WPR"])
def test_batched_kernels_match_plain_on_card(cuda_device, name, slots, order,
                                             monkeypatch):
    """One launch of each kernel for ``slots`` query slots, each slot
    bitwise its plain version (the solo plain version per slot, stacked):
    pull in both modes into poisoned buffers, push on the tiles it runs,
    resolve with has-pred in full from a poisoned push buffer; the batched
    walk in both item orders (forced through ``_SLOT_ORDER``)."""
    monkeypatch.setattr(TER, "_SLOT_ORDER", order.split("-")[0])
    dev = cuda_device
    g, rnd, act, od, wd, st = _batch_inputs(dev, name, slots)
    ein, eout = TS.to_blocked_ell(g), TS.to_blocked_ell(g, direction="out")
    res = TS.to_push_resolution(g)
    nv = float(g.n)
    t_in = TER.tile_activity(ein.nbrs, ein.mask, ein.tile_nnz, act)
    t_out = TER.tile_activity_push(eout.tile_nnz, act)
    t_res = TER.resolution_tile_activity(res.contrib, t_out, res.tile_nnz)
    pull_rest = (ein.nbrs, ein.weight, ein.capacity, ein.mask, act, od, wd,
                 st, nv, True)
    push_args = (rnd, t_out, eout.nbrs, eout.weight, eout.capacity,
                 eout.mask, act, od, wd, st, nv)
    res_kw = dict(push_tile_act=t_out, width_out=eout.width, states=st,
                  need_hp=True)
    want = TER._pull_plain(rnd, t_in, *pull_rest)
    TER.reset_launches()
    k_front, k_act = TER.pull_sweep_frontier(
        rnd, ein.tiles_static, *pull_rest,
        out=_poisoned_like([*want, t_in]))
    k_given = TER.pull_sweep(rnd, t_in, *pull_rest,
                             out=_poisoned_like(want))
    poisoned = [torch.full((slots,) + tuple(eout.nbrs.shape), _POISON,
                           dtype=torch.int32, device=dev).view(dt)
                for dt in rnd.dtypes]
    k_push = TER.push_sweep(*push_args, out=poisoned)
    k_res = TER.resolve_sweep(rnd, t_res, res.valid, res.in2out, k_push,
                              **res_kw)
    torch.cuda.synchronize()
    assert TER.LAUNCHES == {"pull": 2, "push": 1, "resolve": 1, "level": 0}
    assert torch.equal(k_act, t_in)
    for a, b, c in zip(k_front, k_given, want):
        assert a.shape == (slots,) + tuple(c.shape[1:])
        assert torch.equal(_bits(a), _bits(c))
        assert torch.equal(_bits(b), _bits(c))
    p_push = TER._push_plain(*push_args)
    p_res = TER._resolve_plain(rnd, t_res, res.valid, res.in2out, p_push,
                               **res_kw)
    for s in range(slots):
        ran = _slots_of_tiles(t_out[s])
        for a, b in zip(k_push, p_push):
            assert torch.equal(_bits(a[s])[ran], _bits(b[s])[ran])
            assert bool((_bits(a[s])[~ran] == _POISON).all())
    for a, b in zip(k_res, p_res):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.gpu
def test_batched_kernels_share_inputs_on_card(cuda_device):
    """A shared frontier and tile activity (slot stride 0), as the push−
    and pull− batches pass them, give each slot its solo launch's bits."""
    dev = cuda_device
    g, rnd, act, od, wd, st = _batch_inputs(dev, "WPR", 3, density=1.0)
    ein, eout = TS.to_blocked_ell(g), TS.to_blocked_ell(g, direction="out")
    res = TS.to_push_resolution(g)
    ones = torch.ones(ein.n_pad, dtype=torch.int32, device=dev)
    nv = float(g.n)
    r_static = TER.resolution_tile_activity(res.contrib, eout.tiles_static,
                                            res.tile_nnz)
    pulled = TER.pull_sweep(rnd, ein.tiles_static, ein.nbrs, ein.weight,
                            ein.capacity, ein.mask, ones, od, wd, st, nv,
                            True)
    cands = TER.push_sweep(rnd, eout.tiles_static, eout.nbrs, eout.weight,
                           eout.capacity, eout.mask, ones, od, wd, st, nv)
    resolved = TER.resolve_sweep(rnd, r_static, res.valid, res.in2out, cands,
                                 eout.tiles_static, eout.width, st, True)
    for s in range(3):
        st_s = [x[s] for x in st]
        solo = TER.pull_sweep(rnd, ein.tiles_static, ein.nbrs, ein.weight,
                              ein.capacity, ein.mask, ones, od, wd, st_s, nv,
                              True)
        c_s = TER.push_sweep(rnd, eout.tiles_static, eout.nbrs, eout.weight,
                             eout.capacity, eout.mask, ones, od, wd, st_s, nv)
        r_s = TER.resolve_sweep(rnd, r_static, res.valid, res.in2out, c_s,
                                eout.tiles_static, eout.width, st_s, True)
        for a, b in zip(pulled + resolved, solo + r_s):
            assert torch.equal(_bits(a[s]), _bits(b))


_BATCH_QUERIES = ["BFS", "SSSP", "WSP", "WP", "NSP"]


@pytest.mark.gpu
@pytest.mark.parametrize("model", [None, "pull", "push"])
@pytest.mark.parametrize("name", _BATCH_QUERIES)
def test_batched_queries_match_solo_on_card(cuda_device, name, model):
    """A batch of 8 sources on a mid-size graph: every query bitwise its
    solo cuda query with equal counters; each sweep kernel launches at most
    once per batch iteration and fewer times than the solo queries."""
    g = TS.rmat_graph(4096, 65536, seed=7, device=cuda_device)
    prog = TF.fuse(TU.ALL_SPECS[name]())
    rng = np.random.default_rng(8)
    srcs = [int(s) for s in rng.choice(
        np.flatnonzero(g.out_deg.cpu().numpy() > 0), 8, replace=False)]
    TER.reset_launches()
    solo = [TE.run_program(g, prog, engine="cuda", model=model, source=s)
            for s in srcs]
    torch.cuda.synchronize()
    solo_l = dict(TER.LAUNCHES)
    TER.reset_launches()
    batch = TE.run_program_batch(g, prog, srcs, model=model)
    torch.cuda.synchronize()
    batch_l = dict(TER.LAUNCHES)
    iters = max(b.stats.iterations for b in batch)
    for b, s in zip(batch, solo):
        assert b.stats.engine_used == "cuda" and b.stats.fallbacks == ()
        assert _counters(b.stats) == _counters(s.stats)
        assert torch.equal(_bits(b.value), _bits(s.value))
    for k in ("pull", "push", "resolve"):
        assert batch_l[k] <= iters, k
        if solo_l[k]:
            assert 0 < batch_l[k] < solo_l[k], k


@pytest.mark.gpu
def test_continuous_batching_on_card(cuda_device):
    """SSSP in chunks of 2 iterations through return_state / init_state on
    the card; a retired slot takes a fresh ``batch_init_state`` row and its
    answer equals its solo query's."""
    g = TS.rmat_graph(4096, 65536, seed=7, device=cuda_device)
    prog = TF.fuse(TU.ALL_SPECS["SSSP"]())
    srcs, queue, answers = [1, 2, 3], [4, 5, 6, 7], {}
    outs, state = TE.run_program_batch(g, prog, srcs, max_iter=2,
                                       on_nonconverge="ignore",
                                       return_state=True)
    assert all(s.device.type == "cuda" for s in state)
    for _ in range(200):
        rows = list(state)
        for b, o in enumerate(outs):
            if o.stats.converged and srcs[b] not in answers:
                answers[srcs[b]] = o.value.clone()
                if queue:
                    srcs[b] = queue.pop(0)
                    fresh = TE.batch_init_state(g, prog, [srcs[b]])
                    for r, f in zip(rows, fresh):
                        r[b] = f[0]
        if len(answers) == 7:
            break
        outs, state = TE.run_program_batch(g, prog, srcs, max_iter=2,
                                           on_nonconverge="ignore",
                                           init_state=tuple(rows),
                                           return_state=True)
    assert sorted(answers) == list(range(1, 8))
    for s, got in answers.items():
        want = TE.run_program(g, prog, engine="cuda", source=s).value
        assert torch.equal(_bits(got), _bits(want)), s


# ---------------------------------------------------------------------------
# Incremental fixpoints: the layout patch on the card, the sweeps on patched
# layouts, delta-seeded queries.
# ---------------------------------------------------------------------------

def _warm_layouts(g):
    for d in ("in", "out"):
        TS.blocked_ell_cached(g, direction=d)
    TS.push_resolution_cached(g)


def _cached(g):
    """The layouts, resolution and slot maps cached for ``g``, by key."""
    out = {}
    for name, cache in (("ell", TS._ELL_CACHE), ("res", TS._RES_CACHE),
                        ("slots", TS._SLOT_CACHE)):
        for k, (ref, v) in cache.items():
            if k[0] == id(g) and ref() is g:
                out[(name,) + k[1:]] = v
    return out


def _same_cached(a, b):
    """Two graphs' cached derived structures, field by field, bitwise (a
    card tensor against a host one)."""
    ca, cb = _cached(a), _cached(b)
    assert sorted(ca) == sorted(cb)
    for key, va in ca.items():
        vb = cb[key]
        if key[0] == "slots":
            for x, y in zip(va, vb):
                assert x.device.type == "cuda" and torch.equal(x.cpu(), y)
            continue
        for f in dataclasses.fields(va):
            x, y = getattr(va, f.name), getattr(vb, f.name)
            if isinstance(x, torch.Tensor):
                assert x.device.type == "cuda" and x.dtype == y.dtype
                assert torch.equal(x.cpu(), y), (key, f.name)
            else:
                assert x == y, (key, f.name)


def _mutate_pair(g, gc, **kw):
    from repro_torch.graph import mutate as TM
    g2, md = TM.mutate_edges(g, **kw)
    gc2, mdc = TM.mutate_edges(gc, **kw)
    for f in ("inserted", "deleted", "has_deletes", "patched_layouts",
              "rebuilt_layouts"):
        assert getattr(md, f) == getattr(mdc, f), f
    assert np.array_equal(md.touched, mdc.touched)
    assert g2.device.type == "cuda"
    _same_cached(g2, gc2)
    return g2, md, gc2


@pytest.mark.gpu
def test_incremental_device_patch_matches_host_patch(cuda_device):
    """The patch on the card gives, field by field, the host patch's
    layouts, resolution and slot maps: inserts and deletes, a chained
    mutation, and a row overflow (a counted rebuild of the in-layout, the
    out-layout and the resolution patched)."""
    g = TS.rmat_graph(4096, 65536, seed=7, device=cuda_device)
    gc = TS.from_arrays(g.n, *g.host_edges(), device="cpu")
    _warm_layouts(g)
    _warm_layouts(gc)
    src, dst, _w, _c = gc.host_edges()
    rng = np.random.default_rng(7)
    k = int(gc.num_edges * 0.005)
    gone = rng.choice(gc.num_edges, 200, replace=False)
    ins = (rng.integers(0, g.n, k), rng.integers(0, g.n, k),
           (0.1 + rng.random(k)).astype(np.float32))
    g2, md, gc2 = _mutate_pair(g, gc, insert=ins,
                               delete=(src[gone], dst[gone]))
    assert md.patched_layouts == 3 and md.rebuilt_layouts == 0
    ins2 = (rng.integers(0, g.n, 64), rng.integers(0, g.n, 64))
    g3, md3, _gc3 = _mutate_pair(g2, gc2, insert=ins2)
    assert md3.patched_layouts == 3
    e_in = TS.blocked_ell_cached(gc, direction="in")
    hub = int(torch.argmax(gc.in_deg))
    free = e_in.width - int(gc.in_deg[hub])
    over = (rng.choice(np.setdiff1d(np.arange(g.n), [hub]), free + 1,
                       replace=False), np.full(free + 1, hub))
    _g4, md4, _gc4 = _mutate_pair(g, gc, insert=over)
    assert md4.rebuilt_layouts == 1 and md4.patched_layouts == 2


def _patched_inputs(dev, name, density):
    """RM-XS on the card, mutated: every edge into or out of rows 8..15
    deleted (their tiles empty in both layouts and the resolution) and 64
    random edges inserted, so live tiles hold freed and non-canonical
    slots.  Returns the inputs of ``_check_sweeps`` on the patched
    layouts."""
    from repro_torch.graph import mutate as TM
    g, rnd, act, _od, _wd, st = _card_inputs(dev, name, density)
    _warm_layouts(g)
    src, dst, _w, _c = g.host_edges()
    hit = ((dst >= 8) & (dst < 16)) | ((src >= 8) & (src < 16))
    rng = np.random.default_rng(9)
    ins = (rng.integers(16, g.n, 64), rng.integers(16, g.n, 64),
           (0.1 + rng.random(64)).astype(np.float32))
    g2, md = TM.mutate_edges(g, insert=ins, delete=(src[hit], dst[hit]))
    assert md.patched_layouts == 3
    ein = TS.blocked_ell_cached(g2, direction="in")
    eout = TS.blocked_ell_cached(g2, direction="out")
    res = TS.push_resolution_cached(g2)
    for t in (ein.tile_nnz, eout.tile_nnz, res.tile_nnz):
        assert int(t[1].sum()) == 0                   # freshly emptied
    assert int(TS.blocked_ell_cached(g, direction="in").tile_nnz[1].sum()) > 0
    od = torch.ones(ein.n_pad, device=dev)
    od[:g2.n] = g2.out_deg.clamp(min=1).float()
    wd = torch.ones(ein.n_pad, device=dev)
    wd[:g2.n] = TS.w_out_deg(g2)
    return g2, rnd, act, od, wd, st, ein, eout, res


@pytest.mark.gpu
@pytest.mark.parametrize("density", [0.05, 1.0])
@pytest.mark.parametrize("name", ["BFS", "WSP", "WPR"])
def test_incremental_sweeps_on_patched_layouts_match_plain(cuda_device, name,
                                                           density):
    """The pull, push and resolve kernels on patched layouts (freed slots
    pointing at vertex 0, inserts in non-canonical slots, freshly emptied
    tiles, a resolution from explicit slot maps) against their plain
    versions, the push buffer poisoned as in the other cases; the derived
    pull's activity against the torch one, which ignores freed slots."""
    g2, rnd, act, od, wd, st, ein, eout, res = _patched_inputs(
        cuda_device, name, density)
    _check_sweeps(rnd, act, od, wd, st, float(g2.n), ein, eout, res)
    args = (ein.nbrs, ein.weight, ein.capacity, ein.mask, act, od, wd, st,
            float(g2.n))
    want_act = TER.tile_activity(ein.nbrs, ein.mask, ein.tile_nnz, act)
    want = TER._pull_plain(rnd, want_act, *args, True)
    outs, t_act = TER.pull_sweep_frontier(rnd, ein.tiles_static, *args,
                                          need_hp=True)
    p_outs, p_act = TER.pull_sweep_frontier(
        rnd, ein.tiles_static, *args, need_hp=True,
        out=_poisoned_like([*outs, t_act]))
    torch.cuda.synchronize()
    assert torch.equal(t_act, want_act) and torch.equal(p_act, want_act)
    for a, b, c in zip(outs, p_outs, want):
        assert torch.equal(_bits(a), _bits(c))
        assert torch.equal(_bits(b), _bits(c))


@pytest.mark.gpu
def test_incremental_level_kernel_on_patched_layout(cuda_device):
    """The level walk of a patched in-layout (``row_tile_walk`` derived
    afresh from its own tile counts, a freshly emptied row tile), bitwise
    against the plain version."""
    g2, _rnd, _act, _od, _wd, _st, ein, _eout, _res = _patched_inputs(
        cuda_device, "BFS", 1.0)
    assert int(ein.row_tile_walk[1][1]) == 0
    act, od, s_max, cases = _level_inputs(cuda_device, ein.n_pad, g2.n)
    TER.reset_launches()
    _check_level_cases(ein, g2.n, act, od, s_max, cases)
    assert TER.LAUNCHES["level"] == len(cases)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["BFS", "SSSP", "WP", "CC"])
def test_incremental_delta_queries_on_card(cuda_device, name):
    """rmat_graph(4096, 65536, seed=7) (CC on its undirected closure, each
    insert in both directions), 0.5 % seeded inserts: the delta query on the
    card is bitwise the cold cuda query on the mutated graph with less edge
    work, and gives the plain versions' answer and six counters; a delete
    batch plans "full" and matches a canonical rebuild."""
    from repro_torch.graph import mutate as TM
    g = TS.rmat_graph(4096, 65536, seed=7, device=cuda_device)
    if name == "CC":
        g = TS.undirected(g)
    prog = TF.fuse(TU.ALL_SPECS[name]())
    _r0, state = TE.run_program(g, prog, engine="cuda", return_state=True)
    rng = np.random.default_rng(7)
    k = int(g.num_edges * 0.005)
    s, d = rng.integers(0, g.n, k), rng.integers(0, g.n, k)
    w = (0.1 + rng.random(k)).astype(np.float32)
    ins = (np.concatenate([s, d]), np.concatenate([d, s]),
           np.concatenate([w, w])) if name == "CC" else (s, d, w)
    g2, md = TM.mutate_edges(g, insert=ins)
    assert md.patched_layouts == 3 and md.rebuilt_layouts == 0
    TER.reset_launches()
    warm = TE.run_program(g2, prog, engine="cuda", init_state=state,
                          delta=md)
    torch.cuda.synchronize()
    assert warm.stats.plan.incremental == "delta"
    assert TER.LAUNCHES["pull"] + TER.LAUNCHES["push"] > 0
    cold = TE.run_program(g2, prog, engine="cuda")
    assert torch.equal(_bits(warm.value), _bits(cold.value))
    assert warm.stats.edge_work < cold.stats.edge_work
    gc = TS.from_arrays(g.n, *g.host_edges(), device="cpu")
    _warm_layouts(gc)
    gc2, mdc = TM.mutate_edges(gc, insert=ins)
    plain = TE.run_program(gc2, prog, engine="cuda", device="cpu",
                           init_state=[t.cpu() for t in state], delta=mdc)
    assert torch.equal(warm.value.cpu(), plain.value)
    assert _counters(warm.stats) == _counters(plain.stats)
    src, dst, _w, _c = gc.host_edges()
    gone = rng.choice(gc.num_edges, 100, replace=False)
    g3, md3 = TM.mutate_edges(g, delete=(src[gone], dst[gone]))
    full = TE.run_program(g3, prog, engine="cuda", init_state=state,
                          delta=md3)
    assert full.stats.plan.incremental == "full"
    canon = TE.run_program(TS.from_arrays(g.n, *g3.host_edges(),
                                          device=cuda_device), prog,
                           engine="cuda")
    assert torch.equal(_bits(full.value), _bits(canon.value))


@pytest.mark.gpu
def test_incremental_pagerank_delta_on_card(cuda_device):
    """PageRank's rescaled warm delta on the card: within a hundredth of
    the mean rank of the cold query, in no more iterations, with the
    tolerance scaled to the mean rank 1/n as the smoke scales it; the cold
    query on the patched layouts allclose to the pull engine."""
    from repro_torch.graph import mutate as TM
    g = TS.rmat_graph(4096, 65536, seed=7, device=cuda_device)
    _warm_layouts(g)
    dk = TSy.pagerank_kernels(g.n, tol=1e-4 / g.n)
    prev = TE.run_direct(g, dk, engine="cuda")
    rng = np.random.default_rng(7)
    k = int(g.num_edges * 0.005)
    g2, md = TM.mutate_edges(g, insert=(rng.integers(0, g.n, k),
                                        rng.integers(0, g.n, k)))
    cold = TE.run_direct(g2, dk, engine="cuda")
    warm = TE.run_direct(g2, dk, engine="cuda", init_state=[prev.value],
                         delta=md)
    assert warm.stats.plan.incremental == "delta"
    assert warm.stats.iterations <= cold.stats.iterations
    torch.testing.assert_close(warm.value, cold.value, rtol=0,
                               atol=1e-2 / g.n)
    pull = TE.run_direct(g2, dk, engine="pull")
    torch.testing.assert_close(cold.value, pull.value, rtol=1e-5, atol=1e-8)


# ---------------------------------------------------------------------------
# The continuous-batching analytics service on the card
# ---------------------------------------------------------------------------


def _serving_spy(monkeypatch):
    """Hold every query the service runs to the cuda engine with no
    fallback, and count its entry-point calls."""
    calls = {"batch": 0, "solo": 0}
    real_batch, real_solo = TE.run_program_batch, TE.run_program

    def batch(*a, **kw):
        outs, state = real_batch(*a, **kw)
        calls["batch"] += 1
        for o in outs:
            assert o.stats.engine_used == "cuda" and o.stats.fallbacks == ()
        assert all(s.device.type == "cuda" for s in state)
        return outs, state

    def solo(*a, **kw):
        r = real_solo(*a, **kw)
        calls["solo"] += 1
        if kw.get("engine") == "cuda":
            assert r.stats.engine_used == "cuda" and r.stats.fallbacks == ()
        return r

    monkeypatch.setattr(TE, "run_program_batch", batch)
    monkeypatch.setattr(TE, "run_program", solo)
    return calls


def _service_on_card(g, **kw):
    from repro_torch.launch import service as TSV
    svc = TSV.AnalyticsService(TSV.ServiceConfig(**kw))
    svc.add_graph("g", g)
    svc.register("BFS", TU.bfs)
    svc.register("SSSP", TU.sssp)
    return TSV, svc


def _pull_answer(g, svc, req):
    """The port's pull engine's answer to a served request: the vertex
    array, or the scalar as float64."""
    if req.lane == "batch":
        prog = svc._kinds[req.kind][1]
        v = TE.run_program(g, prog, engine="pull", source=req.source).value
        return v.cpu().numpy()
    v = TE.run_program(g, TF.fuse(req.spec), engine="pull").value
    return np.float64(float(v))


@pytest.mark.gpu
def test_service_mix_trace_on_card(cuda_device, monkeypatch):
    """A seeded MIX trace (BFS/SSSP from random sources, a quarter
    radius/drr scalars) on rmat_graph(4096, 65536, seed=7) at the
    reference service's defaults: every answer bitwise its solo cuda query
    and the pull engine's; the lane state a card tensor on every chunk."""
    g = TS.rmat_graph(4096, 65536, seed=7, device=cuda_device)
    TSV, svc = _service_on_card(g)
    calls = _serving_spy(monkeypatch)
    cfg = svc.cfg
    rate = 16.0 / (cfg.launch_overhead_s + cfg.chunk_iters * cfg.iter_cost_s)
    m = svc.run_open_loop(TSV.open_loop_arrivals(
        32, rate=rate, seed=0, make_request=TSV.standard_mix("g", g.n)))
    assert m["completed"] == 32 and m["queries_per_launch"] > 1.0
    assert m["scalar_rounds"] >= 1
    assert calls["batch"] == m["batch_launches"]
    assert TSV.verify_sequential(svc) == 32
    for req in svc.completed:
        want = _pull_answer(g, svc, req)
        got = req.value if isinstance(want, np.ndarray) else \
            np.float64(req.value)
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), \
            req.rid
    assert all(r.device.type == "cuda" for rows in svc._retired.values()
               for r in rows)


@pytest.mark.gpu
def test_service_widest_scalar_round_on_card(cuda_device):
    """One scalar round at ``max_scalar_fuse`` = 8 radius/drr requests (16
    distinct sources, 16 components): each answer the pull engine's."""
    g = TS.rmat_graph(4096, 65536, seed=7, device=cuda_device)
    rng = np.random.default_rng(9)
    ends = rng.choice(g.n, 16, replace=False)
    reqs = [(i, (TU.radius if i % 2 else TU.drr)(int(ends[2 * i]),
                                                 int(ends[2 * i + 1])))
            for i in range(8)]
    prog = TF.fuse_many(reqs)
    assert len(prog.rounds[0][1].components) == 16
    res = TE.run_program(g, prog, engine="cuda")
    assert res.stats.engine_used == "cuda" and res.stats.fallbacks == ()
    for key, spec in reqs:
        want = TE.run_program(g, TF.fuse(spec), engine="pull").value
        assert float(res.value[key]) == float(want), key


@pytest.mark.gpu
def test_service_mutate_under_traffic_on_card(cuda_device, monkeypatch):
    """Traffic, repeats of served sources queued, then 0.5 % seeded inserts
    through ``mutate_graph`` and a drain: the repeats join warm, and every
    answer is bitwise a solo cuda query on the graph that served it."""
    g = TS.rmat_graph(4096, 65536, seed=7, device=cuda_device)
    TSV, svc = _service_on_card(g)
    _serving_spy(monkeypatch)
    for i, s in enumerate(range(10, 22)):
        svc.submit("g", TSV.Request(rid=i, kind=("BFS", "SSSP")[i % 2],
                                    source=s))
    while svc.step():
        pass
    for i, s in enumerate(range(10, 22)):
        svc.submit("g", TSV.Request(rid=100 + i,
                                    kind=("BFS", "SSSP")[i % 2], source=s))
    rng = np.random.default_rng(7)
    k = int(g.num_edges * 0.005)
    md = svc.mutate_graph("g", insert=(
        rng.integers(0, g.n, k), rng.integers(0, g.n, k),
        (0.1 + rng.random(k)).astype(np.float32)))
    assert md.patched_layouts >= 1
    while svc.step():
        pass
    m = svc.metrics()
    assert m["completed"] == 24 and m["warm_joins"] >= 1
    g2 = svc.graphs["g"]
    for req in svc.completed:
        served_on = g if req.rid < 100 else g2
        prog = svc._kinds[req.kind][1]
        want = TE.run_program(served_on, prog, engine="cuda",
                              source=req.source).value
        assert req.value.tobytes() == want.cpu().numpy().tobytes(), req.rid


def _cached_bytes(g):
    """Bytes of the distinct device storages in ``g``'s derived caches."""
    seen = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)

    for cache in (TS._ELL_CACHE, TS._RES_CACHE, TS._WDEG_CACHE):
        for ref, val in cache.values():
            if ref() is g:
                walk(val)
    return sum(seen.values())


@pytest.mark.gpu
def test_service_eviction_frees_card_memory(cuda_device, monkeypatch):
    """``max_graphs`` = 1: adding a second graph evicts the idle first,
    and ``torch.cuda.memory_allocated()`` falls by at least its layouts'
    bytes."""
    g1 = TS.rmat_graph(4096, 65536, seed=7, device=cuda_device)
    g2 = TS.rmat_graph(4096, 65536, seed=8, device=cuda_device)
    TSV, svc = _service_on_card(g1, max_graphs=1)
    for i in range(4):
        svc.submit("g", TSV.Request(rid=i, kind="SSSP", source=i))
    while svc.step():
        pass
    layouts = _cached_bytes(g1)
    assert layouts > 0
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    svc.add_graph("g2", g2)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    assert svc.graph_evictions == 1 and "g" not in svc.graphs
    assert _cached_bytes(g1) == 0
    assert before - after >= layouts


@pytest.mark.gpu
def test_service_analytics_smoke_on_card(cuda_device):
    """``analytics --smoke`` on the card: every answer bitwise its solo
    query, and the card's schedule the CPU's (all metrics but wall)."""
    from repro_torch.launch import analytics as TA
    card = TA.run_smoke(verbose=False)
    TE.clear_program_caches()
    cpu = TA.run_smoke(verbose=False, device="cpu")
    assert card["verified_bitwise"] == 24
    assert {k: v for k, v in card.items() if not k.startswith("wall")} == \
        {k: v for k, v in cpu.items() if not k.startswith("wall")}


# ---------------------------------------------------------------------------
# The sharded engines: k vertex-cut shards on the one card.
# ---------------------------------------------------------------------------

_SHARDED_GRAPHS = {"rmxs": (400, 3200, 11), "rmat4096": (4096, 65536, 7)}


def _launched(fn):
    TER.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: TER.LAUNCHES[k] for k in ("pull", "push", "resolve")}


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["contiguous", "dst_hash"])
@pytest.mark.parametrize("gname", list(_SHARDED_GRAPHS))
def test_cuda_sharded_on_card_matches_cuda(cuda_device, gname, strategy):
    """``ShardMesh.on("cuda", 4)``: BFS, SSSP and WSP on auto, pull and
    push, and CC, bitwise the single-device cuda answer with its
    iterations and push iterations, each kernel launched 4 × the
    single-device count; PageRank within rtol 1e-5 with equal
    iterations."""
    from repro_torch.graph.partition import ShardMesh
    n, e, seed = _SHARDED_GRAPHS[gname]
    g = TS.rmat_graph(n, e, seed=seed, device=cuda_device)
    mesh = ShardMesh.on(cuda_device, 4)
    cases = [(name, model) for name in ("BFS", "SSSP", "WSP")
             for model in (None, "pull", "push")] + [("CC", None)]
    for name, model in cases:
        gq = TS.undirected(g) if name == "CC" else g
        prog = TF.fuse(TU.ALL_SPECS[name]())
        one, l1 = _launched(lambda: TE.run_program(gq, prog, engine="cuda",
                                                   model=model))
        four, l4 = _launched(lambda: TE.run_program(
            gq, prog, engine="cuda_sharded", mesh=mesh, model=model,
            shard_strategy=strategy))
        label = f"{name}/{model}"
        assert torch.equal(one.value, four.value), label
        assert four.value.device == one.value.device
        assert (four.stats.iterations, four.stats.push_iters) == \
            (one.stats.iterations, one.stats.push_iters), label
        assert l4 == {k: 4 * v for k, v in l1.items()}, (label, l1, l4)
        assert four.stats.engine_used == "cuda_sharded"
        assert four.stats.fallbacks == () and four.stats.shards == 4
    dk = TSy.pagerank_kernels(g.n, tol=1e-4 / g.n)
    one = TE.run_direct(g, dk, engine="cuda")
    four, l4 = _launched(lambda: TE.run_direct(
        g, dk, engine="cuda_sharded", mesh=mesh, shard_strategy=strategy))
    assert four.stats.iterations == one.stats.iterations
    assert l4["pull"] == 4 * four.stats.iterations
    torch.testing.assert_close(four.value, one.value, rtol=1e-5, atol=1e-8)


@pytest.mark.gpu
def test_cuda_sharded_empty_shards_on_card(cuda_device):
    """k = 5 on a 3-edge line graph: two shards hold no edge, so their
    walks find no live tile; every shard still launches and the answer is
    the single-device one."""
    from repro_torch.graph.partition import ShardMesh
    g = TS.line_graph(4, device=cuda_device)
    mesh = ShardMesh.on(cuda_device, 5)
    for model in (None, "pull", "push"):
        prog = TF.fuse(TU.bfs(0))
        one, l1 = _launched(lambda: TE.run_program(g, prog, engine="cuda",
                                                   model=model))
        five, l5 = _launched(lambda: TE.run_program(
            g, prog, engine="cuda_sharded", mesh=mesh, model=model))
        assert torch.equal(one.value, five.value), model
        assert five.stats.iterations == one.stats.iterations
        assert l5 == {k: 5 * v for k, v in l1.items()}, model
        assert sorted(five.stats.shard_work)[:2] == [0, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["contiguous", "dst_hash"])
@pytest.mark.parametrize("name", ["BFS", "WSP", "WPR"])
def test_shard_kernels_match_plain_on_card(cuda_device, name, strategy):
    """One shard's pull, push and resolve launches on its widened layouts
    (4 shards of RM-XS: padding slot tiles past the shard's own width)
    against their plain versions, as ``test_kernels_match_plain_on_card``
    holds them on the whole graph."""
    g, rnd, act, od, wd, st = _card_inputs(cuda_device, name, 1.0)
    ein = TS.to_sharded_ell(g, 4, strategy, direction="in")
    eout = TS.to_sharded_ell(g, 4, strategy, direction="out")
    res = TS.to_sharded_push_resolution(g, 4, strategy)
    j = int(np.argmin([int(e.tile_nnz.sum()) for e in ein.shards]))
    for e in (ein.shards[j], eout.shards[j]):
        assert bool((e.tile_nnz == 0).any())
    _check_sweeps(rnd, act, od, wd, st, float(g.n), ein.shards[j],
                  eout.shards[j], res.shards[j])


@pytest.mark.gpu
def test_distributed_on_card_matches_pull(cuda_device):
    from repro_torch.graph.partition import ShardMesh
    g = TS.rmat_graph(4096, 65536, seed=7, device=cuda_device)
    mesh = ShardMesh.on(cuda_device, 4)
    for name in ("BFS", "SSSP", "WP"):
        prog = TF.fuse(TU.ALL_SPECS[name]())
        want = TE.run_program(g, prog, engine="pull")
        got = TE.run_program(g, prog, engine="distributed", mesh=mesh)
        assert torch.equal(got.value, want.value), name
        assert got.stats.iterations == want.stats.iterations
        assert got.stats.shards == 4


# ---------------------------------------------------------------------------
# The analytics dry-run's step, run for real on the card.
# ---------------------------------------------------------------------------


def _dryrun_step_run(device):
    """The dry-run's WSP step over ``ShardMesh.on(device, 4)`` on the
    ``partition_edges`` blocks of RM-XS: (state bits, iterations, shard
    work, the blocks on the host)."""
    from repro_torch.graph.partition import ShardMesh, partition_edges
    from repro_torch.launch import analytics_dryrun as AD
    g = TS.rmat_graph(400, 3200, seed=11, device=device)
    part = partition_edges(g, 4)
    flat = [getattr(part, f).reshape(-1) for f in
            ("src", "dst", "weight", "capacity", "mask")]
    fn, _ = AD.build_step(ShardMesh.on(device, 4), g.n, g.num_edges)
    work = []
    state, it = fn(*flat, g.out_deg, shard_work=work)
    assert {s.device.type for s in state} == {torch.device(device).type}
    return ([_bits(s).cpu() for s in state], it, work,
            [a.cpu() for a in flat])


@pytest.mark.gpu
def test_dryrun_step_on_card_matches_cpu(cuda_device):
    """The step over 4 shards on the card is bitwise its run over 4 CPU
    shards at RM-XS, with equal iterations and per-shard edge work."""
    card = _dryrun_step_run(cuda_device)
    cpu = _dryrun_step_run("cpu")
    for a, b in zip(card[3], cpu[3]):
        assert torch.equal(a, b)
    assert card[1] == cpu[1] < 64
    assert card[2] == cpu[2] and sum(card[2]) > 0
    for a, b in zip(card[0], cpu[0]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_dryrun_record_allocates_nothing_on_card(cuda_device):
    """Building both production meshes' records on ``meta`` leaves the
    card's allocated memory unchanged; the production mesh defaults to the
    card."""
    from repro_torch.launch import analytics_dryrun as AD
    from repro_torch.launch.dryrun import _mesh_tag
    from repro_torch.launch.mesh import make_production_mesh
    assert {d.type for d in make_production_mesh().devices} == {"cuda"}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for multi_pod, k in ((False, 256), (True, 512)):
        rec = AD.build_record(
            make_production_mesh(multi_pod=multi_pod, device="meta"),
            AD.OGB_N, AD.OGB_E, _mesh_tag(multi_pod))
        assert rec["devices"] == k
        assert rec["collectives"]["all-reduce"]["count"] == 2
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before


# ---------------------------------------------------------------------------
# The LM serving path (models/, launch/serve.py) on the card
# ---------------------------------------------------------------------------

_LM_ARCHS = ["llama3.2-3b", "qwen2-72b", "yi-9b", "deepseek-v3-671b",
             "llama4-maverick-400b-a17b"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", _LM_ARCHS)
def test_lm_smoke_on_card_matches_cpu(cuda_device, arch, monkeypatch):
    """A smoke LM (float32) on the card against the CPU port with the same
    weights: the prefill's logits and written cache, then a decode step's
    logits and cache, allclose 1e-4 (full float32 products, TF32 off)."""
    import copy

    import repro_torch.configs as TCF
    from repro_torch.models import transformer as TLM
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = TCF.get(arch).smoke()
    cpu = TLM.init_params(cfg, torch.Generator().manual_seed(5),
                          device="cpu")
    card = copy.deepcopy(cpu).to(cuda_device)
    assert card.device.type == "cuda"
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 17))).long()
    out = {}
    for name, model in (("cpu", cpu), ("card", card)):
        cache = model.init_cache(2, 32)
        t = toks.to(model.device)
        lg, cache = model.prefill(t[:, :16], cache)
        written = {k: v.clone() for k, v in cache.items()}
        lg2, cache = model.decode_step(t[:, 16], 16, cache)
        out[name] = [lg, written, lg2, cache]
    for got, want in zip(out["card"], out["cpu"]):
        pairs = ([(got[k], want[k]) for k in want] if isinstance(want, dict)
                 else [(got, want)])
        for g, w in pairs:
            assert g.device.type == "cuda"
            torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-v3-671b"])
def test_serve_main_smoke_on_card(cuda_device, arch, capsys):
    """``launch.serve`` at a smoke config on the card (no --device)."""
    from repro_torch.launch import serve as TSV
    assert TSV.main(["--smoke", "--arch", arch]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"[serve] arch={arch} batch=2 prompt=16 "
                             "decoded=8 tokens/s=")
    assert out[1].startswith("sampled token ids: [")


# ---------------------------------------------------------------------------
# The GNNs (models/gnn.py, data/graphs.py) on the card
# ---------------------------------------------------------------------------

_GNN_ARCHS = ["gat-cora", "egnn", "meshgraphnet", "dimenet"]


def _gnn_case(arch, device):
    """A smoke GNN (seeded weights) and its batch from the port's own
    generators, on ``device``: (model, forward args, batch)."""
    import repro_torch.configs as TCF
    from repro_torch.data import graphs as TDG
    from repro_torch.models import gnn as TGN
    entry = TCF.get(arch)
    cfg = entry.smoke()
    init = {"gat": TGN.gat_init, "egnn": TGN.egnn_init,
            "mgn": TGN.mgn_init, "dimenet": TGN.dimenet_init}[entry.kind]
    model = init(cfg, torch.Generator().manual_seed(5), device="cpu") \
        .to_device(device)
    if entry.kind == "gat":
        b = TDG.cora_batch(n=64, e=256, d_feat=cfg.d_in, seed=3,
                           device=device)
        return model, (b["x"], b["src"], b["dst"], 64), b
    if entry.kind == "mgn":
        b = TDG.mesh_batch(rows=6, cols=6, d_node_in=cfg.d_node_in,
                           d_edge_in=cfg.d_edge_in, d_out=cfg.d_out, seed=3,
                           device=device)
        return model, (b["node_x"], b["edge_x"], b["src"], b["dst"],
                       b["node_x"].shape[0]), b
    b = TDG.molecule_batch(n_graphs=2, n_atoms=8, n_species=16, seed=3,
                           device=device)
    n = b["species"].shape[0]
    if entry.kind == "egnn":
        return model, (b["feats"], b["coords"], b["src"], b["dst"], n), b
    return model, (b["species"], b["coords"], b["src"], b["dst"],
                   b["t_kj"], b["t_ji"], n), b


def _flat(out):
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", _GNN_ARCHS)
def test_gnn_smoke_on_card_matches_cpu(cuda_device, arch, monkeypatch):
    """A smoke GNN (float32) on the card against the CPU port with the same
    weights and inputs: forward outputs (EGNN's coordinates too) and loss
    allclose 1e-4 (full float32 products, TF32 off), and two runs on the
    card bitwise equal (fixed-order segment sums, no atomics)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cpu, cpu_args, cpu_b = _gnn_case(arch, "cpu")
    card, args, b = _gnn_case(arch, cuda_device)
    assert card.device.type == "cuda"
    want = _flat(cpu(*cpu_args))
    got = _flat(card(*args))
    again = _flat(card(*args))
    for g, a, w in zip(got, again, want):
        assert g.device.type == "cuda"
        assert torch.equal(g.view(torch.int32), a.view(torch.int32))
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(card.loss(b).cpu(), cpu.loss(cpu_b),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["meshgraphnet", "egnn"])
def test_gnn_vertex_cut_on_card_matches_cpu(cuda_device, arch, monkeypatch):
    """The 2-shard vertex-cut forward on the card (``ShardMesh.on(card,
    2)``) against the same on the CPU and the card's single-device
    forward, allclose 1e-4; two runs bitwise equal."""
    from repro_torch.data import graphs as TDG
    from repro_torch.graph.partition import ShardMesh
    from repro_torch.models import gnn as TGN
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    fwd, nodes, edges = {
        "meshgraphnet": (TGN.mgn_forward_dist, ("node_x", "target"),
                         ("edge_x",)),
        "egnn": (TGN.egnn_forward_dist, ("feats", "coords"), ())}[arch]
    keys = nodes[:1] + (("edge_x",) if edges else ("coords",)) + \
        ("src", "dst", "emask")
    outs = {}
    for dev in ("cpu", cuda_device):
        model, args, b = _gnn_case(arch, dev)
        n = args[-1]
        host = {k: v.cpu().numpy() for k, v in b.items()
                if isinstance(v, torch.Tensor)}
        part = TDG.dst_block_partition(host["src"], host["dst"], n, 2, 2.0)
        assert int(part["mask"].sum()) == host["src"].shape[0]
        mesh = ShardMesh.on(dev, 2)
        shards = TDG.shard_batch(host, part, nodes, edges,
                                 devices=mesh.devices)
        run = [_flat(fwd(model.cfg, model, *([s[k] for s in shards]
                                             for k in keys), mesh))
               for _ in range(2)]
        outs[str(dev)] = [torch.cat(o)[:n] for o in run[0]]
        if dev != "cpu":
            for a, c in zip(run[0], run[1]):
                assert all(torch.equal(x.view(torch.int32),
                                       y.view(torch.int32))
                           for x, y in zip(a, c))
            single = _flat(model(*args))
            for g, s in zip(outs[str(dev)], single):
                torch.testing.assert_close(g, s, rtol=1e-4, atol=1e-4)
    for g, w in zip(outs[str(cuda_device)], outs["cpu"]):
        assert g.device.type == "cuda"
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# DLRM (models/dlrm.py) on the card
# ---------------------------------------------------------------------------

def _dlrm_case(multi_hot, device):
    """The smoke DLRM (seeded weights, made on the CPU) and its batch from
    the port's ``dlrm_batch``, on ``device``."""
    import repro_torch.configs as TCF
    from repro_torch.data import graphs as TDG
    from repro_torch.models import dlrm as TDL
    cfg = dataclasses.replace(TCF.get("dlrm-rm2").smoke(),
                              multi_hot=multi_hot)
    model = TDL.dlrm_init(cfg, torch.Generator().manual_seed(7),
                          device="cpu").to_device(device)
    return model, TDG.dlrm_batch(cfg, 64, seed=3, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("multi_hot", [1, 3])
def test_dlrm_smoke_on_card_matches_cpu(cuda_device, multi_hot,
                                        monkeypatch):
    """The smoke DLRM (float32) on the card against the CPU port with the
    same weights and inputs: logits, loss and user vector allclose 1e-4
    (full float32 products, TF32 off), and two runs on the card bitwise
    equal (the gather and cuBLAS use no atomics)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cpu, cpu_b = _dlrm_case(multi_hot, "cpu")
    card, b = _dlrm_case(multi_hot, cuda_device)
    assert card.device.type == "cuda"
    got = card(b["dense"], b["sparse"])
    again = card(b["dense"], b["sparse"])
    assert got.device.type == "cuda"
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    torch.testing.assert_close(got.cpu(), cpu(cpu_b["dense"],
                                              cpu_b["sparse"]),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(card.loss(b).cpu(), cpu.loss(cpu_b),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(
        card.user_vector(b["dense"], b["sparse"]).cpu(),
        cpu.user_vector(cpu_b["dense"], cpu_b["sparse"]),
        rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_embedding_bag_kernel_matches_dlrm_lookup_on_card(cuda_device):
    """The bag kernel on each smoke table (a contiguous view) with the
    field's ids against the model's lookup: K = 3 within 3·2^-24·Σ|rows|
    (two orders of three float32 adds), K = 1 bitwise the single-hot
    gather."""
    from repro_torch.models import dlrm as TDL
    TEB.reset_launches()
    for k in (3, 1):
        model, b = _dlrm_case(k, cuda_device)
        tables, idx = model["tables"], b["sparse"]
        want = TDL._lookup(model.cfg, tables, idx)
        for f in range(model.cfg.n_sparse):
            ids = idx[:, f, :] if k > 1 else idx[:, f:f + 1]
            got = TEB.embedding_bag(tables[f], ids.contiguous())
            if k == 1:
                assert torch.equal(got, want[:, f]), f
            else:
                rows = tables[f][ids.long()].abs().sum(dim=1)
                assert bool(((got - want[:, f]).abs()
                             <= k * 2.0 ** -24 * rows).all()), f
    assert TEB.LAUNCHES["bag"] == 2 * model.cfg.n_sparse


# ---------------------------------------------------------------------------
# Training (launch/workloads.py, optim/adamw.py, the flash core's backward)
# ---------------------------------------------------------------------------

_TRAIN = {"llama3.2-3b": "train_4k", "gat-cora": "full_graph_sm",
          "dlrm-rm2": "train_batch", "meshgraphnet": "full_graph_sm"}


def _train_case(arch, device):
    """The smoke workload of ``arch``, a seeded state on ``device`` and a
    batch (the LM with ``remat="full"``, so the recompute runs)."""
    import repro_torch.configs as TCF
    from repro_torch.data import graphs as TDG
    from repro_torch.data.tokens import host_batch
    from repro_torch.launch import workloads as TW
    from repro_torch.models import dlrm as TDL
    from repro_torch.models import gnn as TGN
    from repro_torch.models import transformer as TLM
    from repro_torch.optim.adamw import adamw_init
    changes = {"remat": "full"} if arch == "llama3.2-3b" else {}
    wl = TW.build_workload(arch, _TRAIN[arch], None, smoke=True,
                           cfg_changes=changes)
    gen = torch.Generator().manual_seed(11)
    kind = TCF.get(arch).kind
    if kind == "lm":
        model = TLM.init_params(wl.cfg, gen, device="cpu")
        b = host_batch(wl.cfg.vocab, 4, 64, seed=5, step=0)
    elif kind == "dlrm":
        model = TDL.dlrm_init(wl.cfg, gen, device="cpu")
        b = TDG.dlrm_batch(wl.cfg, 64, seed=5, device="cpu")
    else:
        init = {"gat": TGN.gat_init, "mgn": TGN.mgn_init}[kind]
        model = init(wl.cfg, gen, device="cpu")
        b = TDG.cora_batch(n=64, e=256, d_feat=wl.cfg.d_in, seed=5,
                           device="cpu") if kind == "gat" else \
            TDG.mesh_batch(6, 6, seed=5, device="cpu")
    params = {k: v for k, v in model.tree().items()}
    from repro_torch.tree import tree_map
    params = tree_map(lambda t: t.to(device), params)
    b = {k: v.to(device) if isinstance(v, torch.Tensor) else v
         for k, v in b.items()}
    return wl, params, adamw_init(wl.opt_cfg, params), b


def _state_bits(tree):
    from repro_torch.tree import leaves
    return [t.view(torch.int16) if t.dtype == torch.bfloat16 else
            t.view(torch.int32) if t.dtype == torch.float32 else t
            for t in leaves(tree)]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(_TRAIN))
def test_train_step_repeats_bitwise_on_card(cuda_device, arch):
    """Two train steps from two copies of one state on the card: the
    parameters, moments and loss bit for bit equal (the backward's
    gathers sum in a fixed order under deterministic algorithms), and
    within float32 summation of the step on the CPU."""
    from repro_torch.tree import tree_map
    wl, params, opt, b = _train_case(arch, cuda_device)
    runs = []
    for _ in range(2):
        p = tree_map(torch.clone, params)
        o = tree_map(torch.clone, opt)
        runs.append(wl.step_fn(p, o, b))
    (p1, o1, m1), (p2, o2, m2) = runs
    assert all(torch.equal(x, y) for x, y in zip(
        _state_bits((p1, o1)), _state_bits((p2, o2))))
    assert float(m1["loss"]) == float(m2["loss"])
    cpu = tree_map(lambda t: t.cpu(), (params, opt))
    pc, oc, mc = wl.step_fn(*cpu, {k: v.cpu() if isinstance(
        v, torch.Tensor) else v for k, v in b.items()})
    torch.testing.assert_close(float(m1["loss"]), float(mc["loss"]),
                               rtol=1e-5, atol=0)
    from repro_torch.tree import leaves
    for x, y in zip(leaves(o1["m"]), leaves(oc["m"])):
        assert x.device.type == "cuda"
        assert bool(((x.cpu() - y).abs() <= 1e-4 * (y.abs()
                                                    + y.abs().max())).all())


@pytest.mark.gpu
def test_flash_gradients_equal_naive_on_card(cuda_device, monkeypatch):
    """The smoke llama's gradients on the card through the flash core's
    backward against naive attention's (the reference's bounds: loss
    1e-4, gradients 5e-3)."""
    import repro_torch.configs as TCF
    from repro_torch.models import transformer as TLM
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = TCF.get("llama3.2-3b").smoke()
    model = TLM.init_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu")
    model = TLM.TransformerLM(cfg, {**model.tree()}).to(cuda_device)
    toks = torch.randint(0, cfg.vocab, (2, 65),
                         generator=torch.Generator().manual_seed(4))
    b = {"tokens": toks[:, :-1].to(cuda_device),
         "targets": toks[:, 1:].to(cuda_device)}
    out = []
    for m in (model.with_config(kv_chunk=16), model.with_config(
            attn_impl="naive")):
        m.trainable()
        loss = m.loss_fn(b)
        out.append((float(loss.detach()), torch.autograd.grad(
            loss, list(m.parameters()))))
        m.trainable(False)
    (l1, g1), (l2, g2) = out
    assert abs(l1 - l2) < 1e-4
    assert max(float((a - c).abs().max()) for a, c in zip(g1, g2)) < 5e-3


@pytest.mark.gpu
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_on_card_matches_cpu(cuda_device, state_dtype):
    """Three AdamW updates of float32 and bfloat16 leaves on the card
    against the CPU: float32 within rtol 1e-6, bfloat16 within one
    bfloat16 step, ``step`` equal."""
    from repro_torch.optim import adamw as TA
    from repro_torch.tree import leaves, tree_map
    cfg = TA.AdamWConfig(state_dtype=state_dtype, warmup_steps=2, lr=1e-2)
    g = torch.Generator().manual_seed(8)
    p = {"w": torch.randn((300, 70), generator=g),
         "b": torch.randn((70,), generator=g).to(torch.bfloat16)}
    st = TA.adamw_init(cfg, p)
    pd, sd = tree_map(lambda t: t.to(cuda_device), (p, st))
    for _ in range(3):
        gr = {"w": torch.randn((300, 70), generator=g) * 3,
              "b": torch.randn((70,), generator=g).to(torch.bfloat16)}
        p, st, m = TA.adamw_update(cfg, p, gr, st)
        pd, sd, md = TA.adamw_update(cfg, pd, tree_map(
            lambda t: t.to(cuda_device), gr), sd)
        assert int(sd["step"]) == int(st["step"])
        torch.testing.assert_close(float(md["grad_norm"]),
                                   float(m["grad_norm"]), rtol=1e-6, atol=0)
        for x, y in zip(leaves((pd, sd["m"], sd["v"])),
                        leaves((p, st["m"], st["v"]))):
            assert x.device.type == "cuda" and x.dtype == y.dtype
            x, y = x.cpu().double(), y.double()
            if x.dtype == torch.bfloat16 or state_dtype == "bfloat16" \
                    or y.shape == (70,):
                assert bool(((x - y).abs() <= 2.0 ** -7 * y.abs()
                             + 1e-30).all())
            else:
                torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-3b", "gat-cora", "dlrm-rm2"])
def test_train_main_smoke_on_card(cuda_device, arch, tmp_path, capsys):
    """``launch.train.main --smoke`` on the card, two steps, then resumed
    to three; no retry."""
    from repro_torch.launch import train as TTR
    argv = ["--arch", arch, "--shape", _TRAIN[arch], "--smoke",
            "--ckpt-every", "1", "--ckpt-dir", str(tmp_path)]
    assert TTR.main(argv + ["--steps", "2"]) == 0
    assert TTR.main(argv + ["--steps", "3", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "retries=0" in out
    assert f"[train] arch={arch} shape={_TRAIN[arch]} steps=3" in out


# ---------------------------------------------------------------------------
# The serving kinds of launch/workloads.py on the card
# ---------------------------------------------------------------------------

_SERVE_CELLS = [("llama3.2-3b", "prefill_32k", "baseline"),
                ("llama3.2-3b", "decode_32k", "baseline"),
                ("llama3.2-3b", "decode_32k", "kvq"),
                ("deepseek-v3-671b", "decode_32k", "baseline"),
                ("llama4-maverick-400b-a17b", "decode_32k", "baseline"),
                ("dlrm-rm2", "serve_p99", "baseline"),
                ("dlrm-rm2", "retrieval_cand", "baseline")]


def _serve_inputs(wl, seed):
    """The step's arguments after the parameters, on the CPU, made from a
    numpy seed at the abstract arguments' shapes and dtypes: token ids
    and sparse ids in range (``cfg.vocab``), a decode cache filled (int8 codes in
    [-127, 127], scales |N|/127 + 1e-3), a prefill cache zero, ``pos`` 40
    as a 0-dim tensor."""
    rng = np.random.default_rng(seed)
    vocab = getattr(wl.cfg, "vocab", None)
    out = []
    for a in wl.abstract_args[1:]:
        if isinstance(a, dict):
            cache = {}
            for k, v in a.items():
                if wl.kind == "prefill":
                    x = np.zeros(v.shape, np.float32)
                elif v.dtype == torch.int8:
                    x = rng.integers(-127, 128, v.shape)
                elif k.endswith("_s"):
                    x = np.abs(rng.normal(size=v.shape)) / 127 + 1e-3
                else:
                    x = rng.normal(size=v.shape)
                cache[k] = torch.from_numpy(np.asarray(x)).to(v.dtype)
            out.append(cache)
        elif a.dim() == 0:
            out.append(torch.tensor(40, dtype=a.dtype))
        elif a.dtype == torch.int32:
            out.append(torch.from_numpy(rng.integers(
                0, vocab, a.shape).astype(np.int32)))
        else:
            out.append(torch.from_numpy(rng.normal(size=a.shape).astype(
                np.float32)))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("arch,shape,variant", _SERVE_CELLS)
def test_serving_workloads_on_card_match_cpu(cuda_device, arch, shape,
                                             variant, monkeypatch):
    """``build_workload(...).step_fn`` of each serving kind at smoke on the
    card against the same step on the CPU with the same weights and
    inputs: logits, scores and the written cache allclose 1e-4 (full
    float32 products, TF32 off; int8 codes within one step), and two runs
    on the card from copies of the same cache bitwise equal."""
    import repro_torch.configs as TCF
    from repro_torch.launch import workloads as TW
    from repro_torch.models import dlrm as TDL
    from repro_torch.models import transformer as TLM
    from repro_torch.tree import leaves, tree_map
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    wl = TW.build_workload(arch, shape, None, smoke=True, variant=variant)
    gen = torch.Generator().manual_seed(9)
    if TCF.get(arch).family == "lm":
        tree = TLM.init_params(wl.cfg, gen, device="cpu").tree()
    else:
        tree = TDL.dlrm_init(wl.cfg, gen, device="cpu").tree()
    args = _serve_inputs(wl, 10)
    card_tree = tree_map(lambda t: t.to(cuda_device), tree)
    runs = []
    for _ in range(2):
        card_args = tree_map(lambda t: t.to(cuda_device), args)
        runs.append(wl.step_fn(card_tree, *card_args))
    cpu = wl.step_fn(tree, *tree_map(torch.clone, args))
    a, b = (leaves(r) for r in runs)
    for x, y, w in zip(a, b, leaves(cpu)):
        assert x.device.type == "cuda"
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
        if x.dtype == torch.int8:
            assert int((x.cpu().int() - w.int()).abs().max()) <= 1
        else:
            torch.testing.assert_close(x.cpu(), w, rtol=1e-4, atol=1e-4)
