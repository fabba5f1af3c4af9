"""The port on the card (``gpu`` marker; they skip without a CUDA device).

This module imports neither JAX nor the JAX package, so it also runs on a
machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each CUDA kernel is held against its plain PyTorch version on the same card
tensors, bitwise (float sums included: the plain versions repeat the
kernels' reduction order and the kernels are built with --fmad=false), and
the cuda engine against the port's pull engine."""
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
from repro_torch.kernels import edge_reduce as TER
from repro_torch.kernels import ops as TO


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


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.gpu
@pytest.mark.parametrize("density", [0.05, 1.0])
@pytest.mark.parametrize("name", ["BFS", "WSP", "WPR"])
def test_kernels_match_plain_on_card(cuda_device, name, density):
    dev = cuda_device
    g = TS.rmat_graph(400, 3200, seed=11, device=dev)
    rnd = _round(name, g.n)
    ein, eout = TS.to_blocked_ell(g), TS.to_blocked_ell(g, direction="out")
    res = TS.to_push_resolution(g)
    n_pad = ein.n_pad
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
    t_in = TER.tile_activity(ein.nbrs, ein.mask, ein.tile_nnz, act)
    t_out = TER.tile_activity_push(eout.tile_nnz, act)
    t_res = TER.resolution_tile_activity(res.contrib, t_out, res.tile_nnz)
    pull_args = (rnd, t_in, ein.nbrs, ein.weight, ein.capacity, ein.mask,
                 act, od, wd, st, float(g.n), True)
    push_args = (rnd, t_out, eout.nbrs, eout.weight, eout.capacity,
                 eout.mask, act, od, wd, st, float(g.n))
    TER.reset_launches()
    k_pull = TER.pull_sweep(*pull_args)
    k_push = TER.push_sweep(*push_args)
    k_res = TER.resolve_sweep(rnd, t_res, res.valid, res.in2out, k_push)
    torch.cuda.synchronize()
    assert TER.LAUNCHES == {"pull": 1, "push": 1, "resolve": 1}
    p_pull = TER._pull_plain(*pull_args)
    p_push = TER._push_plain(*push_args)
    p_res = TER._resolve_plain(rnd, t_res, res.valid, res.in2out, p_push)
    for a, b in zip(k_pull + k_push + k_res, p_pull + p_push + p_res):
        assert torch.equal(_bits(a), _bits(b))


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
    want = TE.run_program(g, prog, engine="pull")
    assert torch.equal(got.value, want.value)
    assert got.stats.engine_used == "cuda"


@pytest.mark.gpu
def test_weighted_pagerank_push_equals_pull_on_card(cuda_device):
    g = TS.rmat_graph(400, 3200, seed=11, device=cuda_device)
    dk = TSy.weighted_pagerank_kernels(g.n)
    pull = TE.run_direct(g, dk, engine="cuda")
    push = TE.run_direct(g, dk, engine="cuda", model="push")
    assert torch.equal(_bits(pull.value), _bits(push.value))
    ref = TE.run_direct(g, dk, engine="pull")
    torch.testing.assert_close(pull.value, ref.value, rtol=1e-5, atol=1e-8)
