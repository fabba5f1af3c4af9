"""The plain versions of the level sweep, ELL softmax, embedding bag and
flash attention against the JAX package's Pallas kernels (interpret mode,
as tests/test_kernels.py runs them), plus the port's oracles
(``repro_torch.kernels.ref``) against the reference's.  The CUDA kernels
themselves are held against these plain versions on the card by
tests/test_torch_gpu.py.

Tolerances:
- level: bitwise for min/max/int/bool; allclose rtol 1e-5 for float32
  sums, because XLA's ``jnp.sum`` adds a tile's slots in another order than
  the kernel's fixed lane-then-tree order;
- softmax: 1e-5 (float32 arithmetic in another summation order), 1e-2 for
  bfloat16 output (one bfloat16 step at 1.0 is 2⁻⁷);
- embedding bag: 1e-5 for float32, 2e-2 for bfloat16;
- flash attention: 2e-3 for float32, 2e-2 for bfloat16; the mirrors of
  the card kernels' arithmetic at the card's limits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernel_lang as JK
from repro.graph import segment as JSeg
from repro.graph import structure as JS
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro.kernels.edge_reduce import ell_level_reduce as j_level
from repro.kernels.flash_attention import flash_attention as j_flash
from repro_torch.core import kernel_lang as TK
from repro_torch.graph import structure as TS
from repro_torch.kernels import edge_reduce as TER
from repro_torch.kernels import embedding_bag as TEB
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR
from repro_torch.kernels.flash_attention import flash_attention as t_flash


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# ---------------------------------------------------------------------------
# ell_level_reduce
# ---------------------------------------------------------------------------

def _expr(pkg, kind):
    """One P, built from each package's own kernel_lang."""
    n_f, n_i = pkg.Var("n", pkg.FLT), pkg.Var("n", pkg.INT)
    return {"n+w": pkg.Bin("+", n_f, pkg.Var("w", pkg.FLT)),
            "n+1": pkg.Bin("+", n_i, pkg.Lit(1, pkg.INT)),
            "min(n,c)": pkg.Bin("min", n_f, pkg.Var("c", pkg.FLT)),
            "n/outdeg": pkg.Bin("/", n_f, pkg.Var("outdeg", pkg.FLT)),
            "n": n_i}[kind]


def _level_graph(block_v=8, block_e=128, seed=11, density=0.6):
    jg = JS.rmat_graph(40, 200, seed=seed)
    tg = TS.from_arrays(jg.n, *jg.host_edges(), device="cpu")
    je = JS.to_blocked_ell(jg, block_v=block_v, block_e=block_e)
    te = TS.to_blocked_ell(tg, block_v=block_v, block_e=block_e)
    rng = np.random.default_rng(seed)
    active = (rng.random(je.n_pad) < density).astype(np.int32)
    outdeg = rng.integers(1, 5, je.n_pad).astype(np.float32)
    return je, te, active, outdeg, rng


def _state(rng, n_pad, dtype, ident):
    if dtype == np.float32:
        v = rng.uniform(0, 9, n_pad).astype(np.float32)
    else:
        v = rng.integers(0, 50, n_pad).astype(np.int32)
    v[rng.random(n_pad) < 0.2] = ident
    return v


def _assert_level(got, want, op, dtype):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype
    if op == "sum" and want.dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op,dtype,p", [
    ("min", np.float32, "n+w"), ("max", np.float32, "n+w"),
    ("sum", np.float32, "n/outdeg"), ("min", np.int32, "n+1"),
    ("max", np.int32, "n+1"), ("sum", np.int32, "n+1"),
    ("or", np.int32, "n")])
@pytest.mark.parametrize("block", [(8, 128), (16, 128), (8, 256)])
def test_level_value_matches_pallas(op, dtype, p, block):
    je, te, active, outdeg, rng = _level_graph(*block)
    ident = JSeg.identity(op, jnp.dtype(dtype))
    ident = int(ident) if dtype == np.int32 else float(ident)
    state = _state(rng, je.n_pad, dtype, ident)
    if op == "or":
        state = (state % 2).astype(np.int32)
    want = j_level(je, op, [JK.compile_expr(_expr(JK, p))],
                   [jnp.asarray(state)], [ident], jnp.asarray(active),
                   jnp.asarray(outdeg), block_v=block[0], block_e=block[1])
    got = TER.ell_level_reduce(te, op, [_expr(TK, p)], [_t(state)], [ident],
                               _t(active), _t(outdeg))
    _assert_level(got.numpy(), want, op, dtype)


@pytest.mark.parametrize("block", [(8, 128), (8, 256)])
def test_level_lex_two_levels_with_bests(block):
    """WP-then-SSSP-like lex: max min(n, c), then min n + w among the slots
    tied at the first level's best."""
    je, te, active, outdeg, rng = _level_graph(*block, seed=5, density=0.8)
    i0 = float(JSeg.identity("max", jnp.float32))
    i1 = float(JSeg.identity("min", jnp.float32))
    s0 = _state(rng, je.n_pad, np.float32, i0).round()
    s1 = _state(rng, je.n_pad, np.float32, i1)
    jp = [JK.compile_expr(_expr(JK, "min(n,c)")),
          JK.compile_expr(_expr(JK, "n+w"))]
    tp = [_expr(TK, "min(n,c)"), _expr(TK, "n+w")]
    kw = dict(block_v=block[0], block_e=block[1])
    jb0 = j_level(je, "max", jp[:1], [jnp.asarray(s0)], [i0],
                  jnp.asarray(active), jnp.asarray(outdeg), **kw)
    tb0 = TER.ell_level_reduce(te, "max", tp[:1], [_t(s0)], [i0],
                               _t(active), _t(outdeg))
    np.testing.assert_array_equal(tb0.numpy(), np.asarray(jb0))
    want = j_level(je, "min", jp, [jnp.asarray(s0), jnp.asarray(s1)],
                   [i0, i1], jnp.asarray(active), jnp.asarray(outdeg),
                   bests=[jb0], **kw)
    got = TER.ell_level_reduce(te, "min", tp, [_t(s0), _t(s1)], [i0, i1],
                               _t(active), _t(outdeg), bests=[tb0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the tie mask binds: some rows reduce to another value without it
    free = TER.ell_level_reduce(te, "min", tp[1:], [_t(s1)], [i1],
                                _t(active), _t(outdeg))
    assert not torch.equal(free, got)


@pytest.mark.parametrize("n_levels", [1, 2])
def test_level_nonbot_matches_pallas(n_levels):
    je, te, active, outdeg, rng = _level_graph(seed=7)
    i0 = int(JSeg.identity("min", jnp.int32))
    i1 = float(JSeg.identity("min", jnp.float32))
    s0 = _state(rng, je.n_pad, np.int32, i0)
    s1 = _state(rng, je.n_pad, np.float32, i1)
    jp = [JK.compile_expr(_expr(JK, "n+1")),
          JK.compile_expr(_expr(JK, "n+w"))][:n_levels]
    tp = [_expr(TK, "n+1"), _expr(TK, "n+w")][:n_levels]
    states, idents = [s0, s1][:n_levels], [i0, i1][:n_levels]
    jb, tb = [], []
    if n_levels == 2:
        jb = [j_level(je, "min", jp[:1], [jnp.asarray(s0)], [i0],
                      jnp.asarray(active), jnp.asarray(outdeg))]
        tb = [_t(np.asarray(jb[0]))]
    want = j_level(je, "min", jp, [jnp.asarray(s) for s in states], idents,
                   jnp.asarray(active), jnp.asarray(outdeg), bests=jb,
                   mode="nonbot")
    got = TER.ell_level_reduce(te, "min", tp, [_t(s) for s in states],
                               idents, _t(active), _t(outdeg), bests=tb,
                               mode="nonbot")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _hub_level_graph(seed=17):
    """A 128-vertex rmat graph plus a hub with 2,600 more in-edges: its row
    spans 21 slot tiles while the other rows fill one.  Tiled at (64, 128)
    so that the interpreter steps 2 × 21 tiles."""
    base = JS.rmat_graph(128, 600, seed=seed)
    src, dst, w, c = (np.asarray(a) for a in base.host_edges())
    rng = np.random.default_rng(seed)
    hub = rng.integers(0, 128, 2600).astype(src.dtype)
    jg = JS.from_edges(128, np.concatenate([src, hub]),
                       np.concatenate([dst, np.full(2600, 70, dst.dtype)]),
                       np.concatenate([w, rng.uniform(0.5, 2, 2600)
                                       .astype(np.float32)]),
                       np.concatenate([c, rng.uniform(0.5, 2, 2600)
                                       .astype(np.float32)]))
    tg = TS.from_arrays(jg.n, *jg.host_edges(), device="cpu")
    je = JS.to_blocked_ell(jg, block_v=64, block_e=128)
    te = TS.to_blocked_ell(tg, block_v=64, block_e=128)
    active = (rng.random(je.n_pad) < 0.8).astype(np.int32)
    outdeg = rng.integers(1, 5, je.n_pad).astype(np.float32)
    return je, te, active, outdeg, rng


@pytest.mark.parametrize("op,dtype,p", [
    ("min", np.float32, "n+w"), ("max", np.int32, "n+1"),
    ("sum", np.float32, "n/outdeg")])
def test_level_hub_row_matches_pallas(op, dtype, p):
    """The layout the card's walk spreads over the grid: one row tile holds
    a hub row of 21 slot tiles, the other row tiles one each."""
    je, te, active, outdeg, rng = _hub_level_graph()
    assert te.width // 128 >= 20
    assert int((te.tile_nnz > 0).sum(1).max()) >= 20
    assert int((te.tile_nnz > 0).sum(1).min()) == 1
    ident = JSeg.identity(op, jnp.dtype(dtype))
    ident = int(ident) if dtype == np.int32 else float(ident)
    state = _state(rng, je.n_pad, dtype, ident)
    want = j_level(je, op, [JK.compile_expr(_expr(JK, p))],
                   [jnp.asarray(state)], [ident], jnp.asarray(active),
                   jnp.asarray(outdeg), block_v=64, block_e=128)
    got = TER.ell_level_reduce(te, op, [_expr(TK, p)], [_t(state)], [ident],
                               _t(active), _t(outdeg))
    _assert_level(got.numpy(), want, op, dtype)


def test_level_matches_port_oracle_and_wdeg_default():
    """Against the port's own ``ref_edge_level``, with every source active
    and the default ``wdeg`` of ones read by P."""
    je, te, _active, outdeg, rng = _level_graph(seed=3)
    ident = float(JSeg.identity("min", jnp.float32))
    state = _state(rng, te.n_pad, np.float32, ident)
    p = TK.Bin("*", TK.Var("n", TK.FLT), TK.Var("wdeg", TK.FLT))
    got = TER.ell_level_reduce(te, "min", [p], [_t(state)], [ident],
                               torch.ones(te.n_pad, dtype=torch.bool),
                               _t(outdeg))
    want = TR.ref_edge_level("min", _t(state), te.srcs, te.mask,
                             lambda nv, srcs: nv * 1.0, ident, ident)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# ell_softmax
# ---------------------------------------------------------------------------

def _softmax_case(n, e, seed, scale, graph="rmat"):
    make = JS.rmat_graph if graph == "rmat" else JS.uniform_graph
    ell = JS.to_blocked_ell(make(n, e, seed=seed))
    rng = np.random.default_rng(seed)
    scores = (rng.normal(size=ell.srcs.shape) * scale).astype(np.float32)
    return scores, np.array(ell.mask)


@pytest.mark.parametrize("n,e,seed", [(64, 400, 0), (100, 600, 1),
                                      (128, 2000, 2)])
def test_ell_softmax_matches_pallas(n, e, seed):
    scores, mask = _softmax_case(n, e, seed, 5.0)
    mask[3] = False                                  # an all-masked row
    want = np.asarray(JO.ell_softmax(jnp.asarray(scores), jnp.asarray(mask)))
    got = TO.ell_softmax(_t(scores), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.all(got[~mask] == 0.0)
    assert np.all(got[3] == 0.0)
    rows = got.sum(axis=1)
    np.testing.assert_allclose(rows[mask.any(axis=1)], 1.0, atol=1e-5)
    np.testing.assert_allclose(
        got, TR.ref_ell_softmax(_t(scores), _t(mask)).numpy(), atol=1e-5)


def test_ell_softmax_online_stability():
    """±1e4 scores: the masked slots' raw scores exponentiate to inf in the
    normalising pass; they must come out 0, never NaN."""
    scores, mask = _softmax_case(32, 200, 3, 1e4, graph="uniform")
    want = np.asarray(JO.ell_softmax(jnp.asarray(scores), jnp.asarray(mask)))
    got = TO.ell_softmax(_t(scores), _t(mask)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_ell_softmax_bf16():
    scores, mask = _softmax_case(64, 400, 4, 3.0)
    sj = jnp.asarray(scores).astype(jnp.bfloat16)
    want = np.asarray(JO.ell_softmax(sj, jnp.asarray(mask)), np.float32)
    got = TO.ell_softmax(_t(scores).to(torch.bfloat16), _t(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2)


# ---------------------------------------------------------------------------
# embedding_bag
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v,d,b,k", [(64, 128, 128, 1), (100, 64, 256, 4),
                                     (37, 256, 128, 8), (16, 128, 512, 2)])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_pallas(v, d, b, k, mode):
    rng = np.random.default_rng(v + d)
    table = rng.normal(size=(v, d)).astype(np.float32)
    idx = rng.integers(0, v, size=(b, k)).astype(np.int32)
    want = JO.embedding_bag(jnp.asarray(table), jnp.asarray(idx), mode=mode)
    got = TO.embedding_bag(_t(table), _t(idx), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_weighted_matches_pallas(mode):
    rng = np.random.default_rng(0)
    table = rng.normal(size=(50, 128)).astype(np.float32)
    idx = rng.integers(0, 50, size=(128, 4)).astype(np.int32)
    w = rng.normal(size=(128, 4)).astype(np.float32)
    want = JO.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                            weights=jnp.asarray(w), mode=mode)
    got = TO.embedding_bag(_t(table), _t(idx), weights=_t(w), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_embedding_bag_negative_and_out_of_range_indices():
    """JAX's table[idx]: a negative index wraps once, then clamps."""
    rng = np.random.default_rng(2)
    v = 40
    table = rng.normal(size=(v, 64)).astype(np.float32)
    idx = rng.integers(-2 * v, 2 * v, size=(128, 3)).astype(np.int32)
    idx[0] = [-1, -v, v]
    want = JO.embedding_bag(jnp.asarray(table), jnp.asarray(idx))
    got = TO.embedding_bag(_t(table), _t(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(
        got[0].numpy(), table[v - 1] + table[0] + table[v - 1], atol=1e-5)


def test_embedding_bag_bf16():
    rng = np.random.default_rng(1)
    table = rng.normal(size=(64, 128)).astype(np.float32)
    idx = rng.integers(0, 64, size=(128, 2)).astype(np.int32)
    tj = jnp.asarray(table).astype(jnp.bfloat16)
    want = np.asarray(JO.embedding_bag(tj, jnp.asarray(idx)), np.float32)
    got = TO.embedding_bag(_t(table).to(torch.bfloat16), _t(idx))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("d,weighted", [(3, False), (65, True)])
def test_embedding_bag_k9_odd_width_matches_pallas(d, weighted):
    """K = 9 (a chunk of 8 slots, then one) at a width the card runs on
    its scalar path."""
    rng = np.random.default_rng(d)
    table = rng.normal(size=(70, d)).astype(np.float32)
    idx = rng.integers(0, 70, size=(128, 9)).astype(np.int32)
    w = rng.normal(size=(128, 9)).astype(np.float32) if weighted else None
    want = JO.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                            weights=None if w is None else jnp.asarray(w),
                            mode="mean")
    got = TO.embedding_bag(_t(table), _t(idx),
                           weights=None if w is None else _t(w), mode="mean")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_embedding_bag_vector_width_follows_width_and_alignment():
    """The card kernel's path: 16 bytes a thread where D is a multiple of
    that and the table's base is 16-byte aligned, one column elsewhere."""
    f32, bf16 = torch.zeros((10, 64)), torch.zeros((10, 64)).bfloat16()
    assert (TEB.vector_width(f32), TEB.vector_width(bf16)) == (4, 8)
    assert TEB.vector_width(torch.zeros((10, 65))) == 1
    assert TEB.vector_width(torch.zeros((10, 12)).bfloat16()) == 1
    assert TEB.vector_width(torch.zeros((10, 3))[1:]) == 1
    assert TEB.vector_width(torch.zeros(41)[1:].view(10, 4)) == 1
    assert TEB.vector_width(torch.zeros((10, 4))[1:]) == 4


def test_embedding_bag_any_batch_and_width():
    """The port takes B and D that the Pallas tiling would refuse."""
    rng = np.random.default_rng(4)
    table = _t(rng.normal(size=(30, 20)).astype(np.float32))
    idx = _t(rng.integers(0, 30, size=(7, 3)).astype(np.int32))
    got = TO.embedding_bag(table, idx, mode="mean")
    torch.testing.assert_close(got, TR.ref_embedding_bag(table, idx,
                                                         mode="mean"),
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

def _qkv(b, h, hkv, s, d, seed, t=None):
    rng = np.random.default_rng(seed)
    t = s if t is None else t
    return (rng.normal(size=(b, h, s, d)).astype(np.float32),
            rng.normal(size=(b, hkv, t, d)).astype(np.float32),
            rng.normal(size=(b, hkv, t, d)).astype(np.float32))


@pytest.mark.parametrize("b,h,hkv,s,d", [(1, 4, 4, 64, 32),
                                         (2, 4, 2, 128, 16),
                                         (1, 8, 1, 256, 64),
                                         (1, 4, 2, 80, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas(b, h, hkv, s, d, causal):
    q, k, v = _qkv(b, h, hkv, s, d, h * s)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, block_q=64, block_k=64)
    got = t_flash(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("hkv", [2, 1])
def test_flash_attention_chunked_local(hkv):
    q, k, v = _qkv(1, 2, hkv, 128, 32, 0)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=True, chunk=32, block_q=64, block_k=64)
    got = t_flash(_t(q), _t(k), _t(v), causal=True, chunk=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)
    oracle = TR.ref_flash_attention(_t(q), _t(k), _t(v), causal=True,
                                    chunk=32)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_flash_attention_bf16():
    q, k, v = _qkv(1, 2, 2, 64, 32, 1)
    cast = lambda a: jnp.asarray(a).astype(jnp.bfloat16)   # noqa: E731
    want = np.asarray(j_flash(cast(q), cast(k), cast(v)), np.float32)
    bf = lambda a: _t(a).to(torch.bfloat16)                # noqa: E731
    got = t_flash(bf(q), bf(k), bf(v))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("qscale,chunk", [(1.0, None), (8.0, None),
                                          (1.0, 32)])
def test_flash_split_p_matches_pallas_bf16(qscale, chunk):
    """The bfloat16 card kernel's arithmetic for p·v, mirrored in plain
    PyTorch: P as a bfloat16 high part plus the bfloat16 rounding of the
    rest, each product of bfloat16 values exact in float32.  Held against
    the Pallas kernel in bfloat16 to the card's limit, one bfloat16 step of
    the element (2^-7 of it) plus 1e-4.

    This checks the precision argument for the split only: the mirror
    calls no port code but ``attention_mask`` and follows neither the
    kernel's online rescaling nor its exp2.  The kernel itself is held to
    the same limit on the card by ``tests/test_torch_gpu.py::
    test_flash_sm90_kernel_matches_plain_on_card``."""
    from repro_torch.kernels import flash_attention as TFA
    q, k, v = _qkv(1, 4, 2, 96, 64, 17)
    q = q * qscale
    cast = lambda a: jnp.asarray(a).astype(jnp.bfloat16)   # noqa: E731
    want = np.asarray(j_flash(cast(q), cast(k), cast(v), causal=True,
                              chunk=chunk, block_q=32, block_k=32),
                      np.float32)
    bf = lambda a: _t(a).to(torch.bfloat16).float()        # noqa: E731
    qf, kf, vf = bf(q)[0], bf(k)[0].repeat_interleave(2, 0), \
        bf(v)[0].repeat_interleave(2, 0)
    mask = TFA.attention_mask(96, 96, True, chunk)
    logits = torch.where(mask, qf @ kf.transpose(1, 2) / 8.0, -1e30)
    p = torch.where(mask, torch.exp(logits - logits.amax(-1, keepdim=True)),
                    0.0)
    hi = p.to(torch.bfloat16)
    lo = (p - hi.float()).to(torch.bfloat16)
    assert float((hi.float() + lo.float() - p).abs().max()) <= \
        2.0 ** -16 * float(p.abs().max())
    acc = hi.float() @ vf + lo.float() @ vf
    got = (acc / p.sum(-1, keepdim=True).clamp(min=1e-30)).to(torch.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want[0], rtol=2.0 ** -7,
                               atol=1e-4)


def _tf32(x):
    """x rounded to TF32 (10 stored mantissa bits, to nearest, ties away
    from zero), as a bit mask on the float32 words: the card's
    ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_tf32(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm_3xtf32(a, b):
    """a @ b as the float32 card kernel takes it: hi·lo and lo·hi, then
    hi·hi, each product of TF32 values exact in float32."""
    (ah, al), (bh, bl) = _split_tf32(a), _split_tf32(b)
    return ah @ bl + al @ bh + ah @ bh


@pytest.mark.parametrize("qscale,chunk", [(1.0, None), (8.0, None),
                                          (1.0, 48), (8.0, 48)])
def test_flash_3xtf32_matches_pallas_f32(qscale, chunk):
    """The float32 card kernel's arithmetic, mirrored in plain PyTorch:
    both products in 3xTF32 (every operand a TF32 high part plus the TF32
    rounding of the rest; the low parts' product dropped).  Held against
    the Pallas kernel in float32 to the card's limit, 1e-5 + 1e-5 of the
    element; a chunk of 48 cuts the kernel's 32-key tiles.

    This checks the precision argument for 3xTF32 only: the mirror calls no
    port code but ``attention_mask`` and follows neither the kernel's
    online rescaling nor its exp2.  The kernel itself is held to the same
    limit on the card by ``tests/test_torch_gpu.py::
    test_flash_sm90_kernel_matches_plain_on_card``."""
    from repro_torch.kernels import flash_attention as TFA
    q, k, v = _qkv(1, 4, 2, 96, 64, 23)
    q = q * qscale
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, chunk=chunk, block_q=32,
                              block_k=32))
    qf = _t(q)[0]
    kf, vf = (_t(x)[0].repeat_interleave(2, 0) for x in (k, v))
    hi, lo = _split_tf32(qf)
    assert not bool(((hi.view(torch.int32) | lo.view(torch.int32))
                     & 0x1FFF).any())
    assert bool(((hi + lo - qf).abs() <= 2.0 ** -22 * qf.abs()).all())
    mask = TFA.attention_mask(96, 96, True, chunk)
    logits = torch.where(mask, _mm_3xtf32(qf, kf.transpose(1, 2)) / 8.0,
                         -1e30)
    p = torch.where(mask, torch.exp(logits - logits.amax(-1, keepdim=True)),
                    0.0)
    got = _mm_3xtf32(p, vf) / p.sum(-1, keepdim=True).clamp(min=1e-30)
    np.testing.assert_allclose(got.numpy(), want[0], rtol=1e-5, atol=1e-5)


def test_flash_attention_cross_lengths():
    """S ≠ T, neither a power of two: positions start at 0 for both."""
    q, k, v = _qkv(1, 2, 1, 48, 16, 5, t=80)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=True, block_q=64, block_k=64)
    got = t_flash(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


# ---------------------------------------------------------------------------
# The port's oracles against the reference's.
# ---------------------------------------------------------------------------

def test_ref_oracles_match_reference():
    rng = np.random.default_rng(9)
    table = rng.normal(size=(20, 16)).astype(np.float32)
    flat = rng.integers(0, 20, size=30).astype(np.int32)
    offsets = np.array([0, 4, 4, 11, 25], np.int32)
    w = rng.normal(size=30).astype(np.float32)
    for mode in ("sum", "mean", "max"):
        for weights in (None, w):
            want = JR.ref_embedding_bag(
                jnp.asarray(table), jnp.asarray(flat), jnp.asarray(offsets),
                mode=mode,
                weights=None if weights is None else jnp.asarray(weights))
            got = TR.ref_embedding_bag(
                _t(table), _t(flat), _t(offsets), mode=mode,
                weights=None if weights is None else _t(weights))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5)
    idx2 = rng.integers(0, 20, size=(6, 3)).astype(np.int32)
    np.testing.assert_allclose(
        TR.ref_embedding_bag(_t(table), _t(idx2), mode="max").numpy(),
        np.asarray(JR.ref_embedding_bag(jnp.asarray(table),
                                        jnp.asarray(idx2), mode="max")))
    scores = (rng.normal(size=50) * 30).astype(np.float32)
    seg = rng.integers(0, 12, size=50).astype(np.int32)       # unsorted
    np.testing.assert_allclose(
        TR.ref_segment_softmax(_t(scores), _t(seg), 13).numpy(),
        np.asarray(JR.ref_segment_softmax(jnp.asarray(scores),
                                          jnp.asarray(seg), 13)), atol=1e-6)
    vals = rng.normal(size=(16, 128)).astype(np.float32)
    mask = rng.random((16, 128)) < 0.3
    for op in ("min", "max", "sum"):
        np.testing.assert_allclose(
            TR.ref_ell_reduce(op, _t(vals), _t(mask), 0.0).numpy(),
            np.asarray(JR.ref_ell_reduce(op, jnp.asarray(vals),
                                         jnp.asarray(mask), 0.0)),
            atol=1e-5)
    q, k, v = _qkv(1, 4, 2, 32, 16, 3)
    for causal, chunk in ((True, None), (False, None), (True, 8)):
        np.testing.assert_allclose(
            TR.ref_flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                   chunk=chunk).numpy(),
            np.asarray(JR.ref_flash_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                causal=causal, chunk=chunk)), rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_plain_versions_and_count_nothing():
    from repro_torch.kernels import embedding_bag as TEB
    from repro_torch.kernels import flash_attention as TFA
    from repro_torch.kernels import segment_softmax as TSS
    for mod in (TEB, TFA, TSS):
        mod.reset_launches()
    table = torch.ones((5, 8))
    TO.embedding_bag(table, torch.zeros((2, 3), dtype=torch.int32))
    TO.ell_softmax(torch.zeros((8, 128)), torch.ones((8, 128), dtype=bool))
    q = torch.zeros((1, 2, 4, 16))
    t_flash(q, q, q)
    assert TEB.LAUNCHES == {"bag": 0} and TSS.LAUNCHES == {"softmax": 0}
    assert TFA.LAUNCHES == {"flash": 0, "flash_sm90": 0, "flash_f32": 0}
