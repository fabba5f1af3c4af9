"""The port's gradients against the JAX package's, on the CPU.

For the five LM smoke configs, the four GNNs and DLRM the port loads the
reference's own parameters (``init_params`` / ``*_init`` at
``PRNGKey(0)``, through numpy) and the same inputs, and its autograd
gradients are held against ``jax.value_and_grad`` of the reference's
loss: the loss within rtol 1e-5 and every gradient element within
1e-4·(|g| + max|g|) of the reference's (relative to the element and to
its leaf's scale; float32, two summation orders).  The LMs' attention
runs through ``layers._FlashCore`` (the reference's custom VJP, tile
recomputation): it is also held against ``attn_impl="naive"`` at the
reference's own bounds (loss 1e-4, gradients 5e-3), and a
``saved_tensors_hooks`` check shows it saves no [S, T] tensor.  The
vertex-cut losses ``mgn_loss_dist`` / ``egnn_loss_dist`` on 2 and 4
shards give the single device's gradients (within the same bound): the
port's loss is one value on shard 0's device, where the reference's
``psum`` inside the loss scales each shard's gradient by k.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.data import graphs as RDG
from repro.models import dlrm as RD
from repro.models import transformer as RT
import repro_torch.configs as TC
from repro_torch.data import graphs as TDG
from repro_torch.graph.partition import ShardMesh
from repro_torch.models import dlrm as TD
from repro_torch.models import gnn as TG
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.tree import leaves
from test_torch_gnn import LOSS, _mgn_dist_parts, cases  # noqa: F401
from test_torch_models import (LM_ARCHS, S, _Arch, _batch, _long,
                               _ref_leaves)

GRAD_TOL = 1e-4
GNN_ARCHS = ["gat-cora", "egnn", "meshgraphnet", "dimenet"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _close_grad(got, want, what=""):
    """|got − want| <= GRAD_TOL·(|want| + max|want|), elementwise."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    lim = GRAD_TOL * (np.abs(want) + np.abs(want).max())
    bad = np.abs(got - want) > lim
    assert not bad.any(), (what, float(np.abs(got - want).max()),
                           float(lim.max()))


def _port_grads(model, loss_fn):
    """(loss, {name: grad}) of the port's model, its float leaves trained."""
    model.trainable()
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    loss = loss_fn(model)
    grads = torch.autograd.grad(loss, params, allow_unused=True,
                                materialize_grads=True)
    model.trainable(False)
    return float(loss.detach()), dict(zip(names, grads))


# ---------------------------------------------------------------------------
# LMs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    built = {}

    def get(arch):
        if arch not in built:
            built[arch] = _Arch(arch)
        return built[arch]
    return get


def _lm_port_batch(a):
    return {k: _long(v) for k, v in _batch(a.toks).items()}


def _port_name(path, li):
    """The port's parameter name of the reference tree's ``path``."""
    if path[0] == "layers":
        return ".".join(("layers", str(li)) + path[1:])
    return ".".join(path)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_gradients_match_reference(arch, lm):
    a = lm(arch)
    cfg = a.cfg
    b = jax.tree.map(jnp.asarray, _batch(a.toks))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: RT.loss_fn(cfg, p, b)))(a.params)
    got_loss, got = _port_grads(a.model,
                                lambda m: m.loss_fn(_lm_port_batch(a)))
    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)
    seen = set()
    for path, g in _ref_leaves(jax.tree.map(np.asarray, grads)):
        if path[0] == "layers":
            for li in range(a.tcfg.n_layers):
                use_moe = TT._layer_pattern(a.tcfg, li)[0]
                if path[1] == ("ffn" if use_moe else "moe"):
                    # the set the layer does not run: zero in the reference
                    assert not np.any(g[li]), path
                    continue
                name = _port_name(path, li)
                _close_grad(got[name], g[li], name)
                seen.add(name)
        elif path[:3] == ("mtp", "layer", "moe"):
            assert not np.any(g), path
        else:
            name = _port_name(path, None)
            _close_grad(got[name], g, name)
            seen.add(name)
    assert seen == set(got)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-v3-671b",
                                  "llama4-maverick-400b-a17b"])
def test_flash_gradients_equal_naive(arch, lm):
    """The port's flash core against its naive attention, at the bounds of
    the reference's own test (``test_flash_attention_equals_naive``)."""
    a = lm(arch)
    b = _lm_port_batch(a)
    l1, g1 = _port_grads(a.model, lambda m: m.loss_fn(b))
    naive = a.model.with_config(attn_impl="naive")
    l2, g2 = _port_grads(naive, lambda m: m.loss_fn(b))
    assert abs(l1 - l2) < 1e-4
    assert max(float((g1[n] - g2[n]).abs().max()) for n in g1) < 5e-3


def _saved_shapes(fn):
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, shapes


@pytest.mark.parametrize("chunk", [None, 16])
def test_flash_core_saves_no_score_matrix(chunk):
    """GQA attention over 4 KV tiles: the flash Function saves its primals,
    m, l and out, and nothing of [S, T] (or of one [S, kv_chunk] tile);
    naive attention does save its [.., S, T] weights."""
    g = torch.Generator().manual_seed(0)
    b, s, h, hkv, d = 2, 64, 4, 2, 16
    q = torch.randn((b, s, h, d), generator=g, requires_grad=True)
    k = torch.randn((b, s, hkv, d), generator=g, requires_grad=True)
    v = torch.randn((b, s, hkv, d), generator=g, requires_grad=True)
    pos = torch.arange(s)[None].expand(b, s)
    out, shapes = _saved_shapes(lambda: TL._sdpa(
        q, k, v, pos, chunk, torch.float32, kv_chunk=16))
    assert shapes and all(np.prod(sh) <= b * s * h * d for sh in shapes), \
        shapes
    assert not any(s in sh[-2:] and 16 in sh[-1:] for sh in shapes
                   if len(sh) >= 2), shapes
    _, naive = _saved_shapes(lambda: TL._sdpa(q, k, v, pos, chunk,
                                              torch.float32,
                                              impl="naive"))
    assert any(sh[-2:] == (s, s) for sh in naive)
    # and the gradients agree with naive attention's
    gq = torch.autograd.grad(out.square().sum(), (q, k, v))
    ref = TL._sdpa(q, k, v, pos, chunk, torch.float32, impl="naive")
    gr = torch.autograd.grad(ref.square().sum(), (q, k, v))
    for x, y in zip(gq, gr):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


def test_flash_core_fully_masked_rows_are_finite():
    """The reference's ``test_flash_core_handles_fully_masked_rows`` in the
    port: a row with no valid key gives 0 and finite gradients."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 4, 2, 8), generator=g, requires_grad=True)
    k = torch.randn((1, 8, 1, 8), generator=g)
    v = torch.randn((1, 8, 1, 8), generator=g)
    pos = torch.tensor([[-1, 0, 1, 2]])
    out = TL._sdpa(q, k, v, pos, None, torch.float32, kv_chunk=4)
    (gq,) = torch.autograd.grad(out.sum(), (q,))
    assert torch.isfinite(out).all() and torch.isfinite(gq).all()
    assert float(out[0, 0].abs().max()) == 0.0


def test_remat_leaves_gradients_bitwise():
    """``remat="full"`` (each layer recomputed in the backward) against
    ``remat="none"``: the same gradients, bit for bit."""
    cfg = TC.get("llama3.2-3b").smoke()
    model = TT.init_params(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, S + 1),
                         generator=torch.Generator().manual_seed(2))
    b = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    _, g1 = _port_grads(model.with_config(remat="full"),
                        lambda m: m.loss_fn(b))
    _, g2 = _port_grads(model.with_config(remat="none"),
                        lambda m: m.loss_fn(b))
    assert all(torch.equal(g1[n], g2[n]) for n in g1)


# ---------------------------------------------------------------------------
# GNNs and DLRM
# ---------------------------------------------------------------------------

def _gnn_port_grads(c):
    return _port_grads(c.model, lambda m: m.loss(c.tbatch))


def _ref_tree_grads(loss_fn, params):
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), jax.tree.map(np.asarray, grads)


def _flat_ref(tree, prefix=()):
    """(dotted name, leaf) of a reference tree of dicts and lists, the
    names of the port's ``named_parameters``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_ref(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat_ref(v, prefix + (str(i),))
    else:
        yield ".".join(prefix), tree


def _check_tree(got, want_tree):
    names = set()
    for name, g in _flat_ref(want_tree):
        _close_grad(got[name], g, name)
        names.add(name)
    assert names == set(got)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_gradients_match_reference(cases, arch):
    c = cases(arch, "smoke")
    cfg, kind, b = c.cfg, c.kind, c.batch
    loss, grads = _ref_tree_grads(lambda p: LOSS[kind](cfg, p, b), c.params)
    got_loss, got = _gnn_port_grads(c)
    np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
    _check_tree(got, grads)


@pytest.mark.parametrize("multi_hot,dtype", [(1, "float32"), (3, "float32"),
                                             (1, "bfloat16")])
def test_dlrm_gradients_match_reference(multi_hot, dtype):
    """Single- and multi-hot, float32 and bfloat16 tables: the dense table
    gradient (every row; zero where no id looked it up) and the MLPs'."""
    cfg = dataclasses.replace(RC.get("dlrm-rm2").smoke(),
                              multi_hot=multi_hot, dtype=dtype)
    tcfg = dataclasses.replace(TC.get("dlrm-rm2").smoke(),
                               multi_hot=multi_hot, dtype=dtype)
    params = jax.jit(lambda k: RD.dlrm_init(cfg, k))(jax.random.PRNGKey(0))
    batch = RDG.dlrm_batch(cfg, 32, seed=5)
    loss, grads = _ref_tree_grads(lambda p: RD.dlrm_loss(cfg, p, batch),
                                  params)
    model = TD.load_reference_params(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    got_loss, got = _port_grads(model, lambda m: m.loss(tb))
    np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
    assert got["tables"].dtype == getattr(torch, dtype)
    if dtype == "bfloat16":
        # the rows' sums of bfloat16 cotangents round per addition: held
        # to two bfloat16 steps of the element beside the bound
        g, w = _np(got["tables"]), _np(grads["tables"])
        assert np.all(np.abs(g - w) <= 2 ** -7 * np.abs(w)
                      + GRAD_TOL * np.abs(w).max())
        got = {k: v for k, v in got.items() if k != "tables"}
        grads = {k: v for k, v in grads.items() if k != "tables"}
    _check_tree(got, grads)


def _dist_grads(c, shards, mesh, fn):
    return _port_grads(c.model, lambda m: fn(c.tcfg, m, shards, mesh))


@pytest.mark.parametrize("k", [2, 4])
def test_mgn_dist_gradients_match_single_device(cases, k):
    c = cases("meshgraphnet", "smoke")
    _, shards = _mgn_dist_parts(c, k, 2.0)
    loss, got = _dist_grads(c, shards, ShardMesh.on("cpu", k),
                            TG.mgn_loss_dist)
    want_loss, want = _gnn_port_grads(c)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    for name in want:
        _close_grad(got[name], want[name], name)


@pytest.mark.parametrize("k", [2, 4])
def test_egnn_dist_gradients_match_single_device(cases, k):
    """EGNN's vertex-cut loss (per-node regression) on k shards against
    the same loss on one shard (``mesh=None``)."""
    c = cases("egnn", "smoke")
    b = {key: np.asarray(v) for key, v in c.batch.items()
         if not isinstance(v, int)}
    n = b["feats"].shape[0]
    target = np.random.default_rng(1).normal(
        size=(n, c.tcfg.d_out)).astype(np.float32)
    b["target"] = target
    src, dst = b["src"], b["dst"]

    def shards_of(k_):
        part = TDG.dst_block_partition(src, dst, n, k_, pad_factor=2.0)
        return TDG.shard_batch(b, part, ("feats", "coords", "target"),
                               devices=["cpu"] * k_)
    one = shards_of(1)[0]
    want_loss, want = _port_grads(
        c.model, lambda m: TG.egnn_loss_dist(c.tcfg, m, one))
    loss, got = _dist_grads(c, shards_of(k), ShardMesh.on("cpu", k),
                            TG.egnn_loss_dist)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    for name in want:
        _close_grad(got[name], want[name], name)


def test_dist_replicas_carry_gradients(cases):
    """Shards on another device than the weights' get differentiable
    copies: the gradient reaches the one set of weights (a mesh of two
    CPU devices named apart, ``cpu`` and ``cpu:0``)."""
    c = cases("meshgraphnet", "smoke")
    _, shards = _mgn_dist_parts(c, 2, 2.0)
    reps = TG._replicas(c.model.trainable(), [torch.device("cpu"),
                                              torch.device("meta")])
    c.model.trainable(False)
    assert reps[0] is c.model
    w = leaves(reps[1])[0]
    assert w.device.type == "meta" and w.grad_fn is not None
