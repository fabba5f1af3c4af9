"""The port's DLRM RM2 against the JAX package's, on the CPU.

``repro_torch.models.dlrm`` and ``repro_torch.configs.dlrm_rm2`` held
against ``repro``'s.  Each model loads the reference's own parameters
(``dlrm_init(cfg, PRNGKey(0))``, through numpy) and takes the inputs of the
reference's ``dlrm_batch`` at a numpy seed (B = 64), at ``smoke()`` and at
``full()``'s widths with ``vocab`` cut to 1,000 (26 × 1,000 × 64 floats),
single-hot and multi-hot (K = 3).  In float32 the logits, the user vector
and the retrieval scores (1,000 candidates) are held allclose at rtol =
atol = 1e-4 (two float32 summation orders through five layers), the loss
within rtol 1e-5.  With bfloat16 tables the single-hot lookup is held
bitwise (one row, cast exactly) and the multi-hot one within
2^-7·Σ|rows| (the reference sums K bfloat16 rows before its cast, and
whether XLA's reduction accumulates in float32 is not promised), then the
forward and loss as in float32.  Beside them: negative and out-of-range
row ids (JAX's ``t[i]`` rule), the interaction's feature order
(``jnp.tril_indices``), the configs and parameter counts, the weights'
round trip, the port's own init and the device rule.  The reference's
outputs are computed once per case per module.
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
import repro_torch.configs as TC
from repro_torch.models import dlrm as TD
from test_torch_gnn import _paths

KEY = jax.random.PRNGKey(0)
SEED = 3
BATCH = 64
N_CAND = 1000
TOL = dict(rtol=1e-4, atol=1e-4)
SIZES = ["smoke", "full"]
MULTI_HOT = [1, 3]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    return np.asarray(x, dtype=np.float32) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


def _cfgs(size, multi_hot=1, dtype="float32"):
    """The reference's and the port's config: ``full()`` with ``vocab``
    cut to 1,000."""
    cut = {"vocab": 1000} if size == "full" else {}
    ref = dataclasses.replace(getattr(RC.get("dlrm-rm2"), size)(),
                              multi_hot=multi_hot, dtype=dtype, **cut)
    port = dataclasses.replace(getattr(TC.get("dlrm-rm2"), size)(),
                               multi_hot=multi_hot, dtype=dtype, **cut)
    return ref, port


def _port(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


class _Case:
    """One config: the reference's parameters, batch, candidates and
    outputs, and the port's model on the same parameters."""

    def __init__(self, size, multi_hot, dtype, params=None):
        cfg, self.tcfg = _cfgs(size, multi_hot, dtype)
        self.cfg = cfg
        self.params = jax.jit(lambda k: RD.dlrm_init(cfg, k))(KEY) \
            if params is None else params
        self.tree = jax.tree.map(np.asarray, self.params)
        self.model = TD.load_reference_params(self.tcfg, self.tree,
                                              device="cpu")
        self.batch = RDG.dlrm_batch(cfg, BATCH, seed=SEED)
        self.tbatch = _port(self.batch)
        rng = np.random.default_rng(SEED)
        self.cand = rng.normal(size=(N_CAND, cfg.embed_dim)) \
            .astype(np.float32)

        def outs(p, b, cand):
            return (RD.dlrm_forward(cfg, p, b["dense"], b["sparse"]),
                    RD.dlrm_loss(cfg, p, b),
                    RD.dlrm_user_vector(cfg, p, b["dense"], b["sparse"]),
                    RD.dlrm_retrieval_scores(cfg, p, b["dense"],
                                             b["sparse"], cand),
                    RD._lookup(cfg, p["tables"], b["sparse"]))
        (self.logits, loss, self.user, self.scores, self.lookup) = \
            jax.jit(outs)(self.params, self.batch, jnp.asarray(self.cand))
        self.loss = float(loss)


@pytest.fixture(scope="module")
def cases():
    made = {}

    def get(size, multi_hot=1, dtype="float32"):
        if (size, multi_hot, dtype) not in made:
            # K does not enter the init: the cases of one size and dtype
            # share the reference's parameters
            same = [c.params for (sz, _, dt), c in made.items()
                    if (sz, dt) == (size, dtype)]
            made[size, multi_hot, dtype] = _Case(
                size, multi_hot, dtype, same[0] if same else None)
        return made[size, multi_hot, dtype]
    return get


def check_forward_and_loss(c):
    got = c.model(c.tbatch["dense"], c.tbatch["sparse"])
    assert got.shape == (BATCH,) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_np(got), _np(c.logits), **TOL)
    loss = float(c.model.loss(c.tbatch))
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, c.loss, rtol=1e-5)


@pytest.mark.parametrize("multi_hot", MULTI_HOT)
@pytest.mark.parametrize("size", SIZES)
def test_dlrm_forward_and_loss_match_reference(cases, size, multi_hot):
    check_forward_and_loss(cases(size, multi_hot))


@pytest.mark.parametrize("multi_hot", MULTI_HOT)
@pytest.mark.parametrize("size", SIZES)
def test_dlrm_retrieval_matches_reference(cases, size, multi_hot):
    """The user vector and the scores against 1,000 candidates (one
    [B, D] × [N, D]ᵀ product), and the scores as that product."""
    c = cases(size, multi_hot)
    b = c.tbatch
    user = c.model.user_vector(b["dense"], b["sparse"])
    np.testing.assert_allclose(_np(user), _np(c.user), **TOL)
    cand = torch.from_numpy(c.cand)
    scores = c.model.retrieval_scores(b["dense"], b["sparse"], cand)
    assert scores.shape == (BATCH, N_CAND)
    np.testing.assert_allclose(_np(scores), _np(c.scores), **TOL)
    np.testing.assert_allclose(_np(scores), _np(user @ cand.T), atol=1e-5)


@pytest.mark.parametrize("multi_hot", MULTI_HOT)
@pytest.mark.parametrize("size", SIZES)
def test_dlrm_bfloat16_tables_match_reference(cases, size, multi_hot):
    """bfloat16 tables (the MLPs stay float32): the single-hot lookup
    bitwise, the multi-hot one within 2^-7·Σ|rows|; then the forward and
    loss at the float32 tolerances."""
    c = cases(size, multi_hot, "bfloat16")
    tables = c.model["tables"]
    assert tables.dtype == torch.bfloat16
    assert c.model["bot"][0]["w"].dtype == torch.float32
    got = TD._lookup(c.tcfg, tables, c.tbatch["sparse"])
    assert got.dtype == torch.bfloat16
    want = _np(c.lookup)
    if multi_hot == 1:
        assert np.array_equal(_np(got), want)
    else:
        idx = c.tbatch["sparse"].long()
        fields = torch.arange(c.tcfg.n_sparse)[:, None]
        rows_abs = tables[fields, idx].float().abs().sum(dim=2)
        limit = 2.0 ** -7 * _np(rows_abs)
        assert np.all(np.abs(_np(got) - want) <= limit)
    check_forward_and_loss(c)


@pytest.mark.parametrize("multi_hot", MULTI_HOT)
def test_dlrm_indices_follow_the_reference_rule(cases, multi_hot):
    """Negative ids wrap once, then every id is clamped into the table
    (JAX's ``t[i]``): ids in [-V - 5, V + 5) give the reference's lookup
    (bitwise for single-hot) and logits."""
    c = cases("smoke", multi_hot)
    cfg, v = c.cfg, c.cfg.vocab
    shape = c.batch["sparse"].shape
    rng = np.random.default_rng(11)
    idx = rng.integers(-v - 5, v + 5, size=shape).astype(np.int32)
    idx.flat[:4] = [-v - 5, -1, v, v + 4]
    ref_lookup, ref_logits = jax.jit(lambda p, d, i: (
        RD._lookup(cfg, p["tables"], i),
        RD.dlrm_forward(cfg, p, d, i)))(c.params, c.batch["dense"],
                                         jnp.asarray(idx))
    tidx = torch.from_numpy(idx)
    got = TD._lookup(c.tcfg, c.model["tables"], tidx)
    if multi_hot == 1:
        assert np.array_equal(_np(got), _np(ref_lookup))
    else:
        np.testing.assert_allclose(_np(got), _np(ref_lookup), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(
        _np(c.model(c.tbatch["dense"], tidx)), _np(ref_logits), **TOL)


def test_dlrm_interaction_order_matches_reference():
    """The strict lower triangle in row-major order, as
    ``jnp.tril_indices(f, k=-1)``; ``_interact`` on the same inputs as the
    reference's; 415 features at ``full()``."""
    for f in (5, 27):
        iu, ju = torch.tril_indices(f, f, offset=-1)
        riu, rju = jnp.tril_indices(f, k=-1)
        assert np.array_equal(iu.numpy(), np.asarray(riu))
        assert np.array_equal(ju.numpy(), np.asarray(rju))
    cfg, tcfg = _cfgs("full")
    assert tcfg.d_interact == cfg.d_interact == 415
    assert tcfg.n_feats == cfg.n_feats == 27
    rng = np.random.default_rng(5)
    bot = rng.normal(size=(8, 64)).astype(np.float32)
    emb = rng.normal(size=(8, 26, 64)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, e: RD._interact(cfg, a, e))(
        bot, emb))
    got = TD._interact(tcfg, torch.from_numpy(bot), torch.from_numpy(emb))
    assert got.shape == want.shape == (8, 415)
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)


def test_dlrm_configs_equal_reference():
    ref, port = RC.get("dlrm-rm2"), TC.get("dlrm-rm2")
    assert (port.arch_id, port.family, port.kind, port.shapes) == \
        (ref.arch_id, ref.family, ref.kind, ref.shapes)
    for size in SIZES:
        r, p = getattr(ref, size)(), getattr(port, size)()
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
        assert p.param_count() == r.param_count()
        assert (p.n_feats, p.d_interact) == (r.n_feats, r.d_interact)
    assert [(f.name, f.default) for f in dataclasses.fields(TD.DLRMConfig)] \
        == [(f.name, f.default) for f in dataclasses.fields(RD.DLRMConfig)]
    assert port.full().param_count() == 26 * 4_000_000 * 64 + 13 * 512 \
        + 512 * 256 + 256 * 64 + 415 * 512 + 512 * 512 + 512 * 256 + 256


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dlrm_load_reference_params_round_trips(cases, dtype):
    c = cases("smoke", 1, dtype)
    want = dict(_paths(c.tree))
    got = dict(_paths(c.model.tree()))
    assert sorted(got, key=str) == sorted(want, key=str)
    for path, w in want.items():
        g = got[path]
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name, path
        assert np.array_equal(_bits(g.view(torch.int16).numpy()
                                    if g.dtype == torch.bfloat16
                                    else g.numpy()), _bits(w)), path
    assert all(p.device.type == "cpu" and not p.requires_grad
               for p in c.model.parameters())


@pytest.mark.parametrize("size", SIZES)
def test_dlrm_init_draws_reference_shapes(cases, size):
    """The port's own init: the reference's shapes and dtypes, the tables
    N(0, 1)/√D, the MLPs' biases zero; bfloat16 tables are the float32
    draw cast (the same generator seed)."""
    c = cases(size)
    m = TD.dlrm_init(c.tcfg, torch.Generator().manual_seed(1), device="cpu")
    shapes = {p: (tuple(t.shape), str(t.dtype)) for p, t in
              _paths(m.tree())}
    assert shapes == {p: (w.shape, f"torch.{w.dtype.name}")
                      for p, w in _paths(c.tree)}
    tables = m["tables"]
    assert abs(float(tables.std()) * np.sqrt(c.cfg.embed_dim) - 1) < 0.05
    assert all(not bool(lyr["b"].any()) for lyr in m["bot"])
    bf_cfg = dataclasses.replace(c.tcfg, dtype="bfloat16")
    bf = TD.dlrm_init(bf_cfg, torch.Generator().manual_seed(1),
                      device="cpu")
    assert bf["tables"].dtype == torch.bfloat16
    assert torch.equal(bf["tables"], tables.to(torch.bfloat16))
    for a, b in zip(_paths(bf.tree()), _paths(m.tree())):
        if a[0][0] != "tables":
            assert torch.equal(a[1], b[1]), a[0]


def test_dlrm_cast_keeps_or_shares_tables(cases):
    """``cast("float64", tables=False)`` runs float64 MLPs over the same
    (shared) float32 tables: the float32 forward's function in float64;
    ``cast`` of every leaf moves the tables' dtype with the config's."""
    c = cases("smoke", 3)
    m64 = c.model.cast("float64", tables=False)
    assert m64["tables"].data_ptr() == c.model["tables"].data_ptr()
    assert m64.cfg == c.model.cfg
    assert m64["top"][0]["w"].dtype == torch.float64
    b = c.tbatch
    got = m64(b["dense"], b["sparse"])
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), _np(c.logits), **TOL)
    bf = c.model.cast("bfloat16")
    assert bf.cfg.dtype == "bfloat16" and bf["tables"].dtype == \
        torch.bfloat16
    assert bf.to_device("cpu").device.type == "cpu"


def test_dlrm_device_rule_without_a_card(monkeypatch):
    """``device=None`` is the card: without one the init and the loader
    raise ``RuntimeError``; ``device="cpu"`` runs here."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TC.get("dlrm-rm2").smoke()
    tree = jax.tree.map(np.asarray, jax.jit(
        lambda k: RD.dlrm_init(RC.get("dlrm-rm2").smoke(), k))(KEY))
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: TD.dlrm_init(cfg, gen),
                 lambda: TD.load_reference_params(cfg, tree)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    model = TD.dlrm_init(cfg, gen, device="cpu")
    assert model.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.to_device(None)
    with pytest.raises(TypeError):
        TD.DLRM(RC.get("gat-cora").smoke(), {})


@pytest.mark.parametrize("multi_hot", MULTI_HOT)
def test_embedding_bag_matches_dlrm_lookup(cases, multi_hot):
    """The port's bag (its plain version here) on each table with the
    field's ids against the model's lookup: K = 1 bitwise, K = 3 within
    3·2^-24·Σ|rows| (two orders of three float32 adds); the reference's
    own test of its kernel against the model's gather, on the model's
    tables."""
    from repro_torch.kernels import embedding_bag as TEB
    c = cases("full", multi_hot)
    tables, idx = c.model["tables"], c.tbatch["sparse"]
    want = TD._lookup(c.tcfg, tables, idx)
    for f in range(c.tcfg.n_sparse):
        ids = idx[:, f, :] if multi_hot > 1 else idx[:, f:f + 1]
        got = TEB.embedding_bag(tables[f], ids)
        if multi_hot == 1:
            assert torch.equal(got, want[:, f]), f
        else:
            rows = tables[f][ids.long()].abs().sum(dim=1)
            assert bool(((got - want[:, f]).abs()
                         <= multi_hot * 2.0 ** -24 * rows).all()), f
