"""The port's LM serving path against the JAX package's, on the CPU.

``repro_torch.models`` (layers, transformer), ``repro_torch.configs`` and
``repro_torch.launch.serve`` held against ``repro.models``,
``repro.configs`` and ``repro.launch.serve``'s loop.  For each of the five
LM smoke configs the port loads the reference's own parameters
(``init_params(cfg, PRNGKey(0))``, through numpy) and takes tokens made
from a numpy seed; in float32 its forward logits and aux, prefill logits
and written cache and decode after prefill are held allclose (rtol = atol
= 1e-4, two float32 summation orders over two or three layers), the loss
value within rtol 1e-5, and ``serve.generate``'s greedy ids equal to a
reference prefill/decode loop.  Beside them: the attention modes (naive,
chunked, the scan and unroll bodies) over several KV tiles with local
chunks, MLA's absorbed and expanded decodes, the MoE routing (top, rank,
keep equal, then the outputs), the int8 cache's codes, the configs and
the registry, the parameter counts, the weights' round trip, and the
device and cache-bound rules.  The reference's outputs are computed once
per arch per module (its jitted functions, cached in a fixture).
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import layers as RL
from repro.models import transformer as RT
import repro_torch.configs as TC
from repro_torch.launch import serve as TSV
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

LM_ARCHS = ["llama3.2-3b", "qwen2-72b", "yi-9b", "deepseek-v3-671b",
            "llama4-maverick-400b-a17b"]
# the per-arch parity tests of the dense GQA archs run here, those of the
# MoE archs in test_torch_models_moe.py (a file each keeps either well
# inside a minute)
DENSE_ARCHS = LM_ARCHS[:3]
# registered beside the LMs since the GNN slice (tests/test_torch_gnn.py)
GNN_ARCHS = ["dimenet", "meshgraphnet", "egnn", "gat-cora"]
KEY = jax.random.PRNGKey(0)
B, S, MAX_SEQ, STEPS = 2, 16, 32, 8
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _long(a):
    return torch.from_numpy(np.asarray(a)).long()


class _Arch:
    """One arch's reference parameters, its port model and the reference
    outputs, each computed on first use."""

    def __init__(self, arch):
        self.cfg = RC.get(arch).smoke()
        self.tcfg = TC.get(arch).smoke()
        self.params = jax.jit(lambda k: RT.init_params(self.cfg, k))(KEY)
        self.tree = jax.tree.map(np.asarray, self.params)
        self.model = TT.load_reference_params(self.tcfg, self.tree,
                                              device="cpu")
        rng = np.random.default_rng(7)
        self.toks = rng.integers(0, self.cfg.vocab, (B, S + 1)).astype(
            np.int32)
        self._out = {}

    def ref(self, name, cfg_changes=()):
        """The reference's output ``name`` under ``cfg`` with changes."""
        key = (name, tuple(cfg_changes))
        if key not in self._out:
            cfg = dataclasses.replace(self.cfg, **dict(cfg_changes))
            self._out[key] = jax.tree.map(
                np.asarray, _REF_RUNS[name](self, cfg))
        return self._out[key]


def _batch(toks):
    return {"tokens": toks[:, :S], "targets": np.roll(toks[:, :S], -1, 1)}


def _ref_forward(a, cfg):
    """Forward logits and aux of the first S tokens, and the loss value
    with their next tokens as targets (one jitted call)."""
    def run(p, b):
        logits, aux, _ = RT.forward(cfg, p, b["tokens"])
        return {"logits": logits, "aux": aux, "loss": RT.loss_fn(cfg, p, b)}
    return jax.jit(run)(a.params, jax.tree.map(jnp.asarray, _batch(a.toks)))


def _ref_serve(a, cfg):
    """Prefill of S tokens, one decode step of the next, and the greedy
    loop of ``repro.launch.serve`` (STEPS tokens, a pow2 cache)."""
    prefill = jax.jit(lambda p, t, c: RT.prefill(cfg, p, t, c))
    decode = jax.jit(lambda p, tk, pos, c: RT.decode_step(cfg, p, tk, pos,
                                                          c))
    toks = jnp.asarray(a.toks)
    lg, cache = prefill(a.params, toks[:, :S], RT.init_cache(cfg, B,
                                                             MAX_SEQ))
    lg2, cache2 = decode(a.params, toks[:, S], jnp.int32(S), cache)
    max_seq = 1 << (S + STEPS - 1).bit_length()
    logits, c = prefill(a.params, toks[:, :S], RT.init_cache(cfg, B,
                                                             max_seq))
    tok = jnp.argmax(logits, axis=-1)
    ids = [tok]
    for i in range(STEPS - 1):
        logits, c = decode(a.params, tok, jnp.int32(S + i), c)
        tok = jnp.argmax(logits, axis=-1)
        ids.append(tok)
    return {"prefill": lg, "cache": cache, "decode": lg2, "cache2": cache2,
            "ids": jnp.stack(ids, axis=1)}


_REF_RUNS = {"forward": _ref_forward, "serve": _ref_serve}


@pytest.fixture(scope="module")
def arch_data():
    built = {}

    def get(arch):
        if arch not in built:
            built[arch] = _Arch(arch)
        return built[arch]
    return get


def _port_serve(model, toks):
    cache = model.init_cache(B, MAX_SEQ)
    lg, cache = model.prefill(_long(toks[:, :S]), cache)
    written = {k: v.clone() for k, v in cache.items()}
    lg2, cache = model.decode_step(_long(toks[:, S]), S, cache)
    return {"prefill": lg, "cache": written, "decode": lg2, "cache2": cache}


# ---------------------------------------------------------------------------
# Configs, registry, counts and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_configs_equal_reference(arch):
    for size in ("full", "smoke"):
        ref = getattr(RC.get(arch), size)()
        port = getattr(TC.get(arch), size)()
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), size
        assert type(port).__name__ == type(ref).__name__


@pytest.mark.parametrize("cls", ["LMConfig", "MoECfg", "MLACfg"])
def test_config_fields_and_defaults_equal_reference(cls):
    ref = [(f.name, f.default) for f in dataclasses.fields(getattr(RL, cls))]
    port = [(f.name, f.default)
            for f in dataclasses.fields(getattr(TL, cls))]
    assert port == ref


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_counts_equal_reference(arch):
    for size in ("full", "smoke"):
        ref = getattr(RC.get(arch), size)()
        port = getattr(TC.get(arch), size)()
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        assert port.head_dim == ref.head_dim
        assert [TT._layer_pattern(port, li) for li in range(port.n_layers)] \
            == [(ref.moe is not None and ref.moe.is_moe_layer(li),
                 RT._is_global_layer(ref, li)) for li in range(ref.n_layers)]


def test_registry_matches_reference():
    assert TC.LM_SHAPES == RC.LM_SHAPES
    assert TC.GNN_SHAPES == RC.GNN_SHAPES
    assert TC.RECSYS_SHAPES == RC.RECSYS_SHAPES
    assert TC.SHAPES_BY_FAMILY == RC.SHAPES_BY_FAMILY
    assert TC.ASSIGNED == [a for a in RC.ASSIGNED if a != "dlrm-rm2"]
    assert TC.ASSIGNED == LM_ARCHS + GNN_ARCHS
    assert sorted(TC.ARCHS) == sorted(LM_ARCHS + GNN_ARCHS
                                      + ["grafs-analytics"])
    for arch_id, entry in TC.ARCHS.items():
        ref = RC.get(arch_id)
        assert (entry.arch_id, entry.family, entry.kind) == \
            (ref.arch_id, ref.family, ref.kind)
        assert entry.shapes == ref.shapes
    assert dataclasses.asdict(TC.get("grafs-analytics").full()) == \
        dataclasses.asdict(RC.get("grafs-analytics").full())


@pytest.mark.parametrize("arch_id", GNN_ARCHS + ["dlrm-rm2"])
def test_unregistered_archs_raise_the_reference_message(arch_id):
    """The GNNs are registered since their slice of the port, as the
    reference's entries (family, kind, ``full()``, ``smoke()``); the one
    arch still to come, dlrm-rm2, raises the reference's ``KeyError``."""
    ref = RC.get(arch_id)                         # the reference has it
    if arch_id in GNN_ARCHS:
        entry = TC.get(arch_id)
        assert (entry.arch_id, entry.family, entry.kind) == \
            (ref.arch_id, ref.family, ref.kind)
        for size in ("full", "smoke"):
            assert dataclasses.asdict(getattr(entry, size)()) == \
                dataclasses.asdict(getattr(ref, size)())
        assert arch_id in TC.ASSIGNED
        return
    assert arch_id not in TC.ASSIGNED
    with pytest.raises(KeyError) as err:
        TC.get(arch_id)
    assert err.value.args[0] == (f"unknown arch {arch_id!r}; known: "
                                 f"{sorted(TC.ARCHS)}")
    with pytest.raises(KeyError) as ref_err:
        RC.get("no-such-arch")
    assert re.fullmatch(r"unknown arch 'no-such-arch'; known: \[.*\]",
                        ref_err.value.args[0])


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_skip_reason_equals_reference(arch):
    for shape in RC.LM_SHAPES:
        assert TC.skip_reason(arch, shape) == RC.skip_reason(arch, shape)


def _attn_count(cfg):
    d = cfg.d_model
    if cfg.mla is not None:
        m = cfg.mla
        return (d * m.q_lora_rank
                + m.q_lora_rank * cfg.n_heads
                * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * cfg.n_heads
                * (m.qk_nope_head_dim + m.v_head_dim)
                + cfg.n_heads * m.v_head_dim * d)
    hd = cfg.head_dim
    return 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_port_holds_param_count_plus_norms_biases_and_mtp(arch, size):
    """One FFN set per layer: the port's parameters are ``param_count()``
    (which counts only the set each layer runs) plus the two norms per
    layer and the final one, the QKV biases and the MTP head (its
    projection, one dense layer and its norms).  Full widths on meta."""
    cfg = getattr(TC.get(arch), size)()
    model = TT.init_params(cfg, None, device="meta")
    d, l = cfg.d_model, cfg.n_layers
    want = cfg.param_count() + 2 * l * d + d
    if cfg.qkv_bias:
        want += l * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
    if cfg.mtp:
        want += 2 * d * d + _attn_count(cfg) + 3 * d * cfg.d_ff + 2 * d
    assert sum(p.numel() for p in model.parameters()) == want
    assert all(p.device.type == "meta" for p in model.parameters())


def _port_leaf(model, path, li):
    """The port's tensor at the reference tree's ``path`` (layer ``li``
    of a stacked layer leaf)."""
    node = model
    if path[0] == "layers":
        node, path = model.layers[li], path[1:]
    for name in path:
        node = node[name] if not isinstance(node, TT.TransformerLM) \
            else getattr(node, name)
    return node


def _ref_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _ref_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def check_round_trip(a):
    cfg, model = a.tcfg, a.model
    seen = 0
    for path, leaf in _ref_leaves(a.tree):
        if path[0] == "layers":
            for li in range(cfg.n_layers):
                use_moe = TT._layer_pattern(cfg, li)[0]
                dropped = "ffn" if use_moe else "moe"
                if path[1] == dropped:
                    assert dropped not in model.layers[li]
                    continue
                got = _port_leaf(model, path, li)
                assert torch.equal(got,
                                   torch.from_numpy(np.array(leaf[li])))
                seen += got.numel()
        elif path[:3] == ("mtp", "layer", "moe"):
            assert "moe" not in model.mtp["layer"]
        else:
            got = _port_leaf(model, path, None)
            assert torch.equal(got, torch.from_numpy(np.array(leaf)))
            seen += got.numel()
    assert seen == sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_load_reference_params_round_trips_every_leaf(arch, arch_data):
    check_round_trip(arch_data(arch))


def test_load_reference_params_takes_bfloat16_leaves():
    cfg = dataclasses.replace(RC.get("yi-9b").smoke(), dtype="bfloat16",
                              param_dtype="bfloat16")
    tcfg = dataclasses.replace(TC.get("yi-9b").smoke(), dtype="bfloat16",
                               param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray,
                        jax.jit(lambda k: RT.init_params(cfg, k))(KEY))
    model = TT.load_reference_params(tcfg, tree, device="cpu")
    wq = model.layers[1].attn["wq"]
    assert wq.dtype == torch.bfloat16
    ref = tree["layers"]["attn"]["wq"][1].astype(np.float32)
    assert torch.equal(wq.float(), torch.from_numpy(ref))


def test_cast_keeps_the_weights_and_float32_routers():
    cfg = TC.get("deepseek-v3-671b").smoke()
    model = TT.init_params(cfg, torch.Generator().manual_seed(4),
                           device="cpu")
    half = model.cast("bfloat16")
    assert (half.cfg.dtype, half.cfg.param_dtype) == ("bfloat16",
                                                      "bfloat16")
    router = half.layers[1]["moe"]["router"]
    assert router.dtype == torch.float32
    assert router.data_ptr() == model.layers[1]["moe"]["router"].data_ptr()
    names = dict(model.named_parameters())
    for name, p in half.named_parameters():
        if not name.endswith("router"):
            assert p.dtype == torch.bfloat16
            assert torch.equal(p, names[name].to(torch.bfloat16))
    back = half.cast("float32")
    assert sorted(n for n, _ in back.named_parameters()) == sorted(names)
    logits, _, _ = half(torch.zeros((1, 4), dtype=torch.long))
    assert logits.dtype == torch.bfloat16 and bool(logits.isfinite().all())


# ---------------------------------------------------------------------------
# Forward, loss, prefill, decode, generate
# ---------------------------------------------------------------------------

def check_forward(a):
    want = a.ref("forward")
    logits, aux = want["logits"], want["aux"]
    got, got_aux, x = a.model(_long(a.toks[:, :S]))
    assert got.shape == (B, S, a.cfg.vocab) and x.shape == (B, S,
                                                             a.cfg.d_model)
    _close(got, logits)
    _close(got_aux, aux, rtol=1e-5, atol=1e-7)
    if a.cfg.moe is not None:
        assert float(got_aux) > 0


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_matches_reference(arch, arch_data):
    check_forward(arch_data(arch))


def check_loss(a):
    want = a.ref("forward")["loss"]
    got = a.model.loss_fn({k: _long(v) for k, v in _batch(a.toks).items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_loss_matches_reference(arch, arch_data):
    check_loss(arch_data(arch))


def check_prefill(a):
    """Prefill logits and every cache tensor it writes."""
    want = a.ref("serve")
    got = _port_serve(a.model, a.toks)
    _close(got["prefill"], want["prefill"])
    assert sorted(got["cache"]) == sorted(want["cache"])
    for k, v in got["cache"].items():
        assert v.dtype == torch.float32 and v.shape == want["cache"][k].shape
        _close(v, want["cache"][k])
    # positions >= S stay zero, as the reference leaves them
    for v in got["cache"].values():
        assert not v[:, :, S:].any()


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_matches_reference(arch, arch_data):
    check_prefill(arch_data(arch))


def check_decode(a):
    want = a.ref("serve")
    got = _port_serve(a.model, a.toks)
    _close(got["decode"], want["decode"])
    for k, v in got["cache2"].items():
        _close(v, want["cache2"][k])


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_decode_after_prefill_matches_reference(arch, arch_data):
    check_decode(arch_data(arch))


def check_generate(a):
    """``serve.generate``'s greedy ids equal a reference prefill/decode
    loop over the same weights and prompts."""
    want = a.ref("serve")["ids"]
    max_seq = 1 << (S + STEPS - 1).bit_length()
    res = TSV.generate(a.model, _long(a.toks[:, :S]), STEPS,
                       a.model.init_cache(B, max_seq))
    assert res.ids.shape == (B, STEPS)
    np.testing.assert_array_equal(_np(res.ids), want)
    _close(res.prefill_logits, a.ref("serve")["prefill"])


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_generate_matches_reference_loop(arch, arch_data):
    check_generate(arch_data(arch))


def _ref_moe(cfg, moe, x):
    """The routing lines of the reference's ``moe_ffn`` (gate, top, rank,
    keep), then its output and aux, in one jitted call; and the cap."""
    mo = cfg.moe
    t = x.shape[0] * x.shape[1]
    gcount = max(1, min(cfg.moe_groups, t))
    while t % gcount:
        gcount -= 1
    tg = t // gcount
    cap = int(max(1, np.ceil(tg * mo.top_k / mo.n_experts
                             * mo.capacity_factor)))

    def run(moe, x):
        xt = x.reshape(t, cfg.d_model)
        probs = jax.nn.softmax(xt.astype(jnp.float32) @ moe["router"],
                               axis=-1)
        gate, top = jax.lax.top_k(probs, mo.top_k)
        gate = gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9)
        rank = jax.vmap(lambda tf: RL._moe_rank_in_expert(
            tf, mo.n_experts))(top.reshape(gcount, tg * mo.top_k))
        return (gate, top, rank, rank < cap) + RL.moe_ffn(cfg, moe, x)

    return jax.tree.map(np.asarray, jax.jit(run)(moe, jnp.asarray(x))), cap


def check_moe_routing(a, groups):
    """The routing (top, rank, keep, cap, gate) of the arch's first MoE
    layer on seeded inputs in ``groups`` groups, then its output and aux."""
    cfg = dataclasses.replace(a.cfg, moe_groups=groups)
    tcfg = dataclasses.replace(a.tcfg, moe_groups=groups)
    li = next(i for i in range(cfg.n_layers) if cfg.moe.is_moe_layer(i))
    moe = jax.tree.map(lambda x: x[li], a.params["layers"]["moe"])
    port = a.model.layers[li]["moe"]
    x = np.random.default_rng(11).normal(size=(B, S, cfg.d_model)).astype(
        np.float32)
    (gate, top, rank, keep, y, aux), cap = _ref_moe(cfg, moe, x)
    r = TL.moe_route(tcfg, port["router"], torch.from_numpy(x).reshape(
        -1, cfg.d_model))
    np.testing.assert_array_equal(_np(r.top), top)
    np.testing.assert_array_equal(_np(r.rank), rank)
    np.testing.assert_array_equal(_np(r.keep), keep)
    assert r.cap == cap
    _close(r.gate, gate, rtol=1e-6, atol=1e-7)
    assert not keep.all()                  # the cap drops assignments
    got_y, got_aux = TL.moe_ffn(tcfg, port, torch.from_numpy(x))
    _close(got_y, y)
    _close(got_aux, aux, rtol=1e-5, atol=1e-8)


# ---------------------------------------------------------------------------
# Attention modes in the port, the int8 cache
# ---------------------------------------------------------------------------

def test_attention_modes_agree_in_the_port(arch_data):
    a = arch_data("llama3.2-3b")
    toks = _long(a.toks[:, :S])
    base, _, _ = a.model(toks)
    for changes in ({"attn_impl": "naive"}, {"loop_impl": "unroll"},
                    {"attn_impl": "scan", "kv_chunk": 4},
                    {"kv_chunk": 2}):
        got, _, _ = a.model.with_config(**changes)(toks)
        _close(got, base)



@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_float64_model_decodes_as_its_forward(arch, arch_data):
    """A model cast to float64 keeps float64 through its norms, attention
    and softmax (where a float32 one runs float32), so its greedy decode
    equals its forward over the prompt and the ids fed back to float64
    rounding (the check a chaotic random LM at full depth needs)."""
    a = arch_data(arch)
    model = a.model.cast("float64")
    prompts = _long(a.toks[:, :S])
    res = TSV.generate(model, prompts, STEPS, model.init_cache(B, MAX_SEQ))
    assert res.logits.dtype == torch.float64
    full, _, _ = model(torch.cat([prompts, res.ids[:, :-1]], dim=1))
    _close(res.logits, full[:, -1], rtol=1e-12, atol=1e-12)
    _close(res.prefill_logits, full[:, S - 1], rtol=1e-12, atol=1e-12)


_QUANTIZE = TL._quantize_int8


class _ReferenceCodes:
    """Stands in for the port's int8 quantizer (``layers._quantize_int8``):
    holds each call's codes against the reference's cache ``ref`` at the
    same layer (calls come k, v per layer, in layer order) and cache
    positions ``pos``, then hands the reference's codes and scales on, so
    every later product of the port reads the reference's cache.  A code
    may be one apart only where the port's float32 quotient q = x / scale
    lies within 1e-5 of a half-integer; ``apart`` counts them."""

    def __init__(self, ref, pos):
        self.ref, self.pos = ref, pos
        self.calls = self.apart = 0

    def __call__(self, x):
        codes, scale = _QUANTIZE(x)
        layer, kv = divmod(self.calls, 2)
        name = "kv"[kv]
        self.calls += 1
        want = torch.from_numpy(np.array(self.ref[name][layer][:, self.pos]))
        want_s = torch.from_numpy(np.array(
            self.ref[name + "_s"][layer][:, self.pos]))
        diff = _np((codes.int() - want.int()).abs())
        assert diff.max() <= 1
        q = _np(x / scale[..., None])
        near_half = np.abs(np.abs(q - np.floor(q)) - 0.5) <= 1e-5
        assert np.all(near_half[diff == 1]), (name, layer)
        self.apart += int((diff == 1).sum())
        _close(scale, want_s, rtol=1e-5, atol=1e-9)
        return want, want_s.to(scale.dtype)



@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-72b"])
def test_int8_cache_matches_reference(arch, arch_data, monkeypatch,
                                      record_property):
    """int8 codes equal, or one apart only where the float32 quotient lies
    within 1e-5 of a half-integer (``jnp.round`` and ``torch.round`` both
    round half to even; the count of such codes is recorded), scales
    allclose, at every layer of the prefill and of one decode step.  Each
    layer then runs on the reference's codes and scales, so a code one
    apart does not carry into the next layer's quotients: the prefill and
    decode logits are held to the reference's at the float32 tolerance,
    and the caches the port wrote equal the reference's."""
    a = arch_data(arch)
    changes = (("kv_quant", True),)
    model = a.model.with_config(kv_quant=True)
    want = a.ref("serve", changes)
    layers = a.cfg.n_layers
    codes = _ReferenceCodes(want["cache"], slice(0, S))
    monkeypatch.setattr(TL, "_quantize_int8", codes)
    cache = model.init_cache(B, MAX_SEQ)
    assert cache["k"].dtype == torch.int8
    lg, cache = model.prefill(_long(a.toks[:, :S]), cache)
    assert codes.calls == 2 * layers
    _close(lg, want["prefill"])
    for name in cache:
        np.testing.assert_array_equal(_np(cache[name]), want["cache"][name])
    step = _ReferenceCodes(want["cache2"], slice(S, S + 1))
    monkeypatch.setattr(TL, "_quantize_int8", step)
    lg, cache = model.decode_step(_long(a.toks[:, S]), S, cache)
    assert step.calls == 2 * layers
    _close(lg, want["decode"])
    for name in cache:
        np.testing.assert_array_equal(_np(cache[name]), want["cache2"][name])
    record_property("int8_codes_one_apart", codes.apart + step.apart)


# ---------------------------------------------------------------------------
# Device and cache rules, the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn", ["gqa", "int8", "mla"])
def test_cache_write_past_the_end_raises(attn):
    arch = "deepseek-v3-671b" if attn == "mla" else "llama3.2-3b"
    cfg = TC.get(arch).smoke()
    if attn == "int8":
        cfg = dataclasses.replace(cfg, kv_quant=True)
    model = TT.init_params(cfg, torch.Generator().manual_seed(3),
                           device="cpu")
    toks = torch.zeros((B, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="outside a cache of 4"):
        model.prefill(toks, model.init_cache(B, 4))
    cache = model.init_cache(B, 8)
    model.prefill(toks, cache)                       # fills all 8
    with pytest.raises(ValueError, match="at offset 8 outside"):
        model.decode_step(toks[:, 0], 8, cache)
    model.decode_step(toks[:, 0], 7, cache)          # the last slot


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-v3-671b"])
def test_layer_cache_offset_defaults_to_the_first_position(arch):
    """Called as the reference calls it (no ``offset``), an attention
    layer writes its cache at positions[0, 0], as
    ``dynamic_update_slice_in_dim`` does; the model passes the offset."""
    cfg = TC.get(arch).smoke()
    model = TT.init_params(cfg, torch.Generator().manual_seed(8),
                           device="cpu")
    attend = TL.mla_attention if cfg.mla is not None else TL.gqa_attention
    p = model.layers[0]["attn"]
    x = torch.randn((B, 1, cfg.d_model), generator=torch.Generator()
                    .manual_seed(9))
    pos = torch.full((B, 1), 5)
    caches = [{k: v[0] for k, v in model.init_cache(B, 8).items()}
              for _ in range(2)]
    out, _ = attend(cfg, p, x, pos, None, caches[0])
    want, _ = attend(cfg, p, x, pos, None, caches[1], offset=5)
    assert torch.equal(out, want)
    for k in caches[0]:
        assert torch.equal(caches[0][k], caches[1][k])
        assert caches[0][k][:, 5].any() and not caches[0][k][:, :5].any()


@pytest.mark.parametrize("entry", ["init_params", "load_reference_params",
                                   "serve"])
def test_device_none_without_a_card_raises(entry, monkeypatch, arch_data):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TC.get("llama3.2-3b").smoke()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "init_params":
            TT.init_params(cfg, torch.Generator().manual_seed(0))
        elif entry == "load_reference_params":
            TT.load_reference_params(cfg, arch_data("llama3.2-3b").tree)
        else:
            TSV.main(["--smoke"])


def test_serve_main_on_the_cpu(capsys):
    assert TSV.main(["--smoke", "--device", "cpu", "--arch", "yi-9b",
                     "--batch", "3", "--prompt-len", "5",
                     "--decode-steps", "4"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2
    assert re.fullmatch(r"\[serve\] arch=yi-9b batch=3 prompt=5 decoded=4 "
                        r"tokens/s=[0-9.]+", out[0])
    ids = re.fullmatch(r"sampled token ids: \[(.*)\]", out[1]).group(1)
    assert len(ids.split(",")) == 4


def test_serve_main_refuses_the_analytics_arch():
    with pytest.raises(SystemExit):
        TSV.main(["--smoke", "--device", "cpu", "--arch",
                  "grafs-analytics"])
