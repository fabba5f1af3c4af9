"""The serving kinds of the port's ``build_workload`` against the JAX
package's, on the CPU at ``smoke()``.

For each cell the port's ``step_fn`` runs on the reference's own
parameters (``init_params`` / ``dlrm_init`` at ``PRNGKey(0)``, through
numpy and ``load_reference_params``) and on inputs made from a numpy
seed, beside the reference's ``step_fn`` jitted on a 1 × 1 CPU mesh:

- LM prefill: ``(params, tokens, cache) → (logits, cache)`` from a zero
  cache; LM decode: ``(params, token, pos, cache) → (logits, cache)`` at
  ``pos`` 40 of a 64-slot cache filled from the seed (``pos`` an int, and
  a 0-dim tensor).  Logits and the written cache within ``TOL`` (rtol =
  atol = 1e-4, as ``test_torch_models``); an int8 cache's codes within
  one quantization step, its scales within rtol 1e-5;
- DLRM ``serve`` ``(params, dense, sparse) → scores`` and ``retrieval``
  ``(params, dense, sparse, cand) → scores`` within rtol 1e-5 and atol
  1e-6 (two float32 summation orders part by a few 1e-8 at |x| ≈ 0.2);
- the abstract arguments' shapes and dtypes equal the reference's (an
  LM's per-layer leaves each the reference's stacked leaf less its layer
  axis), and ``meta`` equals the reference's, key for key.

The cells: llama3.2-3B ``prefill_32k``, its ``decode_32k`` baseline and
``kvq``, qwen2-72b ``decode_32k`` ``kvq``, deepseek-v3 ``decode_32k``
(MLA, MoE), llama4-maverick ``decode_32k`` (iRoPE, MoE), and RM2
``serve_p99`` and ``retrieval_cand``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.data import graphs as RDG
from repro.launch import workloads as RW
from repro.models import dlrm as RD
from repro.models import transformer as RT
from repro_torch.launch import workloads as TW
from repro_torch.models import dlrm as TD
from repro_torch.models import transformer as TT
from repro_torch.tree import leaves

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-4, atol=1e-4)
POS = 40                        # the decode position in the 64-slot cache


def _host_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _sig(x):
    """(shape, dtype name) of a torch tensor or a JAX abstract value."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), str(x.dtype).removeprefix("torch.")
    return tuple(x.shape), np.dtype(x.dtype).name


def _tree_sig(tree):
    if isinstance(tree, dict):
        return {k: _tree_sig(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_sig(v) for v in tree]
    return _sig(tree)


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _check_lm_params_abs(port, ref):
    """Every port leaf's shape and dtype: a top-level leaf the reference's,
    a layer's the reference's stacked leaf less the layer axis."""
    for name in ("embed", "ln_f", "unembed"):
        assert _sig(port[name]) == _sig(ref[name])
    for lp in port["layers"]:
        for path, leaf in _walk(lp):
            shape, dt = _sig(_at(ref["layers"], path))
            assert _sig(leaf) == (shape[1:], dt), path


def _ref_workload(arch, shape, variant):
    return RW.build_workload(arch, shape, _host_mesh(), smoke=True,
                             variant=variant)


def _ref_step(wl, *args):
    with _host_mesh():
        return jax.jit(wl.step_fn)(*args)


def _check_meta(port_wl, ref_wl):
    assert port_wl.kind == ref_wl.kind
    assert {k: v for k, v in port_wl.meta.items() if k != "cuts"} == \
        ref_wl.meta
    assert port_wl.grad_fn is None and port_wl.opt_cfg is None


# ---------------------------------------------------------------------------
# LM prefill and decode
# ---------------------------------------------------------------------------

def _lm_params(arch):
    cfg = RC.get(arch).smoke()
    params = jax.jit(lambda k: RT.init_params(cfg, k))(KEY)
    return params, jax.tree.map(np.asarray, params)


def _seeded_cache(cache_abs, seed):
    """A cache of the reference's layout filled from a numpy seed: float
    leaves N(0, 1), int8 codes uniform in [-127, 127], scales |N(0, 1)|
    / 127 + 1e-3 (the ``_s`` leaves)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, a in cache_abs.items():
        if np.dtype(a.dtype) == np.int8:
            out[name] = rng.integers(-127, 128, a.shape).astype(np.int8)
        elif name.endswith("_s"):
            out[name] = (np.abs(rng.normal(size=a.shape)) / 127
                         + 1e-3).astype(np.float32)
        else:
            out[name] = rng.normal(size=a.shape).astype(
                np.dtype(a.dtype))
    return out


def _check_cache(got, want):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g, w = _np(got[name]), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if w.dtype == np.int8:
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() \
                <= 1, name
        elif name.endswith("_s"):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-9)
        else:
            np.testing.assert_allclose(g, w, **TOL)


def test_lm_prefill_step_matches_reference():
    arch, shape = "llama3.2-3b", "prefill_32k"
    params, tree = _lm_params(arch)
    ref_wl = _ref_workload(arch, shape, "baseline")
    wl = TW.build_workload(arch, shape, None, smoke=True)
    _check_meta(wl, ref_wl)
    assert wl.kind == "prefill"
    rp, rtoks, rcache = ref_wl.abstract_args
    pp, ptoks, pcache = wl.abstract_args
    _check_lm_params_abs(pp, rp)
    assert _sig(ptoks) == _sig(rtoks) == ((4, 64), "int32")
    assert _tree_sig(pcache) == _tree_sig(rcache)

    toks = np.random.default_rng(11).integers(
        0, wl.cfg.vocab, rtoks.shape).astype(np.int32)
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), rcache)
    want_logits, want_cache = _ref_step(ref_wl, params, jnp.asarray(toks),
                                        zeros)
    model_tree = TT.load_reference_params(wl.cfg, tree, device="cpu").tree()
    cache = {k: torch.from_numpy(v.copy()) for k, v in zeros.items()}
    logits, got_cache = wl.step_fn(model_tree, torch.from_numpy(toks),
                                   cache)
    assert got_cache is cache                       # written in place
    np.testing.assert_allclose(_np(logits), np.asarray(want_logits), **TOL)
    _check_cache(got_cache, want_cache)


DECODE_CELLS = [("llama3.2-3b", "baseline", "int"),
                ("llama3.2-3b", "kvq", "tensor"),
                ("qwen2-72b", "kvq", "int"),
                ("deepseek-v3-671b", "baseline", "tensor"),
                ("llama4-maverick-400b-a17b", "baseline", "int")]


@pytest.mark.parametrize("arch,variant,pos_as", DECODE_CELLS)
def test_lm_decode_step_matches_reference(arch, variant, pos_as):
    shape = "decode_32k"
    params, tree = _lm_params(arch)
    ref_wl = _ref_workload(arch, shape, variant)
    wl = TW.build_workload(arch, shape, None, smoke=True, variant=variant)
    _check_meta(wl, ref_wl)
    assert wl.kind == "decode"
    assert wl.cfg.kv_quant == (variant == "kvq")
    rp, rtok, rpos, rcache = ref_wl.abstract_args
    pp, ptok, ppos, pcache = wl.abstract_args
    _check_lm_params_abs(pp, rp)
    assert _sig(ptok) == _sig(rtok) == ((4,), "int32")
    assert _sig(ppos) == _sig(rpos) == ((), "int32")
    assert _tree_sig(pcache) == _tree_sig(rcache)
    assert all(t.device.type == "meta" for t in leaves(wl.abstract_args))

    cache_np = _seeded_cache(rcache, 12)
    tok = np.random.default_rng(13).integers(
        0, wl.cfg.vocab, rtok.shape).astype(np.int32)
    want_logits, want_cache = _ref_step(
        ref_wl, params, jnp.asarray(tok), jnp.int32(POS),
        {k: jnp.asarray(v) for k, v in cache_np.items()})
    model_tree = TT.load_reference_params(wl.cfg, tree, device="cpu").tree()
    cache = {k: torch.from_numpy(v.copy()) for k, v in cache_np.items()}
    pos = POS if pos_as == "int" else torch.tensor(POS, dtype=torch.int32)
    logits, got_cache = wl.step_fn(model_tree, torch.from_numpy(tok), pos,
                                   cache)
    assert got_cache is cache
    np.testing.assert_allclose(_np(logits), np.asarray(want_logits), **TOL)
    _check_cache(got_cache, want_cache)
    # only slot POS was written
    for name, v in cache_np.items():
        np.testing.assert_array_equal(_np(got_cache[name])[:, :, :POS],
                                      v[:, :, :POS])
        np.testing.assert_array_equal(_np(got_cache[name])[:, :, POS + 1:],
                                      v[:, :, POS + 1:])


# ---------------------------------------------------------------------------
# DLRM serve and retrieval
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["serve_p99", "retrieval_cand"])
def test_dlrm_serving_step_matches_reference(shape):
    arch = "dlrm-rm2"
    cfg = RC.get(arch).smoke()
    params = jax.jit(lambda k: RD.dlrm_init(cfg, k))(KEY)
    ref_wl = _ref_workload(arch, shape, "baseline")
    wl = TW.build_workload(arch, shape, None, smoke=True)
    _check_meta(wl, ref_wl)
    assert wl.kind == ("serve" if shape == "serve_p99" else "retrieval")
    assert _tree_sig(wl.abstract_args[0]) == _tree_sig(
        ref_wl.abstract_args[0])
    assert [_sig(a) for a in wl.abstract_args[1:]] == \
        [_sig(a) for a in ref_wl.abstract_args[1:]]

    b = RDG.dlrm_batch(cfg, wl.meta["batch"], seed=14)
    args = [np.array(b["dense"]), np.array(b["sparse"])]
    if shape == "retrieval_cand":
        assert wl.meta["n_candidates"] == 1024
        args.append(np.random.default_rng(15).normal(
            size=(1024, cfg.embed_dim)).astype(np.float32))
    want = _ref_step(ref_wl, params, *(jnp.asarray(a) for a in args))
    model_tree = TD.load_reference_params(
        wl.cfg, jax.tree.map(np.asarray, params), device="cpu").tree()
    got = wl.step_fn(model_tree, *(torch.from_numpy(a) for a in args))
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
