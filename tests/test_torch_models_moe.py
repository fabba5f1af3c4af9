"""deepseek-v3's smoke LM (MLA, MoE after a dense first layer, MTP)
against the JAX package's, on the CPU.

The per-arch parity checks of ``test_torch_models.py`` (forward, loss,
prefill, decode, ``serve.generate``, the weights' round trip), then what
only this arch has: MLA's absorbed and expanded decodes (and the naive
and unrolled expanded ones), and the MoE routing, top-8 of 8 experts with
one shared: top, rank and keep equal to the reference's, then the
outputs, at the tolerances stated there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models import layers as TL
from test_torch_models import (B, S, MAX_SEQ, _close, _long, _np,
                               _port_serve, _ref_moe, check_decode,
                               check_forward, check_generate, check_loss,
                               check_moe_routing, check_prefill,
                               check_round_trip)
from test_torch_models import arch_data  # noqa: F401 (a fixture)

ARCH = "deepseek-v3-671b"


def test_load_reference_params_round_trips_every_leaf(arch_data):
    check_round_trip(arch_data(ARCH))


def test_forward_matches_reference(arch_data):
    check_forward(arch_data(ARCH))


def test_loss_matches_reference(arch_data):
    check_loss(arch_data(ARCH))


def test_prefill_matches_reference(arch_data):
    check_prefill(arch_data(ARCH))


def test_decode_after_prefill_matches_reference(arch_data):
    check_decode(arch_data(ARCH))


def test_generate_matches_reference_loop(arch_data):
    check_generate(arch_data(ARCH))


@pytest.mark.parametrize("mode", [
    (("mla_decode", "absorbed"),),
    (("mla_decode", "expanded"),),
    (("mla_decode", "expanded"), ("attn_impl", "naive")),
    (("mla_decode", "expanded"), ("loop_impl", "unroll"), ("kv_chunk", 8))],
    ids=["absorbed", "expanded", "naive", "unroll"])
def test_mla_decodes_match_reference(mode, arch_data):
    a = arch_data(ARCH)
    model = a.model.with_config(**dict(mode))
    want = a.ref("serve", mode)
    got = _port_serve(model, a.toks)
    _close(got["prefill"], want["prefill"])
    _close(got["decode"], want["decode"])


def test_mla_absorbed_equals_expanded(arch_data):
    """The "auto" rule picks the absorbed decode at one query with a
    cache; the two decodes agree from one prefilled cache."""
    a = arch_data(ARCH)
    assert a.model.cfg.mla_decode == "auto"
    cache = a.model.init_cache(B, MAX_SEQ)
    a.model.prefill(_long(a.toks[:, :S]), cache)
    out = {}
    for mode in ("auto", "absorbed", "expanded"):
        c = {k: v.clone() for k, v in cache.items()}
        out[mode], _ = a.model.with_config(mla_decode=mode).decode_step(
            _long(a.toks[:, S]), S, c)
    assert torch.equal(out["auto"], out["absorbed"])
    _close(out["absorbed"], out["expanded"])


@pytest.mark.parametrize("groups", [1, 4])
def test_moe_routing_then_outputs_match_reference(groups, arch_data):
    check_moe_routing(arch_data(ARCH), groups)


def test_moe_routing_ties_take_the_lower_index(arch_data):
    """A zero router gives every expert the same probability: the top k
    are experts 0…k−1 in order, as ``jax.lax.top_k`` gives them."""
    a = arch_data(ARCH)
    cfg, tcfg = a.cfg, a.tcfg
    x = np.random.default_rng(12).normal(size=(B * S, cfg.d_model)).astype(
        np.float32)
    zero = np.zeros((cfg.d_model, cfg.moe.n_experts), np.float32)
    moe = {"router": jnp.asarray(zero), **jax.tree.map(
        lambda v: v[1], {k: v for k, v in a.params["layers"]["moe"].items()
                         if k != "router"})}
    (_, top, rank, keep, _, _), _ = _ref_moe(cfg, moe, x.reshape(B, S, -1))
    r = TL.moe_route(tcfg, torch.from_numpy(zero), torch.from_numpy(x))
    np.testing.assert_array_equal(_np(r.top), top)
    np.testing.assert_array_equal(
        _np(r.top), np.tile(np.arange(cfg.moe.top_k), (B * S, 1)))
    np.testing.assert_array_equal(_np(r.rank), rank)
    np.testing.assert_array_equal(_np(r.keep), keep)
