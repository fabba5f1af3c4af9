"""llama4-maverick's smoke LM (iRoPE: local attention chunks of 8, every
fourth layer global; top-1 MoE with one shared expert in every layer)
against the JAX package's, on the CPU.

The per-arch parity checks of ``test_torch_models.py`` (forward, loss,
prefill, decode, ``serve.generate``, the weights' round trip), then the
attention modes over local chunks and several KV tiles, and the MoE
routing (top, rank and keep equal to the reference's, then the
outputs), at the tolerances stated there.
"""
import pytest

from test_torch_models import (_close, _port_serve, check_decode,
                               check_forward, check_generate, check_loss,
                               check_moe_routing, check_prefill,
                               check_round_trip)
from test_torch_models import arch_data  # noqa: F401 (a fixture)

ARCH = "llama4-maverick-400b-a17b"


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


@pytest.mark.parametrize("impl", ["naive", "chunked", "scan"])
def test_attention_modes_match_reference(impl, arch_data):
    """llama4's GQA with local chunks of 8 over KV tiles of 8: the prefill
    over its cache of 32 runs 4 tiles, and a row's tiles before its local
    chunk and past its position are fully masked (so is every tile of
    the decode at position 16 but the third).  The reference runs its
    whole-logits, flash-core and scan bodies; the port its naive and its
    one online-softmax loop, taken for both other modes."""
    a = arch_data(ARCH)
    changes = (("attn_impl", impl), ("kv_chunk", 8))
    model = a.model.with_config(**dict(changes))
    assert model.cfg.attn_impl == impl
    want = a.ref("serve", changes)
    port = _port_serve(model, a.toks)
    _close(port["prefill"], want["prefill"])
    _close(port["decode"], want["decode"])


@pytest.mark.parametrize("groups", [1, 2])
def test_moe_routing_then_outputs_match_reference(groups, arch_data):
    check_moe_routing(arch_data(ARCH), groups)
