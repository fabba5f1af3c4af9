"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192(expert), vocab=202048, MoE 128 routed top-1 + 1 shared, iRoPE
chunked local attention (3 of 4 layers local @8192, every 4th global)
[hf:meta-llama/Llama-4-Maverick-17B-128E; unverified]"""
from repro_torch.models.layers import LMConfig, MoECfg

ARCH_ID = "llama4-maverick-400b-a17b"


def full() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=16384,                      # shared-expert/dense FFN dim
        vocab=202048, d_head=128,
        moe=MoECfg(n_experts=128, top_k=1, d_ff_expert=8192, n_shared=1,
                   capacity_factor=1.25, interleave_step=2),
        attn_chunk=8192, chunk_global_every=4, rope_theta=500000.0,
        dtype="bfloat16", param_dtype="bfloat16")


def smoke() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, d_head=16,
        moe=MoECfg(n_experts=8, top_k=1, d_ff_expert=32, n_shared=1),
        attn_chunk=8, chunk_global_every=4,
        dtype="float32", param_dtype="float32", remat="none")
