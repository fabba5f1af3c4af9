"""deepseek-v3-671b [moe] — 61L d_model=7168 128H d_ff_expert=2048
vocab=129280, MLA (q_lora 1536 / kv_lora 512 / rope 64 / nope 128 / v 128),
MoE 1 shared + 256 routed top-8, first 3 layers dense, MTP
[arXiv:2412.19437; hf]"""
from repro_torch.models.layers import LMConfig, MLACfg, MoECfg

ARCH_ID = "deepseek-v3-671b"


def full() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        d_ff=18432,                      # dense-layer FFN dim (first 3 layers)
        vocab=129280,
        mla=MLACfg(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                   qk_rope_head_dim=64, v_head_dim=128),
        moe=MoECfg(n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1,
                   capacity_factor=1.25, first_dense_layers=3),
        mtp=True, rope_theta=10000.0,
        dtype="bfloat16", param_dtype="bfloat16")


def smoke() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256,
        mla=MLACfg(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                   qk_rope_head_dim=8, v_head_dim=16),
        moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1,
                   first_dense_layers=1),
        mtp=True, dtype="float32", param_dtype="float32", remat="none")
