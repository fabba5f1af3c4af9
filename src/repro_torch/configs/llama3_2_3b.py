"""llama3.2-3b [dense] — 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256  [hf:meta-llama/Llama-3.2-3B; unverified]"""
from repro_torch.models.layers import LMConfig

ARCH_ID = "llama3.2-3b"


def full() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab=128256, d_head=128, rope_theta=500000.0,
        dtype="bfloat16", param_dtype="bfloat16")


def smoke() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, d_head=16,
        dtype="float32", param_dtype="float32", remat="none")
