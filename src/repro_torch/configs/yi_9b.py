"""yi-9b [dense] — 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000,
llama-arch GQA  [arXiv:2403.04652; hf]"""
from repro_torch.models.layers import LMConfig

ARCH_ID = "yi-9b"


def full() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
        d_ff=11008, vocab=64000, d_head=128, rope_theta=10000.0,
        dtype="bfloat16", param_dtype="bfloat16")


def smoke() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=1, d_ff=96, vocab=256, d_head=16,
        dtype="float32", param_dtype="float32", remat="none")
