"""qwen2-72b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064, QKV bias  [arXiv:2407.10671; hf]"""
from repro_torch.models.layers import LMConfig

ARCH_ID = "qwen2-72b"


def full() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=29568, vocab=152064, d_head=128, qkv_bias=True,
        rope_theta=1000000.0, dtype="bfloat16", param_dtype="bfloat16")


def smoke() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab=256, d_head=16, qkv_bias=True,
        dtype="float32", param_dtype="float32", remat="none")
