"""PyTorch/CUDA port of the GraFS reproduction (see README.md).

Mirrors the module tree of ``repro`` and imports no JAX: every hot edge
sweep runs as a hand-written CUDA kernel on the card, with a plain PyTorch
version of each kernel beside it for CPU tensors.
"""
