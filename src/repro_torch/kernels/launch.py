"""Launch plumbing shared by the kernel wrappers: argument checks for CUDA
tensors, the launch-status check and the current stream."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.guard import KernelLaunchError


def check(name: str, t, dtype, shape=None, aligned: bool = True):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``, when given), 16-byte aligned unless ``aligned`` is False."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def raise_on(status: int, kernel: str):
    """A kernel's C entry point returns its launch's cudaError; 0 means
    launched."""
    if status != 0:
        raise KernelLaunchError(f"CUDA {kernel} kernel launch failed: "
                                f"cudaError {status}")


def stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
