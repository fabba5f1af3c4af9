"""Masked row softmax over the blocked-ELL layout (GAT edge attention):
CUDA kernel and plain version.

The port of ``repro.kernels.segment_softmax``: ``scores`` [n_pad, width]
float32 or bfloat16 and ``mask`` [n_pad, width] bool → weights of the
scores' dtype, each real row summing to 1, masked slots exactly 0 and an
empty row all zeros.  One kernel (``csrc/segment_softmax.cu``) replaces
both Pallas passes (``_stats_kernel``, ``_norm_kernel``): one warp per row
runs the online max/sum-exp pass over the row's slots, then the
normalising pass.  Where the width is a multiple of a 16-byte chunk (4
float32 or 8 bfloat16 slots) a lane takes whole chunks and reads a chunk's
scores only where a slot of it is real; other widths take a scalar path, a
slot a lane.  Arithmetic is float32.  Kernel and plain version sum in
different orders and are held to a tolerance, not bitwise.

``ell_softmax`` launches the kernel for CUDA tensors (checking device,
dtype, shape, contiguity and 16-byte alignment, and the launch status) and
counts the launch in ``LAUNCHES``; for CPU tensors it runs the plain
version.  ``ell_softmax_bytes`` counts the bytes a call needs, the
kernel's bound.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.launch import check, raise_on, stream

LAUNCHES = {"softmax": 0}

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PLAIN_CHUNK = 1 << 24           # slots per plain-version chunk (memory cap)


def reset_launches() -> None:
    LAUNCHES["softmax"] = 0


def ell_softmax(scores, mask):
    """scores/mask [n_pad, width] → masked row-softmax weights [n_pad,
    width]."""
    if scores.ndim != 2 or tuple(mask.shape) != tuple(scores.shape):
        raise ValueError(f"scores and mask must be one [n_pad, width] shape, "
                         f"got {tuple(scores.shape)} and {tuple(mask.shape)}")
    if not scores.is_cuda:
        return _softmax_plain(scores, mask)
    n_pad, width = scores.shape
    if scores.dtype not in _DTYPES:
        raise ValueError(f"scores must be float32 or bfloat16, got "
                         f"{scores.dtype}")
    check("scores", scores, scores.dtype)
    check("mask", mask, torch.bool)
    from repro_torch.kernels import build
    lib = build.fixed_library()
    out = torch.empty_like(scores)
    status = lib.grafs_ell_softmax(scores.data_ptr(), mask.data_ptr(),
                                   out.data_ptr(), n_pad, width,
                                   _DTYPES[scores.dtype], stream(scores))
    raise_on(status, "ell_softmax")
    LAUNCHES["softmax"] += 1
    return out


def ell_softmax_bytes(mask, dtype) -> int:
    """The bytes one ``ell_softmax`` of ``dtype`` scores over ``mask`` needs,
    each read or written once: every slot's mask byte and output, and the
    score of each real slot only (a masked slot's output is 0 whatever its
    score)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return mask.numel() * (1 + itemsize) + int(mask.sum()) * itemsize


def kernel_attributes(dtype) -> dict:
    """The compiled kernels for ``dtype`` scores: registers and local
    (spill) bytes per thread of the unrolled one (rows wider than 32
    16-byte chunks) and of the narrow one (``cudaFuncGetAttributes``; needs
    the card)."""
    from repro_torch.kernels import build
    attrs = (ctypes.c_int * 4)()
    raise_on(build.fixed_library().grafs_ell_softmax_attributes(
        _DTYPES[dtype], attrs), "ell_softmax attributes")
    return {"registers": attrs[0], "local_bytes": attrs[1],
            "narrow_registers": attrs[2], "narrow_local_bytes": attrs[3]}


def _softmax_plain(scores, mask):
    n_pad, width = scores.shape
    out = torch.zeros_like(scores)
    if width == 0:
        return out
    rows = max(1, _PLAIN_CHUNK // width)
    for r0 in range(0, n_pad, rows):
        s = scores[r0:r0 + rows].float()
        mk = mask[r0:r0 + rows]
        m = torch.where(mk, s, _NEG).amax(dim=1, keepdim=True) \
            .clamp(min=_NEG)
        e = torch.where(mk, torch.exp(s - m), 0.0)
        denom = e.sum(dim=1, keepdim=True).clamp(min=1e-30)
        # the raw score of a masked slot may exponentiate to inf: select,
        # never multiply by the mask
        w = torch.where(mk, torch.exp(s - m) / denom, 0.0)
        out[r0:r0 + rows] = w.to(scores.dtype)
    return out
