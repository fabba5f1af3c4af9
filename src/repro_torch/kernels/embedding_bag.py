"""Fixed-width EmbeddingBag (the DLRM lookup): CUDA kernel and plain
version.

The port of ``repro.kernels.embedding_bag``: ``table`` [V, D] float32 or
bfloat16, ``idx`` [B, K] int32 row ids, optional ``weights`` [B, K]
float32 → [B, D] per-bag sum or mean in the table's dtype.  The kernel
(``csrc/embedding_bag.cu``, replacing ``_bag_kernel`` and
``_bag_kernel_weighted``) runs its grid over bags; a thread owns
``vector_width`` consecutive columns of one bag (16 bytes' worth where D
allows it and the table is 16-byte aligned, else one), loads two rows
ahead of its adds, and sums the K rows in slot order in float32; the plain version repeats that order, so the two agree bitwise on
the card.  Indices follow JAX's ``table[idx]``: negative ones wrap once,
then all are clamped into range.  Mean divides by K, with weights too.
Any B and D and any base alignment are accepted.

``embedding_bag`` launches the kernel for CUDA tensors (checking device,
dtype, shape and contiguity, and the launch status) and counts the launch
in ``LAUNCHES``; for CPU tensors it runs the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.launch import check, raise_on, stream

LAUNCHES = {"bag": 0}

_MODES = {"sum": 0, "mean": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    LAUNCHES["bag"] = 0


def embedding_bag(table, idx, weights: Optional[torch.Tensor] = None,
                  mode: str = "sum"):
    """Fixed-width EmbeddingBag: table [V, D], idx [B, K] → [B, D]."""
    if mode not in _MODES:
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    if table.ndim != 2 or idx.ndim != 2:
        raise ValueError(f"table must be [V, D] and idx [B, K], got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if weights is not None and tuple(weights.shape) != tuple(idx.shape):
        raise ValueError(f"weights must have idx's shape {tuple(idx.shape)}, "
                         f"got {tuple(weights.shape)}")
    if table.shape[0] == 0:
        raise ValueError("the table has no rows")
    if not table.is_cuda:
        return _bag_plain(table, idx, weights, mode)
    v, d = table.shape
    b, k = idx.shape
    if table.dtype not in _DTYPES:
        raise ValueError(f"table must be float32 or bfloat16, got "
                         f"{table.dtype}")
    check("table", table, table.dtype, aligned=False)
    check("idx", idx, torch.int32, aligned=False)
    if weights is not None:
        check("weights", weights, torch.float32, aligned=False)
    from repro_torch.kernels import build
    lib = build.fixed_library()
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    vec = vector_width(table) if out.data_ptr() % 16 == 0 else 1
    status = lib.grafs_embedding_bag(
        table.data_ptr(), idx.data_ptr(),
        None if weights is None else weights.data_ptr(), out.data_ptr(),
        v, d, b, k, _DTYPES[table.dtype], _MODES[mode], vec, stream(table))
    raise_on(status, "embedding_bag")
    LAUNCHES["bag"] += 1
    return out


def vector_width(table) -> int:
    """Columns per thread of the kernel on ``table``: 16 bytes' worth (4 in
    float32, 8 in bfloat16) where D is a multiple of that and the table's
    base is 16-byte aligned (the vector path), else 1 (the scalar path)."""
    vec = 16 // table.element_size()
    return vec if table.shape[1] % vec == 0 and table.data_ptr() % 16 == 0 \
        else 1


def _wrap_indices(idx, v: int):
    """JAX's index rule for ``table[idx]`` on a table of ``v`` rows."""
    i = idx.long()
    return torch.where(i < 0, i + v, i).clamp(0, v - 1)


def _bag_plain(table, idx, weights, mode):
    b, k = idx.shape
    rows = _wrap_indices(idx, table.shape[0])
    acc = torch.zeros((b, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for s in range(k):                  # slot order, as the kernel adds
        x = table[rows[:, s]].float()
        if weights is not None:
            x = x * weights[:, s:s + 1]
        acc = acc + x
    if mode == "mean":
        # a tensor divisor: a true division on the card as in the kernel
        # (torch multiplies by the reciprocal of a Python scalar there)
        acc = acc / torch.tensor(float(k), device=acc.device)
    return acc.to(table.dtype)
