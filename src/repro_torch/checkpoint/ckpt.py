"""Device-independent chunked checkpointing with an async writer.

The port of ``repro.checkpoint.ckpt``, with the reference's on-disk format
unchanged, so a tree of arrays saved by one package restores in the other:

  * **Manifest.**  Each leaf is saved as one or more 256 MB row chunks of
    the full array (``leaf%04d_c%d.npy``) plus a ``manifest.json`` with
    ``step``, ``extra`` and per leaf its ``key`` (the path indices or dict
    keys joined by ``/``), ``shape``, ``dtype`` and ``chunks``.
  * **Step-granular, atomic.**  A checkpoint directory ``step_%010d`` is
    written under a ``.tmp`` name and renamed, so a crash mid-write never
    corrupts the latest checkpoint; ``latest_step`` sees only completed
    renames.
  * **Async.**  ``CheckpointManager.save_async`` copies the tree to host
    memory synchronously and writes it on a background thread; ``wait``
    joins the writer and raises what it raised.

A tree is nested tuples, lists and dicts (dicts in sorted key order, as
``jax.tree_util`` orders them) of tensors, numpy arrays and Python
scalars; ``None`` holds no leaf.  ``restore_checkpoint`` puts each leaf on
the device and dtype of the matching tensor of ``tree_like``, so a carry on
the card is restored onto the card; a leaf whose ``tree_like`` counterpart
is not a tensor comes back as the numpy array that was saved.

A bfloat16 leaf is written as the reference writes it, without
``ml_dtypes``: its 16-bit words as ``'<V2'`` records in the ``.npy``
files and ``"dtype": "bfloat16"`` in the manifest, byte for byte the
reference's files.  It is read back by viewing the 2-byte words as
``torch.bfloat16`` (a leaf whose ``tree_like`` counterpart is not a
tensor comes back as a bfloat16 tensor on the CPU), so the port restores
its own bfloat16 leaves and the reference's bitwise.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import flatten_with_paths as _flatten_with_paths
from repro_torch.tree import unflatten

_CHUNK_BYTES = 256 * 1024 * 1024      # 256MB row-chunks
# A bfloat16 leaf on the host: its 16-bit words as 2-byte void records,
# the ``.npy`` descr the reference's ml_dtypes bfloat16 arrays carry.
_BF16_DESCR = "<V2"
_BF16_HOST = np.dtype("V2")


def _host(leaf) -> np.ndarray:
    """A host copy of one leaf, never a view of memory the caller may
    still write to."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_HOST)
        return t.numpy()
    return np.array(leaf)


def _save_npy(path: str, arr: np.ndarray):
    """``np.save``, with a bfloat16 leaf's header naming ``'<V2'`` as the
    reference's does (numpy alone would write ``'|V2'``)."""
    if arr.dtype != _BF16_HOST:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(arr.tobytes(order="C"))


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    """Synchronous save. Returns the final checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (key, leaf) in enumerate(_flatten_with_paths(tree)):
        arr = _host(leaf)
        chunks = []
        if arr.ndim == 0:
            fname = f"leaf{i:04d}_c0.npy"
            _save_npy(os.path.join(tmp, fname), arr)
            chunks.append({"file": fname, "rows": [0, 1]})
        else:
            rows = max(1, _CHUNK_BYTES // max(
                arr.itemsize * int(np.prod(arr.shape[1:])), 1))
            for c0 in range(0, arr.shape[0], rows):
                c1 = min(c0 + rows, arr.shape[0])
                fname = f"leaf{i:04d}_c{c0}.npy"
                _save_npy(os.path.join(tmp, fname), arr[c0:c1])
                chunks.append({"file": fname, "rows": [int(c0), int(c1)]})
        manifest["leaves"].append({
            "key": key, "shape": list(arr.shape),
            "dtype": "bfloat16" if arr.dtype == _BF16_HOST else str(arr.dtype),
            "chunks": chunks})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                     # atomic publish
    return final


def _steps(directory: str) -> list:
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def _device_leaves(devices, tree_like) -> list:
    """One target device (or None) per leaf of ``tree_like``: ``devices``
    is None, one device, or a tree of devices shaped like it."""
    n = len(_flatten_with_paths(tree_like))
    if devices is None or isinstance(devices, (str, torch.device)):
        return [None if devices is None else torch.device(devices)] * n
    flat = [torch.device(d) for _, d in _flatten_with_paths(devices)]
    if len(flat) != n:
        raise ValueError(f"{len(flat)} devices for {n} leaves")
    return flat


def restore_checkpoint(directory: str, tree_like: Any,
                       step: Optional[int] = None, devices: Any = None):
    """Restore into the structure of ``tree_like``, each leaf on the device
    and dtype of the matching tensor of ``tree_like`` (the device may
    differ from the one that saved), or on ``devices`` (one device, or a
    tree of devices shaped like ``tree_like``) where given for a tensor
    leaf.  Returns (tree, step, extra)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}
    targets = _device_leaves(devices, tree_like)
    out = []
    for (key, like), target in zip(_flatten_with_paths(tree_like), targets):
        rec = by_key[key]
        bf16 = rec["dtype"] == "bfloat16"
        arr = np.empty(rec["shape"], dtype=_BF16_HOST if bf16
                       else rec["dtype"])
        for ch in rec["chunks"]:
            data = np.load(os.path.join(path, ch["file"]))
            if bf16:
                data = data.view(_BF16_HOST)
            if arr.ndim == 0:
                arr = data
            else:
                arr[ch["rows"][0]:ch["rows"][1]] = data
        if bf16:
            arr = torch.from_numpy(arr.copy(order="C").view(
                np.int16)).view(torch.bfloat16)
        if isinstance(like, torch.Tensor):
            if not isinstance(arr, torch.Tensor):
                arr = torch.from_numpy(arr)
            arr = arr.to(device=target or like.device, dtype=like.dtype)
        out.append(arr)
    restored = unflatten(tree_like, out)
    return restored, manifest["step"], manifest.get("extra", {})


class CheckpointManager:
    """Async save + retention + restore-latest."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_saved: Optional[int] = None

    def wait(self):
        """Join the writer; an exception it raised is raised here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    def _gc(self):
        for s in _steps(self.directory)[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    def save_async(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()
        leaves = [_host(leaf) for _, leaf in _flatten_with_paths(tree)]
        host_tree = unflatten(tree, leaves)

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, extra)
                self._gc()
                self.last_saved = step
            except BaseException as exc:      # re-raised by wait()
                self._error = exc

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def restore_latest(self, tree_like, devices: Any = None):
        self.wait()
        return restore_checkpoint(self.directory, tree_like,
                                  devices=devices)
