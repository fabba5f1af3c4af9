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
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

_CHUNK_BYTES = 256 * 1024 * 1024      # 256MB row-chunks


def _flatten_with_paths(tree, prefix=()):
    """[(key, leaf)] in the reference's leaf order and key format."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    elif isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    else:
        return [("/".join(str(p) for p in prefix), tree)]
    out = []
    for k, sub in items:
        out += _flatten_with_paths(sub, prefix + (k,))
    return out


def _unflatten(tree_like, leaves):
    """``tree_like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if tree_like is None:
        return None
    if isinstance(tree_like, (tuple, list)):
        return type(tree_like)(_unflatten(t, leaves) for t in tree_like)
    if isinstance(tree_like, dict):
        vals = {k: _unflatten(tree_like[k], leaves) for k in sorted(tree_like)}
        return {k: vals[k] for k in tree_like}
    return next(leaves)


def _host(leaf) -> np.ndarray:
    """A host copy of one leaf, never a view of memory the caller may
    still write to."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


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
            np.save(os.path.join(tmp, fname), arr)
            chunks.append({"file": fname, "rows": [0, 1]})
        else:
            rows = max(1, _CHUNK_BYTES // max(
                arr.itemsize * int(np.prod(arr.shape[1:])), 1))
            for c0 in range(0, arr.shape[0], rows):
                c1 = min(c0 + rows, arr.shape[0])
                fname = f"leaf{i:04d}_c{c0}.npy"
                np.save(os.path.join(tmp, fname), arr[c0:c1])
                chunks.append({"file": fname, "rows": [int(c0), int(c1)]})
        manifest["leaves"].append({
            "key": key, "shape": list(arr.shape), "dtype": str(arr.dtype),
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


def restore_checkpoint(directory: str, tree_like: Any,
                       step: Optional[int] = None):
    """Restore into the structure of ``tree_like``, each leaf on the device
    and dtype of the matching tensor of ``tree_like`` (the device may
    differ from the one that saved).  Returns (tree, step, extra)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}
    out = []
    for key, like in _flatten_with_paths(tree_like):
        rec = by_key[key]
        arr = np.empty(rec["shape"], dtype=rec["dtype"])
        for ch in rec["chunks"]:
            data = np.load(os.path.join(path, ch["file"]))
            if arr.ndim == 0:
                arr = data
            else:
                arr[ch["rows"][0]:ch["rows"][1]] = data
        if isinstance(like, torch.Tensor):
            arr = torch.from_numpy(arr).to(device=like.device,
                                           dtype=like.dtype)
        out.append(arr)
    restored = _unflatten(tree_like, iter(out))
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
        host_tree = _unflatten(tree, iter(leaves))

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, extra)
                self._gc()
                self.last_saved = step
            except BaseException as exc:      # re-raised by wait()
                self._error = exc

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def restore_latest(self, tree_like):
        self.wait()
        return restore_checkpoint(self.directory, tree_like)
