"""Build and load the generated CUDA edge-sweep libraries.

One shared library per fused round: the round's generated translation unit
(``synthesis.emit_cuda_round``, which includes ``csrc/edge_sweep.cuh``) is
compiled with ``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` at the
root of the checkout, under a name that is the content hash of the header,
the generated source and the flags, and loaded with ``ctypes``.  A built
library is reused across processes (same hash, same file) and memoized in
the process.  Nothing is built when a module is imported: the first call
that needs a round's kernels builds them, or ``build_all`` builds several
rounds at once, one ``nvcc`` process each, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# --fmad=false keeps every float multiply and add separately rounded, as
# PyTorch's elementwise ops are, so the kernels agree bitwise with their
# plain versions; never --use_fast_math (it would also flush denormals and
# approximate division).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict = {}                 # content hash → loaded library
BUILD_SECONDS: dict = {}         # content hash → nvcc wall seconds


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA edge sweeps are built on "
                       "first use and need the CUDA toolkit")


def source_key(source: str) -> str:
    """The content hash naming a unit's library: header, source, flags."""
    h = hashlib.sha256()
    h.update((CSRC / "edge_sweep.cuh").read_bytes())
    h.update(source.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:20]


def _declare(lib):
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.grafs_pull.argtypes = [vp] * 8 + [vp, vp, i32, i32, i32, f32, i32, vp]
    lib.grafs_push.argtypes = [vp] * 8 + [vp, vp, i32, i32, i32, f32, vp]
    lib.grafs_resolve.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, vp]
    for fn in (lib.grafs_pull, lib.grafs_push, lib.grafs_resolve):
        fn.restype = i32
    return lib


def _start(key: str, source: str):
    """Write the unit and start its nvcc; returns (process, library path,
    temporary output path, start time), or None when the library already
    exists on disk."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"grafs_round_{key}.so"
    if so.is_file():
        return None
    cu = BUILD_DIR / f"grafs_round_{key}.cu"
    cu.write_text(source)
    tmp = tempfile.NamedTemporaryFile(dir=BUILD_DIR, suffix=".so",
                                      delete=False)
    tmp.close()
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp.name,
           str(cu)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, so, Path(tmp.name), time.perf_counter()


def _finish(key: str, started) -> None:
    proc, so, tmp, t0 = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}) building "
                           f"{so.name}:\n{out}")
    os.replace(tmp, so)                    # atomic: readers never see half
    BUILD_SECONDS[key] = time.perf_counter() - t0


def build_all(sources) -> list:
    """Build (where not yet built) and load the libraries of several
    generated units, every missing ``nvcc`` started at once."""
    keys = [source_key(s) for s in sources]
    started = {}
    for k, s in zip(keys, sources):
        if k not in _LIBS and k not in started:
            st = _start(k, s)
            if st is not None:
                started[k] = st
    errors = []
    for k, st in started.items():
        try:
            _finish(k, st)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in keys:
        if k not in _LIBS:
            _LIBS[k] = _declare(ctypes.CDLL(
                str(BUILD_DIR / f"grafs_round_{k}.so")))
    return [_LIBS[k] for k in keys]


def round_library(source: str):
    """The loaded library of one generated unit (built on first use)."""
    return build_all([source])[0]
