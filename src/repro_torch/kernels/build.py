"""Build and load the port's CUDA libraries.

Three families of shared library, each compiled with ``nvcc`` for
``sm_90a`` into ``build/repro_torch/`` at the root of the checkout and
loaded with ``ctypes``:

``round`` — one per fused round: the round's generated translation unit
            (``synthesis.emit_cuda_round``, which includes
            ``csrc/edge_sweep.cuh``) with the pull, push and resolve sweeps;
``level`` — one per (P expressions, monoid, mode) of ``ell_level_reduce``:
            the unit generated by ``synthesis.emit_cuda_level`` (which
            includes ``csrc/edge_level.cuh``);
``fixed`` — one library for the kernels that are not generated: every
            ``csrc/*.cu`` (embedding bag, ELL softmax, flash attention in
            bfloat16 and in float32, both on the tensor cores), included by
            one unit.

A library is named by the content hash of its unit, of every ``csrc/``
file the unit includes (followed transitively) and of the flags, so a
changed header never loads a stale library.  A built library is reused
across processes (same hash, same file) and memoized in the process.
Nothing is built when a module is imported: the first call that needs a
library builds it, or ``build_all`` builds several at once, one ``nvcc``
process each, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from repro_torch.core.guard import KernelBuildError

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# --fmad=false keeps every float multiply and add separately rounded, as
# PyTorch's elementwise ops are, so the kernels agree bitwise with their
# plain versions; never --use_fast_math (it would also flush denormals and
# approximate division).  Flash attention, held to a tolerance, contracts
# its float32 dot products and its softmax exponent explicitly with fmaf(),
# which the flag leaves alone.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict = {}                 # content hash → loaded library
_BY_UNIT: dict = {}              # (family, source) → loaded library
BUILD_SECONDS: dict = {}         # content hash → nvcc wall seconds

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


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
    raise KernelBuildError("nvcc not found: the CUDA kernels are built on "
                           "first use and need the CUDA toolkit")


def included_files(source: str) -> list:
    """The ``csrc/`` files a unit includes with ``#include "…"``, followed
    transitively, each once, in first-inclusion order."""
    seen, todo = [], [source]
    while todo:
        for name in _INCLUDE.findall(todo.pop()):
            path = CSRC / name
            if path not in seen and path.is_file():
                seen.append(path)
                todo.append(path.read_text())
    return seen


def source_key(source: str) -> str:
    """The content hash naming a unit's library: every included ``csrc/``
    file, the unit itself and the flags."""
    h = hashlib.sha256()
    for path in included_files(source):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(source.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:20]


def fixed_source() -> str:
    """The unit of the ``fixed`` library: every ``csrc/*.cu``."""
    return "".join(f'#include "{p.name}"\n'
                   for p in sorted(CSRC.glob("*.cu")))


# ---------------------------------------------------------------------------
# Each family's C entry points (every one returns the launch's cudaError).
# ---------------------------------------------------------------------------

_VP, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)


def _declare_round(lib):
    vp, i32, f32 = _VP, _I32, _F32
    # each sweep ends in (slot count, slot-major order, per-slot strides,
    # stream)
    slots = [i32, i32, vp, vp]
    lib.grafs_pull.argtypes = [vp] * 9 + [vp, vp, i32, i32, i32, f32,
                                          i32] + slots
    lib.grafs_push.argtypes = [vp] * 8 + [vp, vp, i32, i32, i32, f32] + slots
    lib.grafs_resolve.argtypes = [vp] * 7 + [i32] * 5 + slots
    lib.grafs_walk_attributes.argtypes = [vp]
    for fn in (lib.grafs_pull, lib.grafs_push, lib.grafs_resolve,
               lib.grafs_walk_attributes):
        fn.restype = i32
    return lib


def _declare_level(lib):
    vp = _VP
    lib.grafs_level.argtypes = [vp, vp, vp, _I32] + [vp] * 11 + [
        _I32, _I32, _F32, vp]
    lib.grafs_level_attributes.argtypes = [vp]
    for fn in (lib.grafs_level, lib.grafs_level_attributes):
        fn.restype = _I32
    return lib


def _declare_fixed(lib):
    vp, i32, i64 = _VP, _I32, _I64
    lib.grafs_embedding_bag.argtypes = [vp, vp, vp, vp, i64, i32, i64, i32,
                                        i32, i32, i32, vp]
    lib.grafs_ell_softmax.argtypes = [vp, vp, vp, i64, i64, i32, vp]
    flash = (lib.grafs_flash_sm90, lib.grafs_flash_3xtf32)
    attributes = (lib.grafs_ell_softmax_attributes,
                  lib.grafs_flash_sm90_attributes,
                  lib.grafs_flash_3xtf32_attributes)
    for fn in flash:
        fn.argtypes = [vp] * 4 + [i32] * 8 + [_F32, vp]
    for fn in attributes:
        fn.argtypes = [i32, ctypes.POINTER(ctypes.c_int)]
    for fn in (lib.grafs_embedding_bag, lib.grafs_ell_softmax, *flash,
               *attributes):
        fn.restype = i32
    return lib


_DECLARE = {"round": _declare_round, "level": _declare_level,
            "fixed": _declare_fixed}


def _so_path(family: str, key: str) -> Path:
    return BUILD_DIR / f"grafs_{family}_{key}.so"


def _start(family: str, key: str, source: str):
    """Write the unit and start its nvcc; returns (process, library path,
    temporary output path, start time), or None when the library already
    exists on disk."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _so_path(family, key)
    if so.is_file():
        return None
    cu = BUILD_DIR / f"grafs_{family}_{key}.cu"
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
        raise KernelBuildError(f"nvcc failed (exit {proc.returncode}) "
                               f"building {so.name}:\n{out}")
    os.replace(tmp, so)                    # atomic: readers never see half
    BUILD_SECONDS[key] = time.perf_counter() - t0


def build_all(units) -> list:
    """Build (where not yet built) and load the libraries of several units,
    each a ``(family, source)`` pair, every missing ``nvcc`` started at
    once.  A unit loaded before in this process is returned without
    hashing its files again (the headers do not change under a running
    process)."""
    units = [tuple(u) for u in units]
    if all(u in _BY_UNIT for u in units):
        return [_BY_UNIT[u] for u in units]
    keyed = [(fam, source_key(src), src) for fam, src in units]
    started = {}
    for fam, k, src in keyed:
        if k not in _LIBS and k not in started:
            st = _start(fam, k, src)
            if st is not None:
                started[k] = st
    errors = []
    for k, st in started.items():
        try:
            _finish(k, st)
        except KernelBuildError as exc:
            errors.append(str(exc))
    if errors:
        raise KernelBuildError("\n".join(errors))
    for fam, k, src in keyed:
        if k not in _LIBS:
            # a library that will not load, or lacks an entry point
            try:
                _LIBS[k] = _DECLARE[fam](ctypes.CDLL(str(_so_path(fam, k))))
            except (OSError, AttributeError) as exc:
                raise KernelBuildError(f"loading {_so_path(fam, k).name} "
                                       f"failed: {exc}") from exc
        _BY_UNIT[(fam, src)] = _LIBS[k]
    return [_LIBS[k] for _fam, k, _src in keyed]


def round_library(source: str):
    """The loaded library of one generated round unit (built on first
    use)."""
    return build_all([("round", source)])[0]


def level_library(source: str):
    """The loaded library of one generated level unit (built on first
    use)."""
    return build_all([("level", source)])[0]


_FIXED_SOURCE = fixed_source()


def fixed_library():
    """The loaded library of the fixed kernels (built on first use)."""
    return build_all([("fixed", _FIXED_SOURCE)])[0]
