#!/usr/bin/env python3
"""How many rows the embedding-bag kernel should load ahead (needs a CUDA card).

    PYTHONPATH=src python benchmarks/torch_bag_chunks.py [--out FILE]

Builds ``src/repro_torch/csrc/embedding_bag.cu`` once for each row chunk
``BAG_CHUNK`` in (1, 2, 4, 8) (a copy of the source with that constant set,
compiled with the port's nvcc flags into ``build/bag_chunks/``), and times
each build on one DLRM RM2 table (4,000,000 × 64, ``configs/dlrm_rm2.py``)
for 65,536 bags: float32 K = 1 and K = 8 sum, float32 K = 8 weighted sum,
bfloat16 K = 8 sum, all on the vector path.  Prints each build's registers
per thread and spill bytes (``cudaFuncGetAttributes``) and the median
device time over CUDA events (the card first sleeping ~2 ms so that the
launch queues behind it), with the card's name and power limit.  The
outputs are not compared here: the ``gpu`` tests and ``chip_smoke.py`` hold
the kernel to its plain version.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT_DIR = ROOT / "build" / "bag_chunks"
SLEEP_CYCLES = 4_000_000           # ~2 ms at the H100's 1.98 GHz boost clock
V, D, B = 4_000_000, 64, 65_536

ATTRIBUTES = """
extern "C" int bag_attributes(int bf16, int chunk, int* out) {
  cudaFuncAttributes a;
  if (bf16)
    cudaFuncGetAttributes(&a, chunk == 1
        ? grafs::embedding_bag_kernel<__nv_bfloat16, 8, 1>
        : grafs::embedding_bag_kernel<__nv_bfloat16, 8, grafs::BAG_CHUNK>);
  else
    cudaFuncGetAttributes(&a, chunk == 1
        ? grafs::embedding_bag_kernel<float, 4, 1>
        : grafs::embedding_bag_kernel<float, 4, grafs::BAG_CHUNK>);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  return (int)cudaGetLastError();
}
"""


def time_ms(fn, reps=30):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def build(chunks):
    """One shared library per chunk, every nvcc started at once."""
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    text = (CSRC / "embedding_bag.cu").read_text()
    pattern = re.compile(r"constexpr int BAG_CHUNK = \d+;")
    if not pattern.search(text):
        raise SystemExit("embedding_bag.cu has no BAG_CHUNK constant")
    procs = {}
    for c in chunks:
        cu = OUT_DIR / f"bag_chunk{c}.cu"
        cu.write_text(pattern.sub(f"constexpr int BAG_CHUNK = {c};", text)
                      + ATTRIBUTES)
        so = OUT_DIR / f"bag_chunk{c}.so"
        procs[c] = (so, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(so),
             str(cu)]))
    libs = {}
    for c, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed for BAG_CHUNK = {c}")
        lib = ctypes.CDLL(str(so))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.grafs_embedding_bag.argtypes = [vp, vp, vp, vp, i64, i32, i64,
                                            i32, i32, i32, i32, vp]
        lib.bag_attributes.argtypes = [i32, i32, vp]
        libs[c] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    libs = build((1, 2, 4, 8))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(40)
    table = torch.randn((V, D), generator=gen, device=dev)
    tables = {0: table, 1: table.to(torch.bfloat16)}
    idx = {k: torch.randint(0, V, (B, k), generator=gen, device=dev,
                            dtype=torch.int32) for k in (1, 8)}
    w = torch.randn((B, 8), generator=gen, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    cases = (("float32 K=1 sum", 0, 1, None), ("float32 K=8 sum", 0, 8, None),
             ("float32 K=8 sum weighted", 0, 8, w),
             ("bfloat16 K=8 sum", 1, 8, None))
    rows = []
    for chunk, lib in libs.items():
        row = {"chunk": chunk}
        attrs = (ctypes.c_int * 2)()
        for bf16 in (0, 1):
            lib.bag_attributes(bf16, chunk, attrs)
            row[("bfloat16" if bf16 else "float32") + " registers, spill"] = \
                [attrs[0], attrs[1]]
        for label, bf16, k, weights in cases:
            tab = tables[bf16]
            out = torch.empty((B, D), dtype=tab.dtype, device=dev)

            def call(tab=tab, k=k, weights=weights, out=out, bf16=bf16):
                status = lib.grafs_embedding_bag(
                    tab.data_ptr(), idx[k].data_ptr(),
                    None if weights is None else weights.data_ptr(),
                    out.data_ptr(), V, D, B, k, bf16, 0, 8 if bf16 else 4,
                    stream)
                if status:
                    raise RuntimeError(f"launch failed: cudaError {status}")
            row[label] = time_ms(call)
        rows.append(row)
        print(json.dumps(row), flush=True)
    result = {"card": card, "table": [V, D], "bags": B, "chunks": rows}
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
