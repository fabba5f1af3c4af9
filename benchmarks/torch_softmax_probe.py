#!/usr/bin/env python3
"""The ELL softmax kernel's variants and yardsticks (needs a CUDA card).

    PYTHONPATH=src python benchmarks/torch_softmax_probe.py \
        [--variants 8,4,32,64 4,4,32,64 ...] [--baseline FILE.cu ...] \
        [--out FILE]

Builds ``src/repro_torch/csrc/segment_softmax.cu`` once for each variant
``ROWS,UNROLL,WARPS,NARROW_WARPS`` (a copy of the source with
``SOFTMAX_ROWS`` rows a block, ``SOFTMAX_UNROLL`` mask loads in flight a
lane, and ``SOFTMAX_WARPS_PER_SM`` and ``SOFTMAX_NARROW_WARPS_PER_SM``
warps an SM asked of the compiler's register allocation for the unrolled
and the narrow kernel; a value left out keeps the source's), compiled with
the port's
nvcc flags and ``-Xptxas -v`` into ``build/softmax_probe/``), and, with
``--baseline``, other versions of the source as they are (for example the
parent commit's, for a comparison in one call).  Runs each build on the
smoke's cases: the in-layouts of ``rmat_graph(65536, 1048576, seed=16)``
in float32 and bfloat16 and of ``uniform_graph(2**21, 2**25, seed=21)`` in
float32, scores ``randn × 5``.  Each result is held to the plain version
(``_softmax_plain``) at the smoke's tolerance, then timed: the median
device time over CUDA events, the card first sleeping ~2 ms so that the
launch queues behind it, the builds in turn and then again in reverse
order.  Beside them: the bound (``ell_softmax_bytes`` over 3.35 TB/s), a
zero fill of the output (``out.zero_()``, the card's write rate on these
bytes), the mask converted to the scores' dtype (``mask.to(dtype)``: one
read of the mask and one write of an output, the kernel's traffic without
the scores) and the nearest library route, ``torch.softmax(scores.masked_fill(
~mask, -inf), 1)`` (two calls; NaN on an empty row, so a yardstick and not
the same function).  Prints each build's registers and spills as ptxas
reports them, and the card's name and power limit.
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
OUT_DIR = ROOT / "build" / "softmax_probe"
SLEEP_CYCLES = 4_000_000           # ~2 ms at the H100's 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
TOL = 1e-6                         # the smoke's: |Δ| <= 1e-6


def time_ms(fn, reps=20):
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


def build(variants, baseline):
    """One shared library per variant (and the baseline), every nvcc
    started at once; returns {name: (library, ptxas lines)}."""
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    text = (CSRC / "segment_softmax.cu").read_text()
    names = ("SOFTMAX_ROWS", "SOFTMAX_UNROLL", "SOFTMAX_WARPS_PER_SM",
             "SOFTMAX_NARROW_WARPS_PER_SM")
    pats = [re.compile(rf"constexpr int {n} = (\d+);") for n in names]
    found = [p.search(text) for p in pats]
    if not all(found):
        raise SystemExit(f"segment_softmax.cu lacks one of {names}")
    units = {}
    for values in variants:
        values = tuple(values) + tuple(int(f.group(1))
                                       for f in found[len(values):])
        src = text
        for name, pat, v in zip(names, pats, values):
            src = pat.sub(f"constexpr int {name} = {v};", src)
        label = "rows {}, unroll {}, warps {}, narrow {}".format(*values)
        units[label] = src
    for path in baseline:
        units[f"baseline {Path(path).name}"] = Path(path).read_text()
    procs = {}
    for i, (name, src) in enumerate(units.items()):
        cu = OUT_DIR / f"softmax_{i}.cu"
        cu.write_text(src)
        so = OUT_DIR / f"softmax_{i}.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(str(so))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.grafs_ell_softmax.argtypes = [vp, vp, vp, i64, i64, i32, vp]
        ptxas = [ln.strip() for ln in out.splitlines()
                 if "ell_softmax_kernel" in ln or "registers" in ln
                 or "spill" in ln]
        libs[name] = (lib, ptxas)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", nargs="+", default=[""],
                    help="ROWS[,UNROLL[,WARPS[,NARROW_WARPS]]] (default: "
                    "the source's)")
    ap.add_argument("--baseline", nargs="*", default=[],
                    help="other versions of segment_softmax.cu to time")
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from repro_torch.graph import structure as TS
    from repro_torch.kernels import segment_softmax as SS
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    variants = [tuple(int(x) for x in v.split(",") if x)
                for v in args.variants]
    libs = build(variants, args.baseline)
    for name, (_lib, ptxas) in libs.items():
        print(json.dumps({"build": name, "ptxas": ptxas}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(30)
    graphs = {"rmat16": TS.rmat_graph(65536, 1048576, seed=16, device=dev),
              "uniform21": TS.uniform_graph(2 ** 21, 2 ** 25, seed=21,
                                            device=dev)}
    cases = [("rmat16 in-layout float32", "rmat16", torch.float32),
             ("rmat16 in-layout bfloat16", "rmat16", torch.bfloat16),
             ("uniform21 in-layout float32", "uniform21", torch.float32)]
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for label, gname, dtype in cases:
        mask = TS.blocked_ell_cached(graphs[gname], direction="in").mask
        scores = torch.randn(tuple(mask.shape), generator=gen, device=dev) \
            .mul_(5.0).to(dtype)
        want = SS._softmax_plain(scores, mask)
        out = torch.empty_like(scores)
        nbytes = SS.ell_softmax_bytes(mask, dtype)
        row = {"case": label, "shape": list(mask.shape),
               "real_slots": int(mask.sum()), "bytes": nbytes,
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_all_slots_ms": mask.numel() * (1 + 2 * scores
                                                     .element_size())
               / HBM_BYTES_PER_S * 1e3}

        def call(lib, scores=scores, mask=mask, out=out, dtype=dtype):
            status = lib.grafs_ell_softmax(
                scores.data_ptr(), mask.data_ptr(), out.data_ptr(),
                mask.shape[0], mask.shape[1],
                1 if dtype == torch.bfloat16 else 0, stream)
            if status:
                raise RuntimeError(f"launch failed: cudaError {status}")

        rtol = 0.0 if dtype == torch.float32 else 2.0 ** -7
        for name, (lib, _ptxas) in libs.items():
            out.fill_(float("nan"))
            call(lib)
            torch.cuda.synchronize()
            diff = (out.float() - want.float()).abs()
            lim = TOL + rtol * want.float().abs()
            row[f"{name} worst_over_limit"] = float((diff / lim).max())
            row[f"{name} masked_exact_0"] = bool((out[~mask] == 0).all())
        order = list(libs) + list(reversed(libs))
        for name in order:
            row.setdefault(f"{name} ms", []).append(
                time_ms(lambda lib=libs[name][0]: call(lib)))
        row["zero_fill_ms"] = time_ms(out.zero_)
        row["mask_to_dtype_ms"] = time_ms(lambda: mask.to(dtype))
        row["yardstick_ms"] = time_ms(lambda: torch.softmax(
            scores.masked_fill(~mask, float("-inf")), 1))
        rows.append(row)
        print(json.dumps(row), flush=True)
        del scores, want, out
        torch.cuda.empty_cache()
    result = {"card": card, "cases": rows,
              "builds": {n: p for n, (_l, p) in libs.items()}}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
