#!/usr/bin/env python3
"""Where the level sweep's time goes on a skewed layout (needs a CUDA card).

    PYTHONPATH=src python benchmarks/torch_level_probe.py [--out FILE]

Times ``repro_torch.kernels.edge_reduce.ell_level_reduce`` (the float
``n + w`` min level of ``chip_smoke.py``, every source active) on the
in-layout of ``rmat_graph(65536, 1048576, seed=16)`` and on copies of that
layout whose ``tile_nnz`` is zeroed in some row tiles, so that the kernel
skips their tiles:

- ``full``: the layout as built;
- ``hub zeroed``: the row tile with the most non-empty tiles emptied;
- ``deep zeroed``: every row tile with more than 8 non-empty tiles emptied;
- ``first tile only``: every row tile keeps its first slot tile only.

Then, on the full layout, the device time of each kernel of one call
(``torch.profiler``) and, where the package has the tile walk, the walk's
registers, grid and cell bytes (``edge_reduce.level_walk``).

If the time follows the deepest row tile (the most non-empty tiles one row
tile holds) rather than the tiles visited, a row tile's tiles are walked
one after another.  The results are not compared with anything (a zeroed
tile changes them).  Device time is the median over CUDA events, the card
first sleeping ~2 ms so that the launches queue behind it; the card's name
and power limit go beside the numbers.  The package is whatever
``repro_torch`` the path gives, so the same script times two checkouts.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess

import numpy as np
import torch

SLEEP_CYCLES = 4_000_000           # ~2 ms at the H100's 1.98 GHz boost clock


def time_ms(fn, reps):
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON result here")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from repro_torch.core.kernel_lang import FLT, Bin, Var
    from repro_torch.graph import structure as TS
    from repro_torch.kernels import edge_reduce as ER

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    g = TS.rmat_graph(65536, 1048576, seed=16, device=dev)
    e = TS.to_blocked_ell(g)
    n_pad = e.n_pad
    rng = np.random.default_rng(77)
    dist = rng.uniform(0.5, 9.0, n_pad).astype(np.float32)
    dist[rng.random(n_pad) < 0.25] = np.inf
    state = torch.from_numpy(dist).to(dev)
    active = torch.ones(n_pad, dtype=torch.int32, device=dev)
    ones = torch.ones(n_pad, dtype=torch.float32, device=dev)
    p = Bin("+", Var("n", FLT), Var("w", FLT))

    live = e.tile_nnz > 0
    depth = live.sum(1)
    variants = {"full": e.tile_nnz}
    nnz = e.tile_nnz.clone()
    nnz[int(depth.argmax())] = 0
    variants["hub zeroed"] = nnz
    nnz = e.tile_nnz.clone()
    nnz[depth > 8] = 0
    variants["deep zeroed"] = nnz
    nnz = e.tile_nnz.clone()
    nnz[:, 1:] = 0
    variants["first tile only"] = nnz
    rows = []
    for name, nnz in variants.items():
        lay = dataclasses.replace(e, tile_nnz=nnz.contiguous())
        kept = nnz > 0
        ms = time_ms(lambda lay=lay: ER.ell_level_reduce(
            lay, "min", [p], [state], [float("inf")], active, ones,
            wdeg=ones), args.reps)
        rows.append({"variant": name, "ms": ms,
                     "tiles": int(kept.sum()),
                     "deepest_row_tile": int(kept.sum(1).max())})
        print(json.dumps(rows[-1]), flush=True)
    # the device time of each kernel of one call, from torch.profiler over
    # the full layout's calls
    call = lambda: ER.ell_level_reduce(e, "min", [p], [state],  # noqa: E731
                                       [float("inf")], active, ones,
                                       wdeg=ones)
    call()
    torch.cuda.synchronize()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        for _ in range(args.reps):
            call()
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(ev.name[:80], [0, 0.0])
            k[0] += 1
            k[1] += ev.device_time_total
    per_call = {name: us / args.reps for name, (_n, us) in kernels.items()}
    print(json.dumps({"device_us_per_call": per_call}), flush=True)
    walk = None
    if hasattr(ER, "level_walk"):
        from repro_torch.kernels import build
        walk = ER.level_walk(e, build.level_library(ER.level_source(
            [p], [torch.float32], [float("inf")], "min", "value")))
        print(json.dumps({"walk": walk}), flush=True)
    result = {"card": card, "layout": [n_pad, e.width],
              "device_us_per_call": per_call, "walk": walk,
              "row_tiles_non_empty": int((depth > 0).sum()),
              "depth_percentiles": {
                  q: float(np.percentile(depth[depth > 0].cpu().numpy(), q))
                  for q in (50, 99, 99.9, 100)},
              "variants": rows}
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
