"""The control of the check: the plain reference put in the program's
place, with every vertex state held in bfloat16, the precision below the
configuration's float32.  It answers the same number of queries of each
kind as a run compares, drawn from the same seeded traffic, and is judged
by the same comparison against the float32 reference; it has to come out
not correct.

    python3 bench/control.py --workload <name> --seeds <n> [<n> ...]

prints, for each seed, the compared numbers beside their limits, on the
CUDA card at the cell's own size.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def control(cell, seed: int, device, overrides=None) -> dict:
    import torch
    from harness import mix_traffic
    from reference import compare, graphgen, paths
    config = dict(cell.config, **(overrides or {}))
    edges = graphgen.generate(config, device)
    g = paths.ref_graph(edges, device)
    mix = cell.mix
    window, _ = mix_traffic(cell, edges, seed)
    want = {k: int(mix["check_per_kind"]) for k in mix["kinds"]}
    by_kind = {k: 0 for k in mix["kinds"]}
    client = 0
    while any(want.values()):
        q = window.next(client % int(mix["clients"]), 0.0)
        client += 1
        if not want[q.kind]:
            continue
        want[q.kind] -= 1
        by_kind[q.kind] += compare.wrong_vertices(
            paths.answer(g, q.kind, q.root, torch.bfloat16),
            paths.answer(g, q.kind, q.root))
    numbers = {"wrong_vertices": sum(by_kind.values()), "unanswered": 0}
    return {"numbers": numbers, "by_kind": by_kind,
            "correct": compare.verdict(numbers)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    import harness
    cell = harness.load_cell(harness.load_benchmark(ROOT), args.workload,
                             ROOT)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = control(cell, seed, "cuda")
        out.update(workload=args.workload, seed=seed,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
