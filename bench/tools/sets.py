"""Run cells of the benchmark several times, one process a run, one run
after another, and report each metric's median and spread for each set.

    python3 bench/tools/sets.py --workload <name> [--workload ...] \\
        --seeds <n> [<n> ...] [--sets 2] --seconds <s> [--trace 0|1] \\
        [--out chiprun_out/sets.jsonl]

Every set runs the same seeds in the same order.  A spread is the distance
between the first and the third quartile (``statistics.quantiles(values,
n=4)``) as a share of the median.  Each run's result line, exit code,
wall time and the end of its standard error go to ``--out``, one JSON
object a line.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def one_run(workload, seed, seconds, trace) -> dict:
    cmd = [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
           workload, "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=1300)
    lines = p.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"workload": workload, "seed": seed, "trace": trace,
            "rc": p.returncode, "wall_s": time.perf_counter() - t0,
            "result": result, "stderr_tail": p.stderr[-3000:]}


def spread(values: list) -> tuple:
    med = statistics.median(values)
    if len(values) < 2 or med == 0:
        return med, 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / abs(med)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/sets.jsonl")
    args = ap.parse_args()
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    print("card:", card(), flush=True)
    for w in args.workload:
        sets = []
        for s in range(args.sets):
            runs = []
            for seed in args.seeds:
                r = one_run(w, seed, args.seconds, args.trace)
                r["set"] = s
                with out.open("a") as f:
                    f.write(json.dumps(r) + "\n")
                res = r["result"] or {}
                print(f"{w} set {s} seed {seed} rc {r['rc']} wall "
                      f"{r['wall_s']:.1f} correct {res.get('correct')} "
                      f"metrics {json.dumps(res.get('metrics'))} check "
                      f"{json.dumps(res.get('check'))}", flush=True)
                if r["rc"] != 0 or not res:
                    print(r["stderr_tail"][-1500:], flush=True)
                runs.append(res)
            sets.append(runs)
        for s, runs in enumerate(sets):
            names = sorted({k for r in runs for k in r.get("metrics", {})})
            for name in names:
                vals = [r["metrics"][name]["value"] for r in runs
                        if name in r.get("metrics", {})]
                med, sp = spread(vals)
                print(f"{w} set {s} {name} n {len(vals)} median {med} "
                      f"spread {sp:.4f}", flush=True)
            print(f"{w} set {s} correct "
                  f"{sum(bool(r.get('correct')) for r in runs)}/{len(runs)}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
