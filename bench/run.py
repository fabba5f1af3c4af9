"""Run one cell of the benchmark once on the CUDA card.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  It puts ``src/`` on its import path (no
install), generates the configuration's graph, builds it through
``repro_torch``, warms up the cell's query kinds, measures for
``--seconds`` with the traffic in the seed's order (the first
``profile_window.TRACE_S`` of them under the profiler with ``--trace
1``), checks a seeded sample of the answers against the plain reference
and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``check``, each compared number beside its
limit.  The same numbers are
the last lines on standard error.

It exits with a non-zero code and prints no result when the card is
missing or there are fewer cards than the cell asks for, and when the
process holds JAX or the JAX package (``repro``) once the window has
closed.  The program's CUDA libraries are built once into
``build/repro_torch/`` of the checkout and loaded from there afterwards.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, taken whole, is JAX's or the
    JAX package's (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(run, metrics: dict, trace: bool, chips: int) -> dict:
    from reference import compare
    device = {"platform": "gpu", "kind": run.device_name, "count": chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": compare.verdict(run.check),
           "attempted": len(run.queries) + run.unanswered,
           "failed": run.unanswered + run.wrong_answers,
           "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["check"] = {k: {"value": v, "limit": compare.LIMITS[k]}
                    for k, v in run.check.items()}
    return out


def report(run, out: dict) -> None:
    """Standard error: each kind's latencies and iterations, the slowest
    queries, then each compared number beside its limit (last)."""
    import numpy as np

    import harness
    for kind, (lat, its) in sorted(harness.by_kind(run).items()):
        print(f"bench: {kind} answers {lat.size} latency ms p50 "
              f"{np.percentile(lat, 50) * 1e3:.1f} p95 "
              f"{np.percentile(lat, 95) * 1e3:.1f} max "
              f"{lat.max() * 1e3:.1f}; iterations p50 "
              f"{np.percentile(its, 50):.0f} p95 {np.percentile(its, 95):.0f}"
              f" max {its.max()}", file=sys.stderr)
    slow = sorted(run.queries, key=lambda q: q.t_send - q.t_done)[:5]
    print("bench: slowest " + "; ".join(
        f"{q.kind}@{q.root} {(q.t_done - q.t_send) * 1e3:.0f} ms "
        f"{q.iterations} it" for q in slow), file=sys.stderr)
    print(f"bench: libraries built in the window {run.built_in_window}",
          file=sys.stderr)
    if run.trace is not None:
        t = run.trace
        print(f"bench: trace busy_s {t['busy_s']} window_s {t['window_s']} "
              f"event_window_s {t.get('event_window_s')} kernels "
              f"{t['kernels']} host launches {t['launches']} steps "
              f"{t['steps']}", file=sys.stderr)
    for name, c in out["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    import torch

    import harness
    cell = harness.load_cell(harness.load_benchmark(ROOT), args.workload,
                             ROOT)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    trace = bool(args.trace)
    run = harness.setup(cell, args.seed, device, T_START)
    harness.window(run, args.seconds, trace)
    harness.free_program(run)
    harness.check(run)
    run.device_name = torch.cuda.get_device_name(device)
    metrics = harness.metrics(run, trace)
    loaded = forbidden_modules()
    if loaded:
        print(f"bench: the process holds {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    out = result_line(run, metrics, trace, chips)
    report(run, out)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
