"""Serving driver for the port's continuous-batching analytics service.

    PYTHONPATH=src python -m repro_torch.launch.analytics --smoke
    PYTHONPATH=src python -m repro_torch.launch.analytics --smoke --device cpu

``--smoke`` runs a small seeded open-loop trace (mixed BFS/SSSP sweep
queries + fused scalar radius/drr queries over an R-MAT graph) through
``repro_torch.launch.service.AnalyticsService`` on the ``cuda`` engine,
prints the deterministic serving metrics, then replays EVERY completed
request as a solo ``run_program`` and asserts the service answers are
bitwise-identical (``verify_sequential``) and that continuous batching
actually batched (queries_per_launch > 1).  Exit status is the contract.
It runs on the CUDA card unless ``--device cpu`` asks for the plain
versions of the kernels.

``--dryrun`` runs ``repro_torch.launch.analytics_dryrun`` in this process
(the production-mesh dry-run record, built on the ``meta`` device); the
arguments it does not know (``--multi-pod``, ``--out``, ``--n``, ``--e``)
pass through to it.
"""
from __future__ import annotations

import argparse
import json


def run_smoke(seed: int = 0, n_requests: int = 24, engine_name: str = "cuda",
              verbose: bool = True, device=None) -> dict:
    """The open-loop serving smoke: returns the metrics dict (with the
    bitwise-verification count added) or raises on any violation."""
    from repro_torch.core import usecases as U
    from repro_torch.graph import structure
    from repro_torch.launch import service as S

    cfg = S.ServiceConfig(engine=engine_name, max_batch=4, chunk_iters=3,
                          max_scalar_fuse=6, device=device)
    g = structure.rmat_graph(192, 768, seed=7, weighted=True,
                             device=cfg.device)
    svc = S.AnalyticsService(cfg)
    svc.add_graph("rmat", g)
    svc.register("BFS", U.bfs)
    svc.register("SSSP", U.sssp)

    # arrival rate ~8× the per-chunk virtual service time: enough pressure
    # that batches fill and scalar requests queue up to be paired
    arrivals = S.open_loop_arrivals(
        n_requests, rate=1.0 / (cfg.launch_overhead_s + cfg.iter_cost_s),
        seed=seed, make_request=S.standard_mix("rmat", g.n))
    metrics = svc.run_open_loop(arrivals)

    checked = S.verify_sequential(svc)
    metrics["verified_bitwise"] = checked
    if checked != n_requests:
        raise AssertionError(
            f"verified {checked}/{n_requests} requests — some never "
            "completed or lost their graph")
    if metrics["queries_per_launch"] <= 1.0:
        raise AssertionError(
            "continuous batching did not batch: queries_per_launch = "
            f"{metrics['queries_per_launch']} <= 1")
    if verbose:
        print(f"[analytics --smoke] {json.dumps(metrics, indent=1)}")
        print(f"[analytics --smoke] ok on {cfg.device}: {checked} answers "
              f"bitwise-equal to solo runs, queries_per_launch="
              f"{metrics['queries_per_launch']}")
    return metrics


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="seeded open-loop serving run + bitwise check")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--engine", default="cuda")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions of the kernels)")
    ap.add_argument("--dryrun", action="store_true",
                    help="run repro_torch.launch.analytics_dryrun")
    args, rest = ap.parse_known_args(argv)

    if args.dryrun:
        from repro_torch.launch import analytics_dryrun
        return analytics_dryrun.main(rest)
    if rest:
        ap.error(f"unrecognized arguments: {rest}")
    if not args.smoke:
        ap.error("nothing to do: pass --smoke (serving check)")
    run_smoke(seed=args.seed, n_requests=args.requests,
              engine_name=args.engine, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
