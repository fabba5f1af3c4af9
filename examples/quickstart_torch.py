"""Quickstart on the PyTorch/CUDA port: spec → fusion → synthesis → engines.

    PYTHONPATH=src python examples/quickstart_torch.py              # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The walk of ``examples/quickstart.py`` on ``repro_torch``: a GraFS spec is
fused to the triple-let form, its kernels are synthesized (bounded
verification of C1–C10), and it runs on the port's engines — pull, push,
adaptive, dense and cuda (the hand-written CUDA sweeps; on the CPU their
plain versions) — each held against the paths semantics.  ``--device``
defaults to the CUDA card and fails without one.
"""
import argparse

import numpy as np

from repro_torch.core import engine, fusion
from repro_torch.core import usecases as U
from repro_torch.core.lang import paths_semantics
from repro_torch.core.synthesis import synthesize_round
from repro_torch.graph.structure import rmat_graph

ENGINES = ("pull", "push", "adaptive", "dense", "cuda")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    g = rmat_graph(200, 1200, seed=7, device=args.device)
    print(f"graph: {g.n} vertices, {g.num_edges} edges (seeded R-MAT) "
          f"on {g.device}\n")

    # 1. a declarative spec: widest-shortest-path from vertex 0 (Fig. 1 WSP)
    spec = U.wsp(0)
    print("spec: WSP(0)(v) = max capacity over args-min-length paths")

    # 2. fusion to the triple-let form (FPNEST flattens the nesting)
    prog = fusion.fuse(spec)
    stats = prog.stats
    print(f"fusion: {stats.total_rules()} rules applied "
          f"(fpnest={stats.fpnest}, fmpair={stats.fmpair}) "
          f"in {stats.wall_ms:.2f}ms")
    round_ = prog.rounds[0][1]
    print(f"triple-let: {len(round_.components)} fused components, "
          f"{len(round_.leaves)} leaves\n")

    # 3. kernel synthesis (bounded verification of C1–C10)
    synth = synthesize_round(round_)
    for key, val in synth.items():
        if isinstance(key, tuple) and key[0] == "kernels":
            print(f"synthesized kernels for {val.rop} {val.f}:")
            print("  " + val.describe().replace("\n", "\n  "))

    # 4. execute on every engine, cross-checked against the oracle
    small = rmat_graph(12, 40, seed=3, device=args.device)
    want = paths_semantics(spec, small, max_len=small.n)
    want = np.array([float(x) for x in want])

    def norm(v):                       # collapse every ⊥-ish value
        v = np.asarray(v, np.float64)
        return np.where(np.isnan(v) | (np.abs(v) >= 1e8), 1e9, v)

    for eng in ENGINES:
        res = engine.run_program(small, prog, engine=eng,
                                 device=args.device)
        ok = np.allclose(norm(res.value.cpu().numpy()), norm(want),
                         atol=1e-3)
        print(f"engine={eng:8s} iterations={res.stats.iterations} "
              f"edge_work={res.stats.edge_work:.0f} matches_oracle={ok}")

    # 5. fusion payoff on the bigger graph
    res_f = engine.run_program(g, prog, engine="pull", device=args.device)
    res_u = engine.run_program(g, fusion.lower_unfused(spec), engine="pull",
                               device=args.device)
    print(f"\nfusion payoff: edge work {res_f.stats.edge_work:.0f} fused vs "
          f"{res_u.stats.edge_work:.0f} unfused "
          f"(ratio {res_f.stats.edge_work / res_u.stats.edge_work:.2f})")


if __name__ == "__main__":
    main()
