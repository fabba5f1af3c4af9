#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of GraFS on one CUDA card.

    python3 chip_smoke.py            # one card, no arguments

Run from the root of a checkout: it imports ``src/repro_torch`` (and
nothing of JAX or of the JAX package ``repro``), builds the CUDA edge-sweep
kernels from ``src/repro_torch/csrc`` with nvcc on first use (all rounds'
libraries at once, into ``build/repro_torch/``), and then

1. holds each kernel (pull sweep, push sweep, sorted push resolution)
   against its plain PyTorch version on the card, on the layouts of the
   Graph500-style Kronecker graph ``rmat_graph(65536, 1048576, seed=16)``
   (SCALE 16, edge factor 16) at frontier densities 0.05 and 1.0 for BFS
   (int min), WSP (two lex levels) and weighted PageRank (float sum):
   candidates and has-pred must be bitwise equal; times each with CUDA
   events beside its plain version and its memory bound (the bytes the
   kernel must move, counting of the per-edge inputs only those the
   round's P reads);
2. checks the RM-XS work counters against the reference's
   (BENCH_pallas.json) and a small query against the path oracle;
3. drives the main path — ``engine.run_program`` / ``run_direct`` with
   ``engine="cuda"`` — on the SCALE-16 graph (BFS, SSSP, WSP, CC on its
   undirected closure, PageRank, weighted PageRank with ``model="push"``)
   and on ``uniform_graph(2**21, 2**25, seed=21)`` (BFS, PageRank), each
   held against the port's own ``pull`` engine on the card (idempotent
   rounds bitwise, PageRank allclose rtol 1e-5).  The kernel launch counts
   are set to 0 just before each graph's queries and read just after;
   between the two graphs, the three kernels are held bitwise against
   their plain versions once more on the uniform graph's layouts (its
   262,144 row tiles exceed a CUDA grid's y limit), for BFS, PageRank and
   weighted PageRank at frontier densities 0.05 and 1.0.  Those
   comparison launches are not counted.

Any failure raises and exits non-zero.  The line before the last holds the
card's name and power limit; the ``kernels`` line before it the per-kernel
numbers; the last line is the JSON result.  Details also go to
``chiprun_out/chip_smoke.json`` when that directory can be written.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
KERNEL_SOURCE = "src/repro_torch/csrc/edge_sweep.cuh"
REPLACES = {"pull": "src/repro/kernels/edge_reduce.py:165",
            "push": "src/repro/kernels/edge_reduce.py:367",
            "resolve": "src/repro/kernels/edge_reduce.py:553"}

# RM-XS targets from BENCH_pallas.json (direction_rows / resolution_rows of
# rmat_graph(400, 3200, seed=11)): unweighted BFS iterations / push
# iterations / edge work auto / edge work pull-only / resolve work, and
# weighted SSSP iterations / edge work auto.
RMXS_BFS = (6, 3, 7854, 9715, 6025)
RMXS_WSSSP = (8, 13703)


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main(argv) -> int:
    if argv:
        print(f"chip_smoke.py takes no arguments, got {argv}",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py runs from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; torch.cuda.is_available() "
              "is false", file=sys.stderr)
        return 2
    torch.use_deterministic_algorithms(True)
    from repro_torch.core import engine as TE
    from repro_torch.core import fusion as TF
    from repro_torch.core import usecases as TU
    from repro_torch.core.iterate import DTYPES, CompRuntime, comp_runtimes
    from repro_torch.core.fusion import Prim
    from repro_torch.core.kernel_lang import expr_vars
    from repro_torch.core.synthesis import (pagerank_kernels,
                                            synthesize_round,
                                            weighted_pagerank_kernels)
    from repro_torch.graph import structure as TS
    from repro_torch.kernels import build
    from repro_torch.kernels import edge_reduce as ER
    from repro_torch.kernels import ops as KO

    dev = torch.device("cuda")
    card = card_line()
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # ------------------------------------------------------------------
    # Build every round's library at once (one nvcc each).
    # ------------------------------------------------------------------
    progs = {name: TF.fuse(TU.ALL_SPECS[name]())
             for name in ("BFS", "SSSP", "WSP", "CC")}

    def program_round(prog):
        (rnd,) = [r for _n, r in prog.rounds if r.leaves]
        return KO.sweep_round(comp_runtimes(rnd, synthesize_round(rnd)),
                              [leaf.plan for leaf in rnd.leaves])

    def direct_round(dk):
        comp = CompRuntime(idx=0, op=dk.rop, dtype=DTYPES[dk.dtype],
                           p_fn=dk.p_fn, init_fn=dk.init_fn,
                           source=dk.source, e_fn=dk.e_fn, p_expr=dk.p_expr)
        return KO.sweep_round([comp], [Prim(dk.rop, 0)])

    rounds = {name: program_round(p) for name, p in progs.items()}
    rounds["PR"] = direct_round(pagerank_kernels(2))
    rounds["WPR"] = direct_round(weighted_pagerank_kernels(2))
    t0 = time.perf_counter()
    sources = [r.source() for r in rounds.values()]
    build.build_all(sources)
    keys = [build.source_key(s) for s in sources]
    builds = {name: round(build.BUILD_SECONDS.get(k, 0.0), 3)
              for name, k in zip(rounds, keys)}
    record["build_s"] = builds
    log(f"build: {time.perf_counter() - t0:.1f} s wall, per library "
        f"{json.dumps(builds)}")

    # ------------------------------------------------------------------
    # Phase 1: kernels against their plain versions on the card.
    # ------------------------------------------------------------------
    import numpy as np

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def time_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts)

    cases = []

    def kernel_cases(label, g, rnames, reps, plain_reps):
        """Each kernel against its plain version on ``g``'s layouts, for
        the rounds ``rnames`` at frontier densities 0.05 and 1.0: bitwise
        equality, CUDA-event times and the byte bound."""
        ein = TS.blocked_ell_cached(g, direction="in")
        eout = TS.blocked_ell_cached(g, direction="out")
        res = TS.push_resolution_cached(g)
        outdeg = torch.zeros(ein.n_pad, dtype=torch.float32, device=dev)
        outdeg[:g.n] = g.out_deg.clamp(min=1).float()
        wdeg = torch.ones(ein.n_pad, dtype=torch.float32, device=dev)
        wdeg[:g.n] = TS.w_out_deg(g)
        for rname in rnames:
            for density in (0.05, 1.0):
                cases.append(kernel_case(label, g, ein, eout, res, outdeg,
                                         wdeg, rname, density, reps,
                                         plain_reps))

    def kernel_case(label, g, ein, eout, res, outdeg, wdeg, rname, density,
                    reps, plain_reps):
        rnd = rounds[rname]
        n_pad = ein.n_pad
        rng = np.random.default_rng(1000 + int(density * 100))
        active = torch.from_numpy(
            (rng.random(n_pad) < density).astype(np.int32)).to(dev)
        active[g.n:] = 0
        st = []
        for dt, ident in zip(rnd.dtypes, rnd.idents):
            if dt == torch.float32:
                v = rng.uniform(0.5, 9.0, n_pad).astype(np.float32)
            else:
                v = rng.integers(0, 50, n_pad).astype(np.int32)
            v[rng.random(n_pad) < 0.25] = ident
            st.append(torch.from_numpy(v).to(dev))
        t_in = ER.tile_activity(ein.nbrs, ein.mask, ein.tile_nnz, active)
        t_out = ER.tile_activity_push(eout.tile_nnz, active)
        t_res = ER.resolution_tile_activity(res.contrib, t_out, res.tile_nnz)
        pull_args = (rnd, t_in, ein.nbrs, ein.weight, ein.capacity,
                     ein.mask, active, outdeg, wdeg, st, float(g.n), True)
        push_args = (rnd, t_out, eout.nbrs, eout.weight, eout.capacity,
                     eout.mask, active, outdeg, wdeg, st, float(g.n))
        k_pull = ER.pull_sweep(*pull_args)
        k_push = ER.push_sweep(*push_args)
        k_res = ER.resolve_sweep(rnd, t_res, res.valid, res.in2out, k_push)
        torch.cuda.synchronize()
        p_pull = ER._pull_plain(*pull_args)
        p_push = ER._push_plain(*push_args)
        p_res = ER._resolve_plain(rnd, t_res, res.valid, res.in2out, p_push)
        errs = {}
        for kname, ks, ps in (("pull", k_pull, p_pull),
                              ("push", k_push, p_push),
                              ("resolve", k_res, p_res)):
            for a, b in zip(ks, ps):
                if not torch.equal(bits(a), bits(b)):
                    diff = (a.double() - b.double()).abs()
                    raise RuntimeError(
                        f"{kname} kernel disagrees with its plain version "
                        f"({rname} on {label}, density {density}): max |Δ| "
                        f"{float(diff.nan_to_num(float('inf')).max())}")
            errs[kname] = max(float((a.double() - b.double()).abs()
                                    .nan_to_num(0.0).max())
                              for a, b in zip(ks, ps))
        del p_pull, p_push, p_res
        nc, nl = len(rnd.dtypes), rnd.n_levels
        n_tiles_in = int(t_in.sum())
        n_tiles_out = int(t_out.sum())
        n_tiles_res = int(t_res.sum())
        slot = ER.BLOCK_V * ER.BLOCK_E
        # The least bytes: each input read once, each output written once.
        # A skipped tile reads only its activity word.  A processed slot
        # reads its mask (1 B) and, of the other per-edge inputs, only those
        # the kernels load for this round (4 B each): the pull sweep's
        # source index always; the push sweep's destination index, the
        # weight and the capacity only where the round's P reads them.  The
        # vectors read are the frontier, the states and the degree vectors
        # that P reads.
        reads = frozenset().union(*map(expr_vars, rnd.p_exprs))

        def slot_bytes(*names):
            return 1 + 4 * sum(nm in reads for nm in names)
        vec = n_pad * 4 * (1 + nc + ("outdeg" in reads) + ("wdeg" in reads))
        bytes_ = {
            "pull": t_in.numel() * 4 + n_tiles_in * slot * (
                4 + slot_bytes("w", "c")) + vec
            + n_pad * (ein.width // ER.BLOCK_E) * 4 * (nl + nc),
            "push": t_out.numel() * 4 + n_tiles_out * slot * slot_bytes(
                "edst", "w", "c") + vec + eout.nbrs.numel() * 4 * nc,
            # in2out (4 B) and valid (1 B) per processed slot, then one
            # candidate word per component for each valid slot gathered
            "resolve": t_res.numel() * 4 + n_tiles_res * slot * 5
            + int((res.tile_nnz * t_res).sum()) * 4 * nc
            + n_pad * (res.width // ER.BLOCK_E) * 4 * nl,
        }
        case = {"graph": label, "round": rname, "density": density,
                "p_reads": sorted(reads),
                "tiles": {"pull": n_tiles_in, "push": n_tiles_out,
                          "resolve": n_tiles_res}}
        for kname, fn, plain in (
                ("pull", lambda: ER.pull_sweep(*pull_args),
                 lambda: ER._pull_plain(*pull_args)),
                ("push", lambda: ER.push_sweep(*push_args),
                 lambda: ER._push_plain(*push_args)),
                ("resolve", lambda: ER.resolve_sweep(
                    rnd, t_res, res.valid, res.in2out, k_push),
                 lambda: ER._resolve_plain(
                    rnd, t_res, res.valid, res.in2out, k_push))):
            case[kname] = {
                "ms": time_ms(fn, reps),
                "plain_ms": time_ms(plain, plain_reps),
                "bound_ms": bytes_[kname] / HBM_BYTES_PER_S * 1e3,
                "bytes": bytes_[kname], "max_abs_err": errs[kname]}
        log("kernel case " + json.dumps(case))
        return case

    n16, e16 = 65536, 1048576
    t0 = time.perf_counter()
    g16 = TS.rmat_graph(n16, e16, seed=16, device=dev)
    ein = TS.blocked_ell_cached(g16, direction="in")
    eout = TS.blocked_ell_cached(g16, direction="out")
    TS.push_resolution_cached(g16)
    torch.cuda.synchronize()
    log(f"graph rmat_graph({n16}, {e16}, seed=16): {g16.num_edges} edges, "
        f"in-width {ein.width}, out-width {eout.width}, layouts built in "
        f"{time.perf_counter() - t0:.1f} s")
    record["graph16"] = {"n": n16, "edges": g16.num_edges,
                         "in_width": ein.width, "out_width": eout.width}
    del ein, eout
    kernel_cases("rmat16", g16, ("BFS", "WSP", "WPR"), 20, 3)
    record["kernel_cases"] = cases

    # ------------------------------------------------------------------
    # Phase 2: RM-XS counters and a small query against the path oracle.
    # ------------------------------------------------------------------
    gx = TS.rmat_graph(400, 3200, seed=11, weighted=False, device=dev)
    auto = TE.run_program(gx, progs["BFS"], engine="cuda").stats
    pull = TE.run_program(gx, progs["BFS"], engine="cuda", model="pull").stats
    got = (auto.iterations, auto.push_iters, auto.edge_work, pull.edge_work,
           auto.resolve_work)
    if got != RMXS_BFS or auto.gather_work != RMXS_BFS[4]:
        raise RuntimeError(f"RM-XS BFS counters {got} != {RMXS_BFS}")
    gxw = TS.rmat_graph(400, 3200, seed=11, weighted=True, device=dev)
    s = TE.run_program(gxw, progs["SSSP"], engine="cuda").stats
    if (s.iterations, s.edge_work) != RMXS_WSSSP:
        raise RuntimeError(f"RM-XS weighted SSSP counters "
                           f"{(s.iterations, s.edge_work)} != {RMXS_WSSSP}")
    log(f"RM-XS counters: BFS {got}, weighted SSSP "
        f"{(s.iterations, s.edge_work)} — equal to BENCH_pallas.json")
    from repro_torch.core.lang import paths_semantics
    gl = TS.line_graph(8, weighted=True, seed=2, device=dev)
    want = np.array(paths_semantics(TU.ALL_SPECS["SSSP"](), gl), np.float64)
    have = TE.run_program(gl, progs["SSSP"], engine="cuda").value
    if not np.array_equal(have.double().cpu().numpy(), want):
        raise RuntimeError(f"SSSP on a line graph {have} != oracle {want}")
    log("path oracle: SSSP on line_graph(8) equals the paths semantics")

    # ------------------------------------------------------------------
    # Phase 3: the main path.
    # ------------------------------------------------------------------
    queries = []
    profiles = {}
    out_dir = ROOT / "chiprun_out"

    def setup(label, g):
        """Layouts and validation of one graph, timed as set-up."""
        times = {}
        for what, fn in (
                ("validate", lambda: TS.validate_graph(g)),
                ("ell_in", lambda: TS.blocked_ell_cached(g, direction="in")),
                ("ell_out", lambda: TS.blocked_ell_cached(g,
                                                          direction="out")),
                ("resolution", lambda: TS.push_resolution_cached(g))):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[what] = time.perf_counter() - t0
        log(f"setup {label}: " + json.dumps(times))
        record.setdefault("setup_s", {})[label] = times

    def profiled(label, fn):
        """One warm re-run under torch.profiler: device busy time against
        the wall, and the top ops by device time (to chiprun_out/)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        ka = prof.key_averages()
        kern = [e for e in ka if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kern) / 1e3
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
        summary = {"wall_ms": wall, "device_busy_ms": busy,
                   "idle_share": max(0.0, 1.0 - busy / wall),
                   "top_device_ms": {e.key[:60]: e.self_device_time_total
                                     / 1e3 for e in top}}
        profiles[label] = summary
        log(f"profile {label}: " + json.dumps(summary))
        try:
            out_dir.mkdir(exist_ok=True)
            (out_dir / f"profile_{label.replace(' ', '_')}.txt").write_text(
                ka.table(sort_by="self_device_time_total", row_limit=30))
        except OSError:
            pass

    def run(label, g, cuda_fn, pull_fn, exact):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = cuda_fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        ref = pull_fn()
        val, want = r.value, ref.value
        if val.shape != (g.n,) or val.dtype != want.dtype:
            raise RuntimeError(f"{label}: shape/dtype {val.shape} "
                               f"{val.dtype} vs {want.shape} {want.dtype}")
        if exact:
            ok = torch.equal(bits(val), bits(want))
        else:
            ok = bool(torch.isfinite(val).all()) and \
                torch.allclose(val, want, rtol=1e-5, atol=1e-8)
        st = r.stats
        row = {"query": label, "n": g.n, "edges": g.num_edges,
               "iterations": st.iterations, "push_iters": st.push_iters,
               "pull_iters": st.pull_iters, "edge_work": st.edge_work,
               "resolve_work": st.resolve_work,
               "gather_work": st.gather_work, "wall_ms": wall,
               "pull_engine_iterations": ref.stats.iterations,
               "engine_used": st.engine_used,
               "match": ("bitwise" if exact else "allclose") if ok
               else "MISMATCH"}
        log("query " + json.dumps(row))
        if not ok or st.engine_used != "cuda":
            raise RuntimeError(f"{label}: cuda engine disagrees with the "
                               "pull engine")
        queries.append(row)

    # The main path's launch counts: set to 0 just before each graph's
    # queries, read just after, and summed.
    main_launches = dict.fromkeys(ER.LAUNCHES, 0)

    def add_launches():
        for kname, cnt in ER.LAUNCHES.items():
            main_launches[kname] += cnt

    setup("rmat16", g16)
    ER.reset_launches()
    for name in ("BFS", "SSSP", "WSP"):
        run(f"{name} rmat16", g16,
            lambda: TE.run_program(g16, progs[name], engine="cuda"),
            lambda: TE.run_program(g16, progs[name], engine="pull"), True)
    # PageRank's tolerance scales with the mean rank 1/n (the default
    # absolute 1e-6 exceeds the whole mean rank of a 2-million-vertex graph)
    n = g16.n
    run("PageRank rmat16", g16,
        lambda: TE.run_direct(g16, pagerank_kernels(n, tol=1e-4 / n),
                              engine="cuda"),
        lambda: TE.run_direct(g16, pagerank_kernels(n, tol=1e-4 / n),
                              engine="pull"), False)
    run("weighted PageRank push rmat16", g16,
        lambda: TE.run_direct(g16, weighted_pagerank_kernels(n, tol=1e-4 / n),
                              engine="cuda", model="push"),
        lambda: TE.run_direct(g16, weighted_pagerank_kernels(n, tol=1e-4 / n),
                              engine="pull"), False)
    profiled("BFS rmat16",
             lambda: TE.run_program(g16, progs["BFS"], engine="cuda"))
    profiled("weighted PageRank push rmat16",
             lambda: TE.run_direct(g16, weighted_pagerank_kernels(
                 n, tol=1e-4 / n), engine="cuda", model="push"))
    gu16 = TS.undirected(g16)
    TE.clear_graph_caches(g16)
    torch.cuda.empty_cache()
    setup("undirected rmat16", gu16)
    run("CC undirected(rmat16)", gu16,
        lambda: TE.run_program(gu16, progs["CC"], engine="cuda"),
        lambda: TE.run_program(gu16, progs["CC"], engine="pull"), True)
    add_launches()
    del gu16, g16
    TE.clear_program_caches()
    torch.cuda.empty_cache()
    nu, eu = 2 ** 21, 2 ** 25
    t0 = time.perf_counter()
    gu = TS.uniform_graph(nu, eu, seed=21, device=dev)
    log(f"graph uniform_graph({nu}, {eu}, seed=21): {gu.num_edges} edges "
        f"in {time.perf_counter() - t0:.1f} s")
    setup("uniform21", gu)
    # the kernels against their plain versions at this graph's shapes,
    # outside the main path's launch counts
    kernel_cases("uniform21", gu, ("BFS", "PR", "WPR"), 10, 1)
    torch.cuda.empty_cache()
    ER.reset_launches()
    run("BFS uniform21", gu,
        lambda: TE.run_program(gu, progs["BFS"], engine="cuda"),
        lambda: TE.run_program(gu, progs["BFS"], engine="pull"), True)
    run("PageRank uniform21", gu,
        lambda: TE.run_direct(gu, pagerank_kernels(gu.n, tol=1e-4 / gu.n),
                              engine="cuda"),
        lambda: TE.run_direct(gu, pagerank_kernels(gu.n, tol=1e-4 / gu.n),
                              engine="pull"), False)
    profiled("BFS uniform21",
             lambda: TE.run_program(gu, progs["BFS"], engine="cuda"))
    add_launches()
    launches = main_launches
    log(f"main-path launches: {json.dumps(launches)}")
    for kname, cnt in launches.items():
        if cnt <= 0:
            raise RuntimeError(f"the {kname} kernel never launched on the "
                               "main path")
    record["queries"] = queries
    record["launches"] = launches
    record["profiles"] = profiles
    record["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # the contract's kernel line: times of the weighted-PageRank round with
    # every source active (the push− main path's shapes)
    ref_case = [c for c in cases if c["graph"] == "rmat16"
                and c["round"] == "WPR" and c["density"] == 1.0][0]
    kernels = []
    for kname in ("pull", "push", "resolve"):
        c = ref_case[kname]
        kernels.append({
            "name": f"{kname}_kernel", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES[kname],
            "launches": launches[kname], "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "case": "weighted PageRank round, all sources active, "
                    f"rmat_graph({n16}, {e16}, seed=16)"})
    record["kernels"] = kernels
    try:
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke.json").write_text(json.dumps(record,
                                                            indent=1))
    except OSError:
        pass
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
