#!/usr/bin/env python3
"""Where a batched sweep's time goes (needs a CUDA card).

    PYTHONPATH=src python benchmarks/torch_batch_probe.py [--out FILE]

Times each sweep kernel of ``repro_torch.kernels.edge_reduce`` (the pull
sweep with derived and with given activity, the push sweep, the sorted
resolution) on ``rmat_graph(65536, 1048576, seed=16)`` and
``uniform_graph(2**21, 2**25, seed=21)``, for the BFS and weighted
PageRank rounds of ``chip_smoke.py`` with every source active, at B = 2, 4
and 8 query slots (each with its own random states, a quarter ⊥):

- ``solo``: B solo launches, one per slot;
- ``tile``: one batched launch, items tile-major;
- ``slot``: one batched launch, items slot-major;
- ``shared``: one batched launch, tile-major, in which every slot reads
  slot 0's states, frontier, activities and candidates (slot stride 0,
  through the C entry point): the same instructions and layout bytes as
  ``tile`` without the B sets of gathered words, so ``tile`` against
  ``shared`` is what the slots' own gathered words cost, and ``shared``
  against ``solo`` what the batched instructions and the shared layout
  do.

Each line also gives the batched kernels' registers and grids.  Nothing
is compared for correctness (``chip_smoke.py`` and the ``gpu`` tests hold
the kernels).  Device time is the median over CUDA events, the card first
sleeping ~2 ms so that the launches queue behind it; the card's name and
power limit go beside the numbers.  The package is whatever
``repro_torch`` the path gives, so the same script times two checkouts.

With ``--end-to-end`` it times whole batches instead, as smoke phase 7
runs them (``run_program_batch`` of 8 seeded sources, warm, the host's
clock around the call): BFS, SSSP push, SSSP pull and NSP on rmat16, BFS
on uniform21, each with the batched kernels and with every batched sweep
replaced by one solo launch per slot into that slot's rows of the same
outputs (the resolution's per-slot outputs stacked), inside the same
loop with one host read per iteration.  Both answers must agree bitwise.
Then the first query's wall (BFS rmat16, executor and plan caches
cleared, layouts kept) with and without ``torch.cuda.empty_cache()``
just before it, alternated, with the allocator's device allocations
counted.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

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


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the lines here")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--end-to-end", action="store_true",
                    help="time whole batches: batched kernels against "
                         "solo launches per slot, and first queries")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_batch_probe.py needs a CUDA card")
    torch.utils.deterministic.fill_uninitialized_memory = False
    if args.end_to_end:
        return end_to_end(args)
    from repro_torch.core import engine
    from repro_torch.core import fusion as TF
    from repro_torch.core import usecases as TU
    from repro_torch.core.fusion import Prim
    from repro_torch.core.iterate import DTYPES, CompRuntime, comp_runtimes
    from repro_torch.core.synthesis import (synthesize_round,
                                            weighted_pagerank_kernels)
    from repro_torch.graph import structure as TS
    from repro_torch.kernels import edge_reduce as ER
    from repro_torch.kernels import ops as KO
    from repro_torch.kernels.launch import stream

    dev = torch.device("cuda")
    line_card = card()
    lines = []

    def emit(row):
        row["card"] = line_card
        print(json.dumps(row), flush=True)
        lines.append(row)

    def round_of(name, n):
        if name == "WPR":
            dk = weighted_pagerank_kernels(n)
            comp = CompRuntime(0, dk.rop, DTYPES[dk.dtype], dk.p_fn,
                               dk.init_fn, None, dk.e_fn, p_expr=dk.p_expr)
            return KO.sweep_round([comp], [Prim("sum", 0)])
        (r,) = [r for _n, r in TF.fuse(TU.ALL_SPECS[name]()).rounds
                if r.leaves]
        return KO.sweep_round(comp_runtimes(r, synthesize_round(r)),
                              [leaf.plan for leaf in r.leaves])

    def probe(label, g):
        ein = TS.blocked_ell_cached(g, direction="in")
        eout = TS.blocked_ell_cached(g, direction="out")
        res = TS.push_resolution_cached(g)
        n_pad = ein.n_pad
        od = torch.ones(n_pad, device=dev)
        od[:g.n] = g.out_deg.clamp(min=1).float()
        wd = torch.ones(n_pad, device=dev)
        wd[:g.n] = TS.w_out_deg(g)
        nv = float(g.n)
        lay_in = (ein.nbrs, ein.weight, ein.capacity, ein.mask)
        lay_out = (eout.nbrs, eout.weight, eout.capacity, eout.mask)
        for rname in ("BFS", "WPR"):
            rnd = round_of(rname, g.n)
            lib = rnd.library()
            walk = rnd.walk_attributes()
            rng = np.random.default_rng(5)
            bmax = 8
            act = torch.zeros((bmax, n_pad), dtype=torch.int32, device=dev)
            act[:, :g.n] = 1
            st = []
            for dt, ident in zip(rnd.dtypes, rnd.idents):
                v = rng.uniform(0.5, 9.0, (bmax, n_pad)).astype(np.float32) \
                    if dt == torch.float32 else \
                    rng.integers(0, 50, (bmax, n_pad)).astype(np.int32)
                v[rng.random((bmax, n_pad)) < 0.25] = ident
                st.append(torch.from_numpy(v).to(dev))
            t_in = ER.tile_activity(ein.nbrs, ein.mask, ein.tile_nnz, act)
            t_out = ER.tile_activity_push(eout.tile_nnz, act)
            t_res = ER.resolution_tile_activity(res.contrib, t_out,
                                                res.tile_nnz)
            hp = rname == "WPR"
            cands = ER.push_sweep(rnd, t_out, *lay_out, act, od, wd, st, nv)
            for b in (2, 4, 8):
                a, s_b = act[:b], [x[:b] for x in st]
                ti, to, tr = t_in[:b], t_out[:b], t_res[:b]
                cb = [c[:b] for c in cands]
                kernels = {
                    "pull": (
                        lambda a=a, s_b=s_b: ER.pull_sweep_frontier(
                            rnd, ein.tiles_static, *lay_in, a, od, wd, s_b,
                            nv),
                        lambda s: ER.pull_sweep_frontier(
                            rnd, ein.tiles_static, *lay_in, act[s], od, wd,
                            [x[s] for x in st], nv)),
                    "pull_given": (
                        lambda a=a, s_b=s_b, ti=ti: ER.pull_sweep(
                            rnd, ti, *lay_in, a, od, wd, s_b, nv),
                        lambda s: ER.pull_sweep(
                            rnd, t_in[s], *lay_in, act[s], od, wd,
                            [x[s] for x in st], nv)),
                    "push": (
                        lambda a=a, s_b=s_b, to=to, cb=cb: ER.push_sweep(
                            rnd, to, *lay_out, a, od, wd, s_b, nv, out=cb),
                        lambda s: ER.push_sweep(
                            rnd, t_out[s], *lay_out, act[s], od, wd,
                            [x[s] for x in st], nv,
                            out=[c[s] for c in cands])),
                    "resolve": (
                        lambda s_b=s_b, to=to, tr=tr, cb=cb: ER.resolve_sweep(
                            rnd, tr, res.valid, res.in2out, cb, to,
                            eout.width, s_b, hp),
                        lambda s: ER.resolve_sweep(
                            rnd, t_res[s], res.valid, res.in2out,
                            [c[s] for c in cands], t_out[s], eout.width,
                            [x[s] for x in st], hp)),
                }
                shared = shared_launches(ER, lib, rnd, b, ein, eout, res,
                                         act[0], [x[0] for x in st],
                                         t_in[0], t_out[0], t_res[0],
                                         [c[0] for c in cands], cb, od, wd,
                                         nv, hp, stream)
                for kname, (batched, solo) in kernels.items():
                    row = {"graph": label, "round": rname, "slots": b,
                           "kernel": kname}
                    row["solo_ms"] = time_ms(
                        lambda: [solo(s) for s in range(b)], args.reps)
                    for order in ("tile", "slot"):
                        ER._SLOT_ORDER = order
                        row[f"{order}_ms"] = time_ms(batched, args.reps)
                    ER._SLOT_ORDER = None
                    row["shared_ms"] = time_ms(shared[kname], args.reps)
                    key = {"pull": "pull_derived",
                           "pull_given": "pull"}.get(kname, kname)
                    row["registers"] = walk[f"batched_{key}_registers"]
                    row["grid"] = walk[f"batched_{key}_grid"]
                    row["solo_registers"] = walk[f"{key}_registers"]
                    emit(row)
            del cands
            torch.cuda.empty_cache()

    n16, e16 = 65536, 1048576
    probe("rmat16", TS.rmat_graph(n16, e16, seed=16, device=dev))
    engine.clear_program_caches()
    torch.cuda.empty_cache()
    probe("uniform21", TS.uniform_graph(2 ** 21, 2 ** 25, seed=21,
                                        device=dev))
    write_lines(args.out, lines)
    return 0


def write_lines(path, lines):
    if path:
        with open(path, "w") as f:
            for row in lines:
                f.write(json.dumps(row) + "\n")


def per_slot_sweeps(ER):
    """Replacements for the four batched sweep wrappers of ``ER`` that run
    a batch as one solo launch per slot, each into its slot's rows of the
    batched outputs (pointer offsets, no kernel change); the resolution,
    which allocates its outputs, stacks its slots' instead."""
    orig = {k: getattr(ER, k) for k in ("pull_sweep", "pull_sweep_frontier",
                                        "push_sweep", "resolve_sweep")}

    def pull_outs(rnd, srcs, states, need_hp, derive):
        n_s, (n_pad, width) = states[0].shape[0], srcs.shape
        n_j = width // ER.BLOCK_E
        dts = [rnd.dtypes[pos] for spec in rnd.plan_specs
               for pos, _op in spec] + [torch.int32] * (len(states) * need_hp)
        out = [torch.empty((n_s, n_pad, n_j), dtype=dt, device=srcs.device)
               for dt in dts]
        if derive:
            out.append(torch.empty((n_s, n_pad // ER.BLOCK_V, n_j),
                                   dtype=torch.int32, device=srcs.device))
        return out

    def pull(derive):
        name = "pull_sweep_frontier" if derive else "pull_sweep"

        def run(rnd, tiles, srcs, weight, capacity, mask, active, outdeg,
                wdeg, states, nv, need_hp=False, out=None):
            if not ER._lead(states):
                return orig[name](rnd, tiles, srcs, weight, capacity, mask,
                                  active, outdeg, wdeg, states, nv, need_hp,
                                  out)
            if out is None:
                out = pull_outs(rnd, srcs, states, need_hp, derive)
            for s in range(states[0].shape[0]):
                orig[name](rnd, tiles if derive else ER._slot(tiles, 2, s),
                           srcs, weight, capacity, mask,
                           ER._slot(active, 1, s), outdeg, wdeg,
                           [x[s] for x in states], nv, need_hp,
                           out=[o[s] for o in out])
            return (out[:-1], out[-1]) if derive else out
        return run

    def push(rnd, tile_act, dsts, weight, capacity, mask, active, outdeg,
             wdeg, states, nv, out=None):
        if not ER._lead(states):
            return orig["push_sweep"](rnd, tile_act, dsts, weight, capacity,
                                      mask, active, outdeg, wdeg, states, nv,
                                      out=out)
        n_s = states[0].shape[0]
        if out is None:
            out = [torch.empty((n_s,) + tuple(dsts.shape), dtype=dt,
                               device=dsts.device) for dt in rnd.dtypes]
        for s in range(n_s):
            orig["push_sweep"](rnd, ER._slot(tile_act, 2, s), dsts, weight,
                               capacity, mask, ER._slot(active, 1, s),
                               outdeg, wdeg, [x[s] for x in states], nv,
                               out=[o[s] for o in out])
        return out

    def resolve(rnd, tile_act, valid, in2out, cands, push_tile_act,
                width_out, states=(), need_hp=False):
        if cands[0].dim() == 2:
            return orig["resolve_sweep"](rnd, tile_act, valid, in2out, cands,
                                         push_tile_act, width_out, states,
                                         need_hp)
        per = [orig["resolve_sweep"](
            rnd, ER._slot(tile_act, 2, s), valid, in2out,
            [c[s] for c in cands], ER._slot(push_tile_act, 2, s), width_out,
            [x[s] for x in states] if need_hp else (), need_hp)
            for s in range(cands[0].shape[0])]
        return [torch.stack(cols) for cols in zip(*per)]

    return orig, {"pull_sweep": pull(False), "pull_sweep_frontier": pull(True),
                  "push_sweep": push, "resolve_sweep": resolve}


def end_to_end(args) -> int:
    """Whole batches with batched kernels against one solo launch per slot,
    then first queries with and without an emptied allocator cache."""
    from repro_torch.core import engine as TE
    from repro_torch.core import fusion as TF
    from repro_torch.core import plan as TP
    from repro_torch.core import synthesis
    from repro_torch.core import usecases as TU
    from repro_torch.graph import structure as TS
    from repro_torch.kernels import edge_reduce as ER
    from repro_torch.kernels import ops as KO

    dev = torch.device("cuda")
    line_card = card()
    lines = []

    def emit(row):
        row["card"] = line_card
        print(json.dumps(row), flush=True)
        lines.append(row)

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def bits(t):
        return t.contiguous().view(torch.uint8)

    progs = {name: TF.fuse(TU.ALL_SPECS[name]())
             for name in ("BFS", "SSSP", "NSP")}
    orig, solo = per_slot_sweeps(ER)

    def batches(label, g, seed, cases):
        for name in ("BFS", "SSSP"):        # layouts and builds, untimed
            TE.run_program(g, progs[name], engine="cuda")
        rng = np.random.default_rng(seed)
        cand = np.flatnonzero(g.out_deg.cpu().numpy() > 0)
        srcs = [int(s) for s in rng.choice(cand, 8, replace=False)]
        for name, model in cases:
            row = {"graph": label, "query": name, "model": model,
                   "slots": len(srcs)}
            answers = {}
            for mode in ("batched", "per_slot", "per_slot", "batched"):
                for k, fn in (solo if mode == "per_slot" else orig).items():
                    setattr(ER, k, fn)
                run = lambda: TE.run_program_batch(      # noqa: E731
                    g, progs[name], srcs, model=model)
                res, _first = wall_ms(run)
                ER.reset_launches()
                walls = [wall_ms(run)[1] for _ in range(args.reps)]
                row.setdefault(f"{mode}_ms", []).append(
                    statistics.median(walls))
                row[f"{mode}_launches"] = {
                    k: v // args.reps for k, v in ER.LAUNCHES.items()
                    if k != "level"}
                row["iterations"] = [r.stats.iterations for r in res]
                answers.setdefault(mode, [bits(r.value) for r in res])
                del res
            for k, fn in orig.items():
                setattr(ER, k, fn)
            row["bitwise"] = all(torch.equal(a, b) for a, b in zip(
                answers["batched"], answers["per_slot"]))
            emit(row)
            if not row["bitwise"]:
                raise RuntimeError(f"{label} {name}: per-slot launches "
                                   "disagree with the batched ones")
            del answers
            torch.cuda.empty_cache()

    def first_queries(label, g, reps=4):
        prog = progs["BFS"]
        TE.run_program(g, prog, engine="cuda")
        for rep in range(reps):
            for emptied in (False, True):
                synthesis._ROUND_CACHE.clear()
                TP.clear_plan_caches()
                KO.clear_executor_cache()
                if emptied:
                    torch.cuda.empty_cache()
                before = torch.cuda.memory_stats().get("num_device_alloc", 0)
                _r, wall = wall_ms(lambda: TE.run_program(g, prog,
                                                          engine="cuda"))
                emit({"first_query": f"BFS {label}", "rep": rep,
                      "emptied_cache": emptied, "wall_ms": wall,
                      "device_allocs": torch.cuda.memory_stats().get(
                          "num_device_alloc", 0) - before})

    g16 = TS.rmat_graph(65536, 1048576, seed=16, device=dev)
    batches("rmat16", g16, 7, (("BFS", None), ("SSSP", "push"),
                               ("SSSP", "pull"), ("NSP", None)))
    first_queries("rmat16", g16)
    del g16
    TE.clear_program_caches()
    torch.cuda.empty_cache()
    gu = TS.uniform_graph(2 ** 21, 2 ** 25, seed=21, device=dev)
    batches("uniform21", gu, 21, (("BFS", None),))
    write_lines(args.out, lines)
    return 0


def shared_launches(ER, lib, rnd, b, ein, eout, res, act, st, t_in, t_out,
                    t_res, cands, push_out, od, wd, nv, hp, stream):
    """Batched launches whose slots all read slot 0's per-slot inputs
    (slot stride 0) and write their own outputs (the push sweep into
    ``push_out``, b slots), through the C entry points (tile-major)."""
    import ctypes
    n_pad, width = ein.nbrs.shape
    n_i, n_j = n_pad // ER.BLOCK_V, width // ER.BLOCK_E
    dtypes = [rnd.dtypes[pos] for spec in rnd.plan_specs
              for pos, _op in spec]

    def outs(shape, n_hp=0):
        return [torch.empty((b,) + shape, dtype=dt, device=act.device)
                for dt in dtypes] + \
            [torch.empty((b,) + shape, dtype=torch.int32, device=act.device)
             for _ in range(n_hp)]

    def strides(out, act_out=0):
        s = (ctypes.c_longlong * 7)()
        s[1], s[4] = act_out, out
        return s

    pull_out = outs((n_pad, n_j))
    pull_act = torch.empty((b, n_i, n_j), dtype=torch.int32,
                           device=act.device)
    n_po, w_o = eout.nbrs.shape
    n_r, w_r = res.valid.shape
    res_out = outs((n_pad, w_r // ER.BLOCK_E), len(rnd.dtypes) if hp else 0)
    ptrs = ER._ptrs

    def pull(derive):
        def run():
            lib.grafs_pull(
                (ein.tiles_static if derive else t_in).data_ptr(),
                pull_act.data_ptr() if derive else None,
                ein.nbrs.data_ptr(), ein.weight.data_ptr(),
                ein.capacity.data_ptr(), ein.mask.data_ptr(),
                act.data_ptr(), od.data_ptr(), wd.data_ptr(), ptrs(st),
                ptrs(pull_out), n_i * n_j, n_j, width, nv, 0, b, 0,
                strides(n_pad * n_j, n_i * n_j), stream(act))
        return run

    def push():
        lib.grafs_push(
            t_out.data_ptr(), eout.nbrs.data_ptr(), eout.weight.data_ptr(),
            eout.capacity.data_ptr(), eout.mask.data_ptr(), act.data_ptr(),
            od.data_ptr(), wd.data_ptr(), ptrs(st), ptrs(push_out),
            (n_po // ER.BLOCK_V) * (w_o // ER.BLOCK_E), w_o // ER.BLOCK_E,
            w_o, nv, b, 0, strides(n_po * w_o), stream(act))

    def resolve():
        lib.grafs_resolve(
            t_res.data_ptr(), res.valid.data_ptr(), res.in2out.data_ptr(),
            t_out.data_ptr(), ptrs(cands), ptrs(st if hp else ()),
            ptrs(res_out), (n_r // ER.BLOCK_V) * (w_r // ER.BLOCK_E),
            w_r // ER.BLOCK_E, w_r, w_o, int(hp), b, 0,
            strides(n_pad * (w_r // ER.BLOCK_E)), stream(act))

    return {"pull": pull(True), "pull_given": pull(False), "push": push,
            "resolve": resolve}


if __name__ == "__main__":
    raise SystemExit(main())
