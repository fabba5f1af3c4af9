"""Dry-run of the PAPER'S OWN workload at production scale: one fused
GraFS fixpoint (the WSP lexicographic plan, FPNEST's output) over an
ogb_products-scale edge set, vertex-cut into the 256 or 512 shards of the
reference's (16, 16) and (2, 16, 16) meshes.

    PYTHONPATH=src python -m repro_torch.launch.analytics_dryrun [--multi-pod]

The reference lowers and compiles its ``shard_map`` step for TPU meshes
it does not have.  The port builds the same step (``build_step``) over a
``ShardMesh`` whose shards lie on the ``meta`` device, reckons the
record's keys from shapes (``launch.dryrun``) and writes
``reports/dryrun_torch/<mesh>/grafs-analytics__ogb_scale.json`` in the
reference's format.  Given real tensors, the same step runs for real:
one H100 holds every shard of an ogb_products-sized graph.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import fusion, iterate
from repro_torch.core import usecases as U
from repro_torch.core.kernel_lang import expr_vars
from repro_torch.core.synthesis import synthesize_round
from repro_torch.graph.partition import ShardMesh
from repro_torch.launch.dryrun import (Reckoner, _mesh_tag, plan_collectives,
                                       write_record)
from repro_torch.launch.mesh import make_production_mesh, mesh_devices

# ogb_products (configs' GNN shape ``ogb_products``)
OGB_N, OGB_E = 2_449_029, 61_859_140
RECORD_NAME = "grafs-analytics__ogb_scale"
# The step's arguments, in order, and the P variable each edge input is.
ARG_NAMES = ("src", "dst", "w", "c", "mask", "out_deg")
_P_VARS = {"w": "w", "c": "c", "out_deg": "outdeg"}


def _wsp_round():
    """The fused WSP(0) round's component runtimes and plans."""
    round_ = fusion.fuse(U.wsp(0)).rounds[0][1]
    comps = iterate.comp_runtimes(round_, synthesize_round(round_))
    return comps, [leaf.plan for leaf in round_.leaves]


def _shard_env(src, dst, w, c, out_deg, n):
    """The reference step's P environment: ``outdeg`` the raw int32
    out-degree of each edge's source, no ``wdeg``."""
    return {"w": w, "c": c, "esrc": src, "edst": dst,
            "outdeg": out_deg[src.long()],
            "nv": torch.tensor(float(n), dtype=torch.float32,
                               device=src.device)}


class WspStep:
    """The port of the reference's ``shard_fn``: per iteration each shard
    evaluates P on its edge block, masks it to the edges whose source is
    active, segment-reduces it to ``[n]`` partials plan by plan; the
    partials fold across shards one lex level at a time
    (``iterate.cross_shard``) and ``plan_merge`` takes the new state.  All
    vertices start active; the loop stops when nothing changed or at
    ``max_iter``.  The state lives on ``mesh.devices[0]``, shard j runs on
    ``mesh.devices[j]``."""

    def __init__(self, mesh, n: int, e: int, max_iter: int = 64):
        self.mesh, self.n, self.e, self.max_iter = mesh, n, e, max_iter
        self.k = mesh_devices(mesh)
        self.e_loc = -(-e // self.k)
        self.comps, self.plans = _wsp_round()
        self.comps_by_idx = {cr.idx: cr for cr in self.comps}

    def shards(self, src, dst, w, c, mask, out_deg) -> list:
        """Shard j's ``(device, src, dst, mask, env)``: the j-th
        ``e_loc``-edge block of each flat array, on ``mesh.devices[j]``."""
        want = self.k * self.e_loc
        for name, a in zip(ARG_NAMES[:5], (src, dst, w, c, mask)):
            if a.shape != (want,):
                raise ValueError(f"{name} has shape {tuple(a.shape)}, the "
                                 f"step takes ({want},) = k {self.k} × "
                                 f"{self.e_loc} edges")
        if out_deg.shape != (self.n,):
            raise ValueError(f"out_deg has shape {tuple(out_deg.shape)}, "
                             f"the step takes ({self.n},)")
        blocks = [a.view(self.k, self.e_loc)
                  for a in (src, dst, w, c, mask)]
        out = []
        for j, d in enumerate(self.mesh.devices):
            s, t, wj, cj, m = (b[j].to(d) for b in blocks)
            out.append((d, s, t, m,
                        _shard_env(s, t, wj, cj, out_deg.to(d), self.n)))
        return out

    def iteration(self, shards, state, active, mesh, work=None):
        """One iteration of the fixpoint over ``shards`` (folded over
        ``mesh``): ``(new state, changed)``.  With ``work`` (a list of
        per-shard edge counts), each shard adds its active edges."""
        comps, cbi, n = self.comps, self.comps_by_idx, self.n
        state_d = {cr.idx: state[i] for i, cr in enumerate(comps)}
        reds = {}
        for j, (d, src, dst, mask, env) in enumerate(shards):
            st = tuple(s.to(d) for s in state)
            evals = iterate._propagate(comps, st, src, env)
            eactive = active.to(d)[src.long()] & mask
            if work is not None:
                work[j] = work[j] + eactive.sum()
            masked = {i: torch.where(eactive, evals[i],
                                     iterate._ident(cbi[i]))
                      for i in evals}
            for p in self.plans:
                for c, v in iterate.plan_segment_reduce(
                        p, masked, dst, n, cbi).items():
                    reds.setdefault(c, []).append(v)
        red = {c: v[0] for c, v in
               iterate.cross_shard(self.plans, reds, mesh, cbi).items()}
        new_d = {}
        for p in self.plans:
            new_d.update(iterate.plan_merge(p, state_d, red, cbi))
        new = tuple(new_d[cr.idx] for cr in comps)
        return new, iterate._changed(comps, new, state, 0.0)

    def __call__(self, src, dst, w, c, mask, out_deg, shard_work=None):
        """Run the fixpoint: ``(state, iterations)``, the state a tuple of
        ``[n]`` tensors on ``mesh.devices[0]``.  A list passed as
        ``shard_work`` receives each shard's edge work (active edges
        summed over the iterations)."""
        shards = self.shards(src, dst, w, c, mask, out_deg)
        dev0 = self.mesh.devices[0]
        work = None if shard_work is None else \
            [torch.zeros((), dtype=torch.int64, device=d)
             for d in self.mesh.devices]
        state = iterate._init_state(self.comps, self.n, device=dev0)
        active = torch.ones(self.n, dtype=torch.bool, device=dev0)
        it = 0
        while it < self.max_iter and bool(active.any()):
            state, active = self.iteration(shards, state, active, self.mesh,
                                           work)
            it += 1
        if shard_work is not None:
            shard_work[:] = torch.stack([x.to(dev0) for x in work]).tolist()
        return state, it

    def reads(self) -> tuple:
        """The arguments the step reads: ``src``, ``dst``, ``mask`` and
        the inputs some component's P names (``kernel_lang.expr_vars``)."""
        names = frozenset().union(*(expr_vars(cr.p_expr)
                                    for cr in self.comps))
        return tuple(a for a in ARG_NAMES
                     if a not in _P_VARS or _P_VARS[a] in names)

    def reckon(self, args) -> Reckoner:
        """One iteration as one device runs it, on the ``meta`` arguments
        of ``build_step``: shard 0's block, the replicated state and the
        loop's test, the cross-shard fold left out (it is the
        collective)."""
        one = ShardMesh.on("meta", 1)
        src, dst, w, c, mask = (a[:self.e_loc] for a in args[:5])
        shard = [(one.devices[0], src, dst, mask,
                  _shard_env(src, dst, w, c, args[5], self.n))]
        state = iterate._init_state(self.comps, self.n, device="meta")
        active = torch.empty(self.n, dtype=torch.bool, device="meta")
        with Reckoner() as rk:
            active.any()
            self.iteration(shard, state, active, one)
        return rk

def build_step(mesh, n: int, e: int, max_iter: int = 64):
    """One fused WSP (lex min-length → max-capacity) fixpoint over the
    shards of ``mesh`` (a ``ShardMesh``): ``(fn, args)``, ``fn`` a
    ``WspStep`` and ``args`` its six arguments as ``meta`` tensors of the
    reference's shapes and dtypes (``[k·⌈e/k⌉]`` edge arrays, ``[n]``
    out-degrees), so nothing is allocated."""
    fn = WspStep(mesh, n, e, max_iter)
    flat = fn.k * fn.e_loc
    args = tuple(torch.empty(size, dtype=dt, device="meta") for size, dt in (
        (flat, torch.int32), (flat, torch.int32), (flat, torch.float32),
        (flat, torch.float32), (flat, torch.bool), (n, torch.int32)))
    return fn, args


def build_record(mesh, n: int, e: int, tag: str) -> dict:
    """The dry-run record of the step over ``mesh`` at (n, e), with the
    reference's keys.  Per device: ``argument_size_in_bytes`` the edge
    blocks (and replicated inputs) the step reads; ``output_size_in_bytes``
    the state plus the 4-byte iteration counter; ``temp_size_in_bytes``,
    ``cost_analysis`` the ``Reckoner``'s peak bytes, operations and bytes
    of one iteration; ``analysis_cost`` the latter over all devices;
    ``compile_s`` the seconds to build and reckon the step."""
    t0 = time.perf_counter()
    fn, args = build_step(mesh, n, e)
    rk = fn.reckon(args)
    build_s = time.perf_counter() - t0
    devices = mesh_devices(mesh)
    read = fn.reads()
    arg_bytes = 0
    for name, a in zip(ARG_NAMES, args):
        if name in read:
            per_device = n if name == "out_deg" else fn.e_loc
            arg_bytes += per_device * a.element_size()
    out_bytes = sum(n * cr.dtype.itemsize for cr in fn.comps) + 4
    cost = {"flops": float(rk.flops), "bytes accessed": float(rk.bytes)}
    coll, top = plan_collectives(fn.plans, fn.comps, n, devices,
                                 "analytics_dryrun.WspStep.iteration")
    return {"arch": "grafs-analytics", "shape": "ogb_scale", "mesh": tag,
            "status": "ok", "kind": "analytics", "devices": devices,
            "compile_s": round(build_s, 2),
            "meta": {"n": n, "e": e,
                     # per fixpoint iteration: each edge does P + R
                     "model_flops": 4.0 * e},
            "memory_analysis": {
                "argument_size_in_bytes": arg_bytes,
                "output_size_in_bytes": out_bytes,
                "temp_size_in_bytes": rk.peak_bytes,
                "alias_size_in_bytes": 0,
                "generated_code_size_in_bytes": 0},
            "cost_analysis": cost,
            "analysis_cost": {k: v * devices for k, v in cost.items()},
            "collectives": coll, "collective_top_ops": top}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--n", type=int, default=OGB_N)    # ogb_products
    ap.add_argument("--e", type=int, default=OGB_E)
    ap.add_argument("--out", default="reports/dryrun_torch")
    args = ap.parse_args(argv)

    tag = _mesh_tag(args.multi_pod)
    mesh = make_production_mesh(multi_pod=args.multi_pod, device="meta")
    rec = build_record(mesh, args.n, args.e, tag)
    write_record(rec, args.out, RECORD_NAME)
    coll = sum(v["operand_bytes"] for v in rec["collectives"].values())
    print(f"[analytics:{tag}] ok build={rec['compile_s']}s "
          f"mem={rec['memory_analysis']} coll/chip={coll / 1e9:.2f}GB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
