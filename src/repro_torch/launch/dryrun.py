"""The dry-run of the port: its records, their collectives, their cost
reckoned from the step's torch ops, and the writer.

    PYTHONPATH=src python -m repro_torch.launch.dryrun            # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list

The reference lowers and compiles a step for the production meshes and
reads the record off XLA: ``memory_analysis``, ``cost_analysis`` and the
collectives parsed from the compiled HLO.  torch compiles nothing ahead of
a call, so the port runs the step on ``meta`` tensors (nothing is
allocated; no card is needed) and reckons the same keys from shapes:

- ``run_cell`` / ``main``: one record per (architecture × shape) cell on
  the (16, 16) or (2, 16, 16) mesh, written to
  ``<out>/<mesh>/<arch>__<shape>.json`` (``--out`` defaults to
  ``reports/dryrun_torch``).  ``memory_analysis`` splits the abstract
  arguments', the outputs' and the ``Reckoner``'s peak bytes evenly over
  the mesh's devices (``"per_device": "even_split"``, a lower bound: the
  reference replicates its small leaves); ``cost_analysis`` is the
  production step's reckoning split the same way, ``analysis_cost`` the
  ``analysis=True`` build's over all devices; no collectives are
  reckoned for these cells (``"collectives_reckoned": false``);
  ``lower_s`` is the seconds to build the workload, ``compile_s`` to
  reckon both builds, ``hlo_bytes`` 0;
- ``plan_collectives`` (the analytics step, ``launch.analytics_dryrun``):
  one all-reduce per lex level of every plan per iteration
  (``iterate.cross_shard`` folds the level's ``[n]`` partials once), its
  operand the level's state, trips 1 (the fixpoint loop is dynamic, as
  the reference's ``_trip_count`` gives);
- ``Reckoner``: adds up the aten ops a step dispatches (see its docstring
  for the rules).
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch.configs as configs
from repro_torch.core.fusion import Lex
from repro_torch.launch.mesh import mesh_devices, model_mesh
from repro_torch.launch.workloads import all_cells, build_workload

COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")

# HLO's names of the element types, for ``result_shape``.
HLO_TYPES = {torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
             torch.int16: "s16", torch.float16: "f16",
             torch.bfloat16: "bf16", torch.int32: "s32",
             torch.float32: "f32", torch.int64: "s64",
             torch.float64: "f64"}


def _mesh_tag(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def _plan_levels(plan):
    """The components of a plan's lex levels, primary first."""
    yield plan.comp
    if isinstance(plan, Lex):
        yield from _plan_levels(plan.secondary)


def plan_collectives(plans, comps, n: int, devices: int, comp: str):
    """``(collectives, collective_top_ops)`` of one iteration of a sharded
    fixpoint over ``plans``: an all-reduce of each lex level's ``[n]``
    state, trips 1, none on a single device.  The same dict and list as
    the reference's ``collective_bytes``; ``comp`` names the function."""
    dtype = {cr.idx: cr.dtype for cr in comps}
    out = {k: {"count": 0, "operand_bytes": 0} for k in COLL_KINDS}
    top = []
    if devices > 1:
        for p in plans:
            for c in _plan_levels(p):
                nbytes = n * dtype[c].itemsize
                out["all-reduce"]["count"] += 1
                out["all-reduce"]["operand_bytes"] += nbytes
                top.append((nbytes, "all-reduce", 1,
                            f"{HLO_TYPES[dtype[c]]}[{n}]", comp))
    top.sort(reverse=True)
    return out, [{"bytes": b, "kind": k, "trips": m, "result_shape": s,
                  "comp": c} for b, k, m, s, c in top[:12]]


# Ops that move or make data but compute nothing: no operations counted.
_MOVES = frozenset((
    "index", "clone", "copy", "_to_copy", "full", "full_like", "fill",
    "empty", "empty_like", "zeros", "zeros_like", "ones", "ones_like",
    "arange", "lift_fresh", "lift_fresh_copy", "scalar_tensor", "alias",
    "detach"))
# Ops that return a view of their input, though aten does not mark them as
# views: counted as views (no operations, no bytes, nothing fresh).
_RESHAPES = frozenset(("_unsafe_view",))
# Ops whose operations are one per scattered element (their ``src``).
_SCATTERS = frozenset(("scatter", "scatter_add", "scatter_reduce",
                       "index_add", "index_put", "index_reduce"))
# Matrix products: 2·M·N·K operations (times the batch), K the first
# factor's last dimension; the argument position of that factor.
_PRODUCTS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1}


class Reckoner(TorchDispatchMode):
    """Counts the aten ops run under it (on ``meta`` tensors, so nothing
    is allocated or computed):

    - ``flops``: a matrix product (``mm``, ``bmm``, ``addmm``,
      ``baddbmm``) 2·M·N·K, times the batch of a batched one; every other
      op one operation per element of its widest tensor (operand or
      result); a scatter one per scattered element; none for views and
      for ops that only move or make data (gathers, copies, casts,
      fills);
    - ``bytes``: each op's tensor operands read once and its results
      written once, views (and ``_unsafe_view``, a reshape) excluded:
      every op's traffic as if it ran alone (nothing fused);
    - ``peak_bytes``: the most bytes that tensors made under the mode
      held at once (freed when Python drops them);
    - ``ops``: how often each op ran.

    A functional op on ``meta`` tensors (no view, nothing written in
    place) runs its meta kernel once per distinct call: the result's
    shapes, strides and dtypes are kept under the call's key (the op, its
    tensors' shapes, strides and dtypes, its other arguments) and a repeat
    returns fresh ``meta`` tensors of them.  A model's layers repeat the
    same calls, and most meta kernels are Python decompositions, so this
    is most of a large step's reckoning time; the counts are the same."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak_bytes = 0
        self.ops = collections.Counter()
        self._shapes = {}

    def _free(self, nbytes):
        self.live -= nbytes

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``, from the shape cache where it may."""
        if func.is_view or any(r.alias_info is not None
                               for r in func._schema.returns):
            return func(*args, **kwargs)
        try:
            key = (func, _signature(args), _signature(kwargs))
        except _Uncached:
            return func(*args, **kwargs)
        hit = self._shapes.get(key)
        if hit is not None:
            outs = [torch.empty_strided(size, stride, dtype=dt,
                                        device="meta")
                    for size, stride, dt in hit[1]]
            return outs[0] if hit[0] else hit[2](outs)
        out = func(*args, **kwargs)
        single = isinstance(out, torch.Tensor)
        outs = [out] if single else out
        if isinstance(outs, (tuple, list)) and all(
                isinstance(t, torch.Tensor) for t in outs):
            self._shapes[key] = (single, [(tuple(t.shape), t.stride(),
                                           t.dtype) for t in outs],
                                 type(out))
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        name = func.overloadpacket.__name__
        base = name.rstrip("_")
        self.ops[name] += 1
        if func.is_view or name in _RESHAPES:
            return out
        ins = [t for t in _leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in _leaves(out) if isinstance(t, torch.Tensor)]
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        if base in _PRODUCTS:
            k = args[_PRODUCTS[base]].shape[-1]
            self.flops += 2 * outs[0].numel() * k
        elif base in _SCATTERS:
            self.flops += max(t.numel() for t in ins[1:])
        elif base not in _MOVES:
            self.flops += max(t.numel() for t in ins + outs)
        fresh = [t for t, r in zip(outs, func._schema.returns)
                 if r.alias_info is None]
        for t in fresh:
            nbytes = t.numel() * t.element_size()
            self.live += nbytes
            weakref.finalize(t, self._free, nbytes)
        self.peak_bytes = max(self.peak_bytes, self.live)
        return out


# Argument values that key the shape cache as they are.
_KEYS = (bool, int, float, str, torch.dtype, torch.device, torch.layout,
         torch.memory_format)


class _Uncached(Exception):
    """An argument the shape cache cannot key (a real tensor, an object)."""


def _signature(x):
    """A hashable key of an op's arguments: each ``meta`` tensor's shape,
    strides and dtype, every other value as it is, nesting kept."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise _Uncached
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_signature(v) for v in x))
    if isinstance(x, dict):
        return (dict, tuple((k, _signature(v)) for k, v in x.items()))
    if x is None or isinstance(x, _KEYS):
        return (type(x), x)
    raise _Uncached


def _leaves(x) -> list:
    """The leaves of nested tuples, lists and dicts (an op's arguments and
    results), in order, a dict's keys beside its values."""
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in _leaves(v)]
    if isinstance(x, dict):
        return [y for k, v in x.items() for y in (k, *_leaves(v))]
    return [x]


def write_record(rec: dict, out: str, name: str) -> str:
    """Write ``rec`` as ``<out>/<rec["mesh"]>/<name>.json``; its path."""
    out_dir = os.path.join(out, rec["mesh"])
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


# ---------------------------------------------------------------------------
# The model cells: one record per (architecture × shape × mesh).
# ---------------------------------------------------------------------------

def _tensors(tree) -> list:
    return [t for t in _leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def reckon(wl):
    """``wl.step_fn`` run once on its ``meta`` arguments under a
    ``Reckoner``: ``(reckoner, outputs, seconds)``."""
    t0 = time.perf_counter()
    with Reckoner() as rk:
        out = wl.step_fn(*wl.abstract_args)
    return rk, out, time.perf_counter() - t0


def _per_device(nbytes: int, devices: int) -> int:
    return -(-int(nbytes) // devices)


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str = None,
             smoke: bool = False, variant: str = "baseline") -> dict:
    """The record of one cell on the (16, 16) or, with ``multi_pod``, the
    (2, 16, 16) mesh: the reference's keys, reckoned on ``meta`` (module
    docstring).  ``out_dir`` is not read (``main`` writes the record);
    it is kept for the reference's signature."""
    skip = configs.skip_reason(arch, shape)
    rec = {"arch": arch, "shape": shape, "mesh": _mesh_tag(multi_pod),
           "status": None}
    if skip:
        rec["status"] = "skipped"
        rec["skip_reason"] = skip
        return rec

    t0 = time.perf_counter()
    mesh = model_mesh(multi_pod=multi_pod)
    devices = mesh_devices(mesh)
    wl = build_workload(arch, shape, mesh, smoke=smoke, variant=variant)
    rec["kind"] = wl.kind
    rec["meta"] = {k: v for k, v in wl.meta.items() if k != "cuts"}
    lower_s = time.perf_counter() - t0
    rk, out, reckon_s = reckon(wl)
    args = _tensors(wl.abstract_args)
    outs = _tensors(out)
    arg_ids = {id(t) for t in args}
    del out
    an = build_workload(arch, shape, mesh, smoke=smoke, analysis=True)
    rk_an, an_out, an_s = reckon(an)
    del an_out
    rec["lower_s"] = round(lower_s, 2)
    rec["compile_s"] = round(reckon_s + an_s, 2)
    rec["devices"] = devices
    rec["per_device"] = "even_split"
    rec["memory_analysis"] = {
        "argument_size_in_bytes": _per_device(_nbytes(args), devices),
        "output_size_in_bytes": _per_device(_nbytes(outs), devices),
        "temp_size_in_bytes": _per_device(rk.peak_bytes, devices),
        "alias_size_in_bytes": _per_device(
            _nbytes([t for t in outs if id(t) in arg_ids]), devices),
        "generated_code_size_in_bytes": 0}
    rec["cost_analysis"] = {"flops": rk.flops / devices,
                            "bytes accessed": rk.bytes / devices}
    rec["collectives"] = {k: {"count": 0, "operand_bytes": 0}
                          for k in COLL_KINDS}
    rec["collective_top_ops"] = []
    rec["collectives_reckoned"] = False
    rec["hlo_bytes"] = 0
    rec["analysis_cost"] = {"flops": float(rk_an.flops),
                            "bytes accessed": float(rk_an.bytes)}
    print(f"  memory_analysis: {rec['memory_analysis']}")
    print(f"  cost_analysis: flops={rec['cost_analysis']['flops']} "
          f"bytes={rec['cost_analysis']['bytes accessed']}")
    print(f"  analysis_cost(total): flops={rec['analysis_cost']['flops']}")
    rec["status"] = "ok"
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs (CI sanity, not the deliverable)")
    ap.add_argument("--variant", default="baseline",
                    help="workload variant (e.g. 'dist' for the vertex-cut "
                         "GNN step, 'kvq' for the int8 KV cache)")
    ap.add_argument("--out", default="reports/dryrun_torch")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    cells = [(a, s, sk) for (a, s, sk) in all_cells()
             if (args.arch is None or a == args.arch)
             and (args.shape is None or s == args.shape)]
    if args.list:
        for a, s, sk in cells:
            print(f"{a:28s} {s:16s} {'SKIP: ' + sk if sk else ''}")
        return 0

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    for multi_pod in meshes:
        tag = _mesh_tag(multi_pod)
        for arch, shape, _ in cells:
            print(f"[dryrun:{tag}] {arch} × {shape}", flush=True)
            try:
                rec = run_cell(arch, shape, multi_pod, args.out,
                               smoke=args.smoke, variant=args.variant)
            except Exception:
                rec = {"arch": arch, "shape": shape, "mesh": tag,
                       "status": "error",
                       "error": traceback.format_exc(limit=20)}
                failures += 1
                print(f"  ERROR\n{rec['error']}", flush=True)
            write_record(rec, args.out, f"{arch}__{shape}")
            print(f"  -> {rec['status']} "
                  f"(reckon {rec.get('compile_s', '-')}s)", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
