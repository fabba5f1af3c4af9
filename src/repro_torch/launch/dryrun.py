"""The dry-run record of the port: its mesh tag, its collectives counted
from a round's reduction plan, its cost reckoned from the step's torch ops,
and its writer.

The reference lowers and compiles a step for the production meshes and
reads the record off XLA: ``memory_analysis``, ``cost_analysis`` and the
collectives parsed from the compiled HLO.  torch compiles nothing ahead of
a call, so the port reckons the same keys from shapes:

- ``collectives`` / ``collective_top_ops``: one all-reduce per lex level
  of every plan per iteration (``iterate.cross_shard`` folds the level's
  ``[n]`` partials once), its operand the level's state, trips 1 (the
  fixpoint loop is dynamic, as the reference's ``_trip_count`` gives);
- ``cost_analysis`` and the temporary bytes: ``Reckoner`` runs one
  iteration of the step on ``meta`` tensors and adds up the aten ops it
  dispatches (see its docstring for the rules).
"""
from __future__ import annotations

import collections
import json
import os
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core.fusion import Lex

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
# Ops whose operations are one per scattered element (their ``src``).
_SCATTERS = frozenset(("scatter", "scatter_add", "scatter_reduce",
                       "index_add", "index_put", "index_reduce"))


class Reckoner(TorchDispatchMode):
    """Counts the aten ops run under it (on ``meta`` tensors, so nothing
    is allocated or computed):

    - ``flops``: one operation per element of the op's widest tensor
      (operand or result); a scatter one per scattered element; none for
      views and for ops that only move or make data (gathers, copies,
      casts, fills);
    - ``bytes``: each op's tensor operands read once and its results
      written once, views excluded: every op's traffic as if it ran alone
      (nothing fused);
    - ``peak_bytes``: the most bytes that tensors made under the mode
      held at once (freed when Python drops them);
    - ``ops``: how often each op ran."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak_bytes = 0
        self.ops = collections.Counter()

    def _free(self, nbytes):
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        base = name.rstrip("_")
        self.ops[name] += 1
        if func.is_view:
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        if base in _SCATTERS:
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


def write_record(rec: dict, out: str, name: str) -> str:
    """Write ``rec`` as ``<out>/<rec["mesh"]>/<name>.json``; its path."""
    out_dir = os.path.join(out, rec["mesh"])
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path
