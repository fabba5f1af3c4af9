"""Error-feedback int8 gradient compression.

The port of ``repro.optim.compress``.  int8 quantization with a
per-tensor scale cuts the bytes of a gradient all-reduce 4× (float32),
and the quantization error is carried in an error-feedback buffer (Seide
et al.; 1-bit Adam lineage), so the scheme is unbiased over time:

    e += g;  q = quant(e);  e -= dequant(q);  all_reduce(q)

Rounding is half to even, as ``jnp.round`` rounds.  The cross-shard
all-reduce (``error_feedback_update``) takes the k shards' gradient trees
and a ``ShardMesh``: every shard quantizes against one shared scale (the
max of the shards' amax) and the int32 payloads are summed in shard order
with ``segment.psum_like``, as the port's other collectives fold.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.graph import segment
from repro_torch.graph.partition import check_mesh
from repro_torch.tree import leaves, tree_map, unflatten


@dataclasses.dataclass
class CompressState:
    error: object          # tree matching grads, float32


def init_compress_state(grads_like) -> CompressState:
    return CompressState(error=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32,
                              device=g.device), grads_like))


def _quant(x):
    amax = torch.clamp(torch.max(torch.abs(x)), min=1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q, scale):
    return q.to(torch.float32) * scale


def compress_grads(grads, state: CompressState):
    """→ (int8 payload tree, scales tree, new state). Error feedback
    folded."""
    def one(g, e):
        acc = g.to(torch.float32) + e
        q, s = _quant(acc)
        return q, s, acc - _dequant(q, s)

    flat_g = leaves(grads)
    out = [one(g, e) for g, e in zip(flat_g, leaves(state.error))]
    qs = unflatten(grads, [o[0] for o in out])
    ss = unflatten(grads, [o[1] for o in out])
    return qs, ss, CompressState(error=unflatten(grads, [o[2] for o in out]))


def decompress_grads(qs, ss):
    return tree_map(_dequant, qs, ss)


def error_feedback_update(grads, states, mesh):
    """Compressed cross-shard gradient mean over a ``ShardMesh``.

    ``grads``: the k shards' gradient trees (shard j's on
    ``mesh.devices[j]``); ``states``: their k ``CompressState``s.  All
    shards quantize against the same scale (the max of the shards'
    amax), so the int32 sum of the payloads is exact; per element the
    error is at most scale/2 per shard and is carried forward by each
    shard's error feedback.  Returns (the k reduced trees, each on its
    shard's device, the k new states)."""
    devs = check_mesh(mesh).devices
    k = len(devs)
    if len(grads) != k or len(states) != k:
        raise ValueError(f"{len(grads)} gradient trees and {len(states)} "
                         f"states for {k} shards")
    flat_g = [leaves(g) for g in grads]
    flat_e = [leaves(s.error) for s in states]
    red = [[] for _ in range(k)]
    err = [[] for _ in range(k)]
    for i in range(len(flat_g[0])):
        acc = [flat_g[j][i].to(torch.float32) + flat_e[j][i]
               for j in range(k)]
        amax = segment.psum_like(
            "max", [torch.max(torch.abs(a)) for a in acc], mesh)
        q32 = []
        for j in range(k):
            scale = torch.clamp(amax[j], min=1e-12) / 127.0
            q = torch.clamp(torch.round(acc[j] / scale), -127, 127).to(
                torch.int8)
            err[j].append(acc[j] - q.to(torch.float32) * scale)
            q32.append(q.to(torch.int32))
        total = segment.psum_like("sum", q32, mesh)
        for j in range(k):
            scale = torch.clamp(amax[j], min=1e-12) / 127.0
            red[j].append(total[j].to(torch.float32) * scale / float(k))
    return ([unflatten(grads[j], red[j]) for j in range(k)],
            [CompressState(error=unflatten(grads[j], err[j]))
             for j in range(k)])
