"""Edge partitioning of the sharded engines (``distributed``, ``cuda_sharded``).

The port of ``repro.graph.partition``.  PowerGraph-style vertex-cut: the
dst-sorted edge list is split into ``k`` equal, padded blocks; each shard
reduces into a *full* local vertex-state vector (Gather + Apply), and the
partial states are combined across shards with a monoid fold (Scatter,
``segment.psum_like``).  Padding edges are ``(0, 0)`` with a False mask,
which the engines turn into reduction identities, so padding never changes
a result (condition C6).

``ShardMesh`` is the port's counterpart of a ``jax.sharding.Mesh``: one
process drives k shards, shard j on ``devices[j]``.  Devices may repeat, so
k shards can share one card (``ShardMesh.on("cuda", 4)``), or lie on the
CPU (``ShardMesh.on("cpu", k)``, the plain versions of the kernels).

``shard_subgraphs`` re-expresses the same edge blocks as per-shard ``Graph``
subgraphs over the full vertex id space, shard j on its device: the input of
the sharded blocked-ELL layouts and resolutions
(``structure.sharded_ell_cached`` / ``sharded_push_resolution_cached``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.graph.structure import Graph, from_edges, resolve_device

STRATEGIES = ("contiguous", "dst_hash")


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """k shards driven by one process: shard j runs on ``devices[j]``
    (repeats allowed).  ``axis_names`` and ``shape`` mirror a JAX mesh's
    one ``"data"`` axis; ``device_count`` is k, repeats counted."""
    devices: tuple

    def __post_init__(self):
        devs = tuple(resolve_device(d) for d in self.devices)
        if not devs:
            raise ValueError("a ShardMesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @classmethod
    def on(cls, device, k: int) -> "ShardMesh":
        """``k`` shards on one device (``None`` → the CUDA card)."""
        if int(k) < 1:
            raise ValueError(f"a ShardMesh needs k >= 1 shards, got {k}")
        return cls((resolve_device(device),) * int(k))

    @property
    def axis_names(self) -> tuple:
        return ("data",)

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices)}

    @property
    def device_count(self) -> int:
        return len(self.devices)


def check_mesh(mesh) -> ShardMesh:
    """``mesh`` itself, which must be a ``ShardMesh``."""
    if not isinstance(mesh, ShardMesh):
        raise TypeError(f"mesh must be a repro_torch ShardMesh (e.g. "
                        f"ShardMesh.on('cuda', 4)), got "
                        f"{type(mesh).__name__}")
    return mesh


def mesh_shards(mesh, axes=("data",)) -> int:
    """The shard count over ``axes`` of the mesh (the reference's
    ``prod(mesh.shape[a] for a in axes)``)."""
    mesh = check_mesh(mesh)
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    bad = [a for a in axes if a not in mesh.shape]
    if bad:
        raise ValueError(f"axes {bad} are not axes of the mesh "
                         f"{mesh.axis_names}")
    return math.prod(mesh.shape[a] for a in axes)


@dataclasses.dataclass(frozen=True)
class EdgePartition:
    """[k, e_pad] stacked edge blocks on the graph's device."""
    k: int
    e_pad: int
    src: torch.Tensor        # [k, e_pad] int32
    dst: torch.Tensor        # [k, e_pad] int32
    weight: torch.Tensor     # [k, e_pad] float32
    capacity: torch.Tensor   # [k, e_pad] float32
    mask: torch.Tensor       # [k, e_pad] bool


def partition_edges(g: Graph, k: int,
                    strategy: str = "contiguous") -> EdgePartition:
    """Split the dst-sorted edges into ``k`` padded blocks: ``contiguous``
    keeps the dst-sorted order (locality per shard), ``dst_hash`` orders by
    ``dst % k`` with a stable sort (balances high-degree destinations)."""
    e_ord = g.by_dst
    e = g.num_edges
    e_pad = -(-e // k) * k
    if strategy == "contiguous":
        order = None
    elif strategy == "dst_hash":
        order = torch.argsort(e_ord.dst % k, stable=True)
    else:
        raise ValueError(strategy)

    def pad(a, fill):
        out = torch.full((e_pad,), fill, dtype=a.dtype, device=a.device)
        out[:e] = a if order is None else a[order]
        return out.view(k, e_pad // k)

    mask = torch.ones(e, dtype=torch.bool, device=g.device)
    return EdgePartition(
        k=k, e_pad=e_pad // k, src=pad(e_ord.src, 0), dst=pad(e_ord.dst, 0),
        weight=pad(e_ord.weight, 0.0), capacity=pad(e_ord.capacity, 0.0),
        mask=pad(mask, False))


def shard_subgraphs(g: Graph, k: int, strategy: str = "contiguous",
                    devices=None) -> list:
    """Per-shard vertex-cut subgraphs: shard j holds exactly the real edges
    of ``partition_edges(g, k, strategy)``'s j-th block, as a ``Graph`` over
    the full vertex id space on ``devices[j]`` (the graph's device for
    every shard by default).  Empty shards (k > |E|) are legal and yield
    edgeless subgraphs whose layouts are all padding."""
    part = partition_edges(g, k, strategy)
    devices = (g.device,) * k if devices is None else tuple(devices)
    if len(devices) != k:
        raise ValueError(f"{len(devices)} devices for {k} shards")
    out = []
    for j in range(k):
        m = part.mask[j]
        host = [a[j][m].cpu().numpy() for a in
                (part.src, part.dst, part.weight, part.capacity)]
        # the blocks come from a validated graph: no second host scan
        out.append(from_edges(g.n, *host, validate=False,
                              device=devices[j]))
    return out
