"""Production meshes of the port, as ``graph.partition.ShardMesh``.

The reference's single-pod (16, 16) mesh of 256 chips and multi-pod
(2, 16, 16) mesh of 512 chips become k = 256 and k = 512 shards on the
ShardMesh's one ``"data"`` axis: the analytics step shards its flat edge
arrays over every mesh axis, so shard j holds edge block j in both
packages.  One process drives every shard, shard j on ``devices[j]``.
"""
from __future__ import annotations

from repro_torch.graph.partition import ShardMesh


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> ShardMesh:
    """256 shards (512 with ``multi_pod``) on ``device`` (``None`` → the
    CUDA card; ``"meta"`` builds shapes only)."""
    return ShardMesh.on(device, 512 if multi_pod else 256)


def batch_axes(mesh) -> tuple:
    """Mesh axes the global batch shards over ("pod"+"data" when present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def mesh_devices(mesh) -> int:
    """The mesh's shard count (devices, repeats counted)."""
    n = 1
    for size in mesh.shape.values():
        n *= int(size)
    return n
