"""Production meshes of the port.

- The analytics step shards its flat edge arrays over every mesh axis, so
  the reference's single-pod (16, 16) mesh of 256 chips and multi-pod
  (2, 16, 16) mesh of 512 chips become k = 256 and k = 512 shards on a
  ``graph.partition.ShardMesh``'s one ``"data"`` axis
  (``make_production_mesh``): shard j holds edge block j in both
  packages, and one process drives every shard, shard j on
  ``devices[j]``.
- The model cells read only the mesh's axes and their sizes (the batch
  axes give ``n_micro`` and ``moe_groups``), so ``model_mesh`` gives a
  shape-only ``MeshShape`` with the reference's axes: ``("data",
  "model")`` of 16 × 16, and ``("pod", "data", "model")`` of 2 × 16 × 16.
"""
from __future__ import annotations

import dataclasses

from repro_torch.graph.partition import ShardMesh


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, and nothing else (no devices)."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> ShardMesh:
    """256 shards (512 with ``multi_pod``) on ``device`` (``None`` → the
    CUDA card; ``"meta"`` builds shapes only)."""
    return ShardMesh.on(device, 512 if multi_pod else 256)


def model_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production mesh as axes and sizes: (16, 16) over
    ("data", "model"), or (2, 16, 16) over ("pod", "data", "model")."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def batch_axes(mesh) -> tuple:
    """Mesh axes the global batch shards over ("pod"+"data" when present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def mesh_devices(mesh) -> int:
    """The mesh's shard count (devices, repeats counted)."""
    n = 1
    for size in mesh.shape.values():
        n *= int(size)
    return n
