"""The port's MeshGraphNet and DimeNet at their ``full()`` configs against
the JAX package's, on the CPU: the checks of ``test_torch_gnn.py`` on its
small graphs (a 6 × 6 mesh, 2 molecules × 8 atoms) at full width and
depth: MeshGraphNet 15 layers of 128 (single device and its vertex-cut
forward on 1, 2 and 4 shards), DimeNet 6 blocks of 128 with bilinear 8,
spherical 7 and radial 6."""
import pytest

from test_torch_gnn import (cases, check_dimenet_rotation,  # noqa: F401
                            check_forward, check_loss, check_mgn_one_shard,
                            check_mgn_shards)


@pytest.mark.parametrize("arch", ["meshgraphnet", "dimenet"])
def test_gnn_full_forward_matches_reference(cases, arch):
    check_forward(cases(arch, "full"))


@pytest.mark.parametrize("arch", ["meshgraphnet", "dimenet"])
def test_gnn_full_loss_matches_reference(cases, arch):
    check_loss(cases(arch, "full"))


def test_mgn_full_dist_one_shard_matches_reference_dist(cases):
    check_mgn_one_shard(cases("meshgraphnet", "full"))


@pytest.mark.parametrize("k", [2, 4])
def test_mgn_full_dist_shards_match_reference(cases, k):
    check_mgn_shards(cases("meshgraphnet", "full"), k)


def test_dimenet_full_rotation_invariance_in_port(cases):
    check_dimenet_rotation(cases("dimenet", "full"))
