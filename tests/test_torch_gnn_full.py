"""The port's GAT and EGNN at their ``full()`` configs against the JAX
package's, on the CPU: the checks of ``test_torch_gnn.py`` (which holds the
``smoke()`` cases, the generators, the sampler and the registry) on the
same small graphs (``cora_batch`` n 64, 2 molecules × 8 atoms) at full
width and depth: GAT 2 layers of 8 heads over 1,433 features, EGNN 4
layers of 64.  MeshGraphNet and DimeNet at ``full()`` are in
``test_torch_gnn_full_mgn_dimenet.py`` (a file each keeps the suite's
workers balanced)."""
import pytest

from test_torch_gnn import (cases, check_egnn_rotation,  # noqa: F401
                            check_egnn_shards, check_forward, check_loss)


@pytest.mark.parametrize("arch", ["gat-cora", "egnn"])
def test_gnn_full_forward_matches_reference(cases, arch):
    check_forward(cases(arch, "full"))


@pytest.mark.parametrize("arch", ["gat-cora", "egnn"])
def test_gnn_full_loss_matches_reference(cases, arch):
    check_loss(cases(arch, "full"))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_egnn_full_dist_shards_match_reference(cases, k):
    check_egnn_shards(cases("egnn", "full"), k)


def test_egnn_full_rotation_equivariance_in_port(cases):
    check_egnn_rotation(cases("egnn", "full"))
