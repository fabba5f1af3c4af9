"""egnn [gnn] — n_layers=4 d_hidden=64 equivariance=E(n)
[arXiv:2102.09844; paper]"""
from repro_torch.models.gnn import EGNNConfig

ARCH_ID = "egnn"


def full() -> EGNNConfig:
    return EGNNConfig(name=ARCH_ID, n_layers=4, d_hidden=64)


def smoke() -> EGNNConfig:
    return EGNNConfig(name=ARCH_ID + "-smoke", n_layers=2, d_hidden=16)
