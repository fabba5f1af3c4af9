"""meshgraphnet [gnn] — n_layers=15 d_hidden=128 aggregator=sum
mlp_layers=2  [arXiv:2010.03409; unverified]"""
from repro_torch.models.gnn import MGNConfig

ARCH_ID = "meshgraphnet"


def full() -> MGNConfig:
    return MGNConfig(name=ARCH_ID, n_layers=15, d_hidden=128, mlp_layers=2)


def smoke() -> MGNConfig:
    return MGNConfig(name=ARCH_ID + "-smoke", n_layers=3, d_hidden=16,
                     mlp_layers=2)
