"""gat-cora [gnn] — n_layers=2 d_hidden=8 n_heads=8 aggregator=attn
[arXiv:1710.10903; paper]"""
from repro_torch.models.gnn import GATConfig

ARCH_ID = "gat-cora"


def full() -> GATConfig:
    return GATConfig(name=ARCH_ID, n_layers=2, d_hidden=8, n_heads=8,
                     d_in=1433, n_classes=7)


def smoke() -> GATConfig:
    return GATConfig(name=ARCH_ID + "-smoke", n_layers=2, d_hidden=4,
                     n_heads=2, d_in=32, n_classes=7)
