"""dimenet [gnn] — n_blocks=6 d_hidden=128 n_bilinear=8 n_spherical=7
n_radial=6  [arXiv:2003.03123; unverified]"""
from repro_torch.models.gnn import DimeNetConfig

ARCH_ID = "dimenet"


def full() -> DimeNetConfig:
    return DimeNetConfig(name=ARCH_ID, n_blocks=6, d_hidden=128,
                         n_bilinear=8, n_spherical=7, n_radial=6)


def smoke() -> DimeNetConfig:
    return DimeNetConfig(name=ARCH_ID + "-smoke", n_blocks=2, d_hidden=16,
                         n_bilinear=4, n_spherical=3, n_radial=3)
