"""dlrm-rm2 [recsys] — n_dense=13 n_sparse=26 embed_dim=64
bot_mlp=13-512-256-64 top_mlp=512-512-256-1 interaction=dot
[arXiv:1906.00091; paper].  Table rows follow the DLRM RM2 benchmark
posture (large multi-million-row tables sharded row-wise)."""
from repro_torch.models.dlrm import DLRMConfig

ARCH_ID = "dlrm-rm2"


def full() -> DLRMConfig:
    return DLRMConfig(name=ARCH_ID, n_dense=13, n_sparse=26, embed_dim=64,
                      vocab=4_000_000,
                      bot_mlp=(13, 512, 256, 64),
                      top_mlp_hidden=(512, 512, 256, 1))


def smoke() -> DLRMConfig:
    return DLRMConfig(name=ARCH_ID + "-smoke", n_dense=13, n_sparse=4,
                      embed_dim=16, vocab=100,
                      bot_mlp=(13, 32, 16),
                      top_mlp_hidden=(32, 16, 1))
