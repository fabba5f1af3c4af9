"""Data generators of the port: the GNN and recsys smoke paths' seeded
batches (``graphs``) and the LM token stream (``tokens``)."""
from repro_torch.data import graphs
from repro_torch.data.tokens import TokenStream, host_batch
