"""Data generators of the port: the GNN and recsys smoke paths' seeded
batches (``graphs``).  The reference's token stream comes with the
training part of the ML stack (ROADMAP Queue 1, item 12c)."""
from repro_torch.data import graphs
