"""Model zoo of the port: the LM transformers (dense, MoE, MLA) and the
GNNs.

``layers`` holds the LM configs and the building blocks as functions over
named parameter sets; ``transformer`` the LM as an ``nn.Module`` with its
training forward, loss value, prefill and KV-cache decode; ``gnn`` GAT,
EGNN, MeshGraphNet and DimeNet, each a ``GNN`` module with its forward and
loss value, and the vertex-cut forwards.  DLRM follows with the rest of
the ML stack (ROADMAP Queue 1, item 12c).
"""
