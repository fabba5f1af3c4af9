"""Model zoo of the port: the LM transformers (dense, MoE, MLA), the GNNs
and DLRM.

``layers`` holds the LM configs and the building blocks as functions over
named parameter sets; ``transformer`` the LM as an ``nn.Module`` with its
training forward, loss value, prefill and KV-cache decode; ``gnn`` GAT,
EGNN, MeshGraphNet and DimeNet, each a ``GNN`` module with its forward and
loss value, and the vertex-cut forwards; ``dlrm`` DLRM RM2, a ``DLRM``
module with its forward, loss value and retrieval tower.  Gradients come
with the training part of the ML stack (ROADMAP Queue 1, item 12c).
"""
