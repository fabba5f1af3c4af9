from repro_torch.graph.structure import (BlockedELL, Graph, grid_graph,
                                         line_graph, rmat_graph,
                                         uniform_graph)
from repro_torch.graph import segment

# The reference also exports ``cora_like``, which comes with the GNN
# workloads (ROADMAP Queue 1, item 12).
__all__ = ["Graph", "BlockedELL", "rmat_graph", "uniform_graph",
           "grid_graph", "line_graph", "segment"]
