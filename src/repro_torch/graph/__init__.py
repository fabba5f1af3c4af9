from repro_torch.graph.structure import (BlockedELL, Graph, ShardedELL,
                                         ShardedPushResolution, cora_like,
                                         grid_graph, line_graph, rmat_graph,
                                         sharded_ell_cached,
                                         sharded_push_resolution_cached,
                                         to_sharded_ell,
                                         to_sharded_push_resolution,
                                         uniform_graph)
from repro_torch.graph.partition import (EdgePartition, ShardMesh,
                                         partition_edges, shard_subgraphs)
from repro_torch.graph import segment

__all__ = ["Graph", "BlockedELL", "rmat_graph", "uniform_graph",
           "grid_graph", "line_graph", "cora_like", "segment", "ShardMesh",
           "EdgePartition", "partition_edges", "shard_subgraphs",
           "ShardedELL", "ShardedPushResolution", "to_sharded_ell",
           "sharded_ell_cached", "to_sharded_push_resolution",
           "sharded_push_resolution_cached"]
