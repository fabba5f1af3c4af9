"""The yardstick of ``device_roofline``: the device bytes an answered query
needs, whatever implements it, and the peaks of the chip.

A query from ``root`` needs every out-edge of every vertex it reaches read
once (4 bytes of neighbour and 4 bytes for each edge attribute the query's
path function reads) and every reached vertex's state written once (4
bytes for each component of the state).  Queries in flight together may
share an edge's read: with at most ``sharing`` of them at once (a cell's
clients), a query is charged a ``sharing``-th of its edge bytes, so that
no batching of queries can need fewer bytes than the count.  Reach is the
reference's own (``paths.reach``); the count never looks at the program's
layouts.
"""
from __future__ import annotations

# HBM bandwidth in bytes a second by the name torch gives the card: NVIDIA
# H100 SXM, data sheet.  A card not in the table has no roofline.
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

# kind -> (edge attributes read, state components)
#   BFS  parent on the least shortest path: no attribute; hop count, parent
#   SSSP weight; distance
#   WP   capacity; width
#   WSP  capacity (hops need none); hop count, width
QUERY_SHAPE = {"BFS": (0, 2), "SSSP": (1, 1), "WP": (1, 1), "WSP": (1, 2)}


def needed_bytes(kind: str, reached: int, reached_out_edges: int,
                 sharing: int = 1) -> float:
    attrs, comps = QUERY_SHAPE[kind]
    return reached_out_edges * 4 * (1 + attrs) / sharing \
        + reached * 4 * comps


