"""grafs-analytics — the paper's own workload as an architecture config:
a set of Grafs specifications (Fig. 1) to fuse, synthesize and execute on
a graph, with engine/model selection.  This is the arch that exercises the
paper's contribution end-to-end; the model configs come with the port of
the ML stack."""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class GrafsConfig:
    name: str = "grafs-analytics"
    usecases: Sequence[str] = ("SSSP", "CC", "BFS", "WP", "WSP", "NSP",
                               "NWR", "Trust", "RADIUS", "DRR", "DS", "RDS")
    engine: str = "pull"          # pull | push | dense | cuda | distributed
    fused: bool = True
    n: int = 10_000               # synthetic RMAT graph size for benches
    e: int = 80_000


def full() -> GrafsConfig:
    return GrafsConfig()


def smoke() -> GrafsConfig:
    return GrafsConfig(name="grafs-analytics-smoke",
                       usecases=("SSSP", "WSP", "RADIUS"), n=64, e=256)
