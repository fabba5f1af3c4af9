"""The program's side of a run: the two ways a mix reaches ``repro_torch``.

A driver takes queries, runs the program, and hands back each answer as
the client sees it: a host array.  ``step`` runs one unit of the program's
work (one scheduling step of the service, or one whole solo query) and
returns what it answered: (query id, answer, fixpoint iterations).
``counters`` reads the program's own counters, each a running total, so
that the harness can take their change over the window.

``service``  the analytics service's lanes (``launch.service``):
             ``AnalyticsService.submit`` and ``step`` on one resident graph,
             one kind per registered query shape.
``solo``     the engine alone (``core.engine.run_program``): each query
             fused from its specification and run to its fixpoint, one at a
             time.
"""
from __future__ import annotations

import dataclasses
from collections import deque


@dataclasses.dataclass
class Query:
    rid: int
    kind: str
    root: int
    client: int
    t_send: float = 0.0
    t_done: float = -1.0
    iterations: int = 0


def spec_fn(kind: str):
    """The query's specification from ``core.usecases`` by kind name."""
    from repro_torch.core import usecases
    return getattr(usecases, kind.lower())


def build_graph(edges: dict, device):
    from repro_torch.graph import structure
    return structure.from_edges(edges["n"], edges["src"], edges["dst"],
                                edges["weight"], edges["capacity"],
                                device=device)


class ServiceDriver:
    def __init__(self, mix: dict, graph, device):
        from repro_torch.launch import service
        self._request = service.Request
        self.svc = service.AnalyticsService(
            service.ServiceConfig(device=device, **mix["service"]))
        self.svc.add_graph("g", graph)
        for kind in mix["kinds"]:
            self.svc.register(kind, spec_fn(kind))
        self._seen = 0

    def submit(self, q: Query) -> None:
        self.svc.submit("g", self._request(rid=q.rid, kind=q.kind,
                                           source=q.root))

    def step(self) -> list:
        self.svc.step()
        new = self.svc.completed[self._seen:]
        self._seen = len(self.svc.completed)
        out = []
        for req in new:
            out.append((req.rid, req.value, req.iterations))
            req.value = None             # the harness keeps what it checks
        return out

    def counters(self) -> dict:
        m = self.svc.metrics()
        return {"answers": m["batch_completed"],
                "launches": m["batch_launches"],
                "occupied_slots": m["occupancy"] * m["batch_launches"],
                "iterations": m["total_iterations"]}


class SoloDriver:
    def __init__(self, mix: dict, graph, device):
        self.g = graph
        self.device = device
        self.engine = mix["engine"]
        self.pending: deque = deque()
        self._totals = {"answers": 0, "iterations": 0}

    def submit(self, q: Query) -> None:
        self.pending.append(q)

    def step(self) -> list:
        from repro_torch.core import engine, fusion
        q = self.pending.popleft()
        res = engine.run_program(self.g, fusion.fuse(spec_fn(q.kind)(q.root)),
                                 engine=self.engine, device=self.device)
        value = res.value.cpu().numpy()
        iterations = int(res.stats.iterations)
        self._totals["answers"] += 1
        self._totals["iterations"] += iterations
        return [(q.rid, value, iterations)]

    def counters(self) -> dict:
        return dict(self._totals)


DRIVERS = {"service": ServiceDriver, "solo": SoloDriver}
