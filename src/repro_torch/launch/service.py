"""Continuous-batching analytics service: the port of
``repro.launch.service`` (DESIGN.md §13).

A long-lived service holds resident graphs and answers declarative
analytics REQUESTS; the runtime, not the caller, decides how each request
executes:

* **Continuous batching**: same-(graph, kind) single-source queries share
  a fixed-slot batch.  The scheduler launches the fused fixpoint in bounded
  chunks (``chunk_iters`` iterations per launch, ``run_program_batch(
  init_state=..., return_state=True)`` on the ``cuda`` engine); converged
  slots retire with their answers while unconverged queries carry their
  state into the next launch, and queued arrivals join retired slots with
  fresh C1/C2 init rows (``batch_init_state``).  A late joiner produces the
  exact bits of a solo run (the idempotent-round unique-fixpoint argument,
  checked by ``verify_sequential``).
* **Cross-kind scalar fusion**: queued scalar requests (radius/drr/ecc
  style r-terms) fuse into ONE round via ``fusion.fuse_many``, and every
  request reads its OWN answer from the single execution.
* **Solo lane**: everything else (LetRound chains, vertex-valued one-offs)
  runs as a plain ``run_program``.
* **Graph mutation under traffic** (``mutate_graph``): edge inserts and
  deletes drain the graph's in-flight batch lanes (queued requests hold),
  patch the layouts on their device (``graph.mutate``), swap the resident
  graph, and let queued repeat queries warm-start from the retired-answer
  memo, which deletions invalidate (stale monotone values cannot retract).
* **Bounded graph residency**: an LRU over resident graphs; evicting a
  graph drops exactly its derived layouts via ``engine.clear_graph_caches``
  and its lanes and memo rows, so the device memory they held is freed.

Scheduling runs on the reference's **virtual clock**: each launch advances
simulated time by ``launch_overhead_s + iter_cost_s × (max live-slot
iterations)``, arrivals are an open-loop process, and every scheduling
decision (batch membership, launch counts, occupancy, virtual latencies)
is a deterministic function of the seeded trace and the graph: the same
as the reference's for the same trace.  Wall-clock latencies are measured
and only reported.

Where the port differs from the reference:

* the carried ``[B, n]`` lane state and the retired-answer memo stay on
  the graph's device between chunks: joiners' rows are spliced with index
  writes there, and an answer leaves the device once, at retirement, as a
  host copy (``req.value`` is a numpy array for a vertex answer, a Python
  float for a scalar one);
* ``ServiceConfig.engine`` defaults to ``"cuda"`` and ``ServiceConfig.
  device`` (``None`` → the CUDA card, ``structure.resolve_device``) is
  passed to every entry-point call; ``add_graph`` refuses a graph that
  lives elsewhere.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import engine, fusion
from repro_torch.core import lang as L
from repro_torch.graph.structure import resolve_device

# virtual service-time model: deterministic stand-ins for device time, so
# the simulated schedule (and every gated metric) reproduces bit for bit
# across machines.  One fixpoint iteration costs ITER_COST_S; every launch
# pays LAUNCH_OVERHEAD_S dispatch overhead.
ITER_COST_S = 1e-3
LAUNCH_OVERHEAD_S = 5e-4


@dataclasses.dataclass
class ServiceConfig:
    engine: str = "cuda"
    max_batch: int = 8             # continuous-batch slots per (graph, kind)
    chunk_iters: int = 4           # scheduler quantum: fixpoint iterations
                                   # per launch
    max_scalar_fuse: int = 8       # scalar requests paired per fused round
    max_graphs: int = 4            # resident-graph LRU bound
    iter_cost_s: float = ITER_COST_S
    launch_overhead_s: float = LAUNCH_OVERHEAD_S
    max_chunks_per_query: int = 1000   # scheduler livelock guard
    adaptive: bool = False         # the planner's recorded-stats feedback
    device: object = None          # None → the CUDA card; "cpu" runs the
                                   # plain versions of the kernels

    def __post_init__(self):
        self.device = resolve_device(self.device)


@dataclasses.dataclass
class Request:
    """One analytics request.  Either a registered ``kind`` + query
    ``source`` (continuous-batch candidates: BFS/SSSP/WP-style sweeps) or a
    raw ``spec`` term (scalar requests pair via fuse_many; anything else
    runs solo)."""
    rid: int = -1
    kind: Optional[str] = None
    source: Optional[int] = None
    spec: Optional[object] = None
    # filled by the service:
    gname: str = ""
    lane: str = ""                 # "batch" | "scalar" | "solo"
    arrival: float = 0.0           # virtual admission time
    completed: float = 0.0         # virtual completion time
    wall_latency_s: float = 0.0    # wall time submit→answer (reported only)
    value: object = None
    iterations: int = 0
    chunks: int = 0                # chunk launches this request rode
    joined_launch: int = -1        # global launch seq of its first chunk


class _BatchLane:
    """Fixed-slot continuous batch for one (graph, kind): per-slot request,
    per-slot source, and the carried per-component [B, n] fixpoint state,
    tensors on the graph's device."""

    def __init__(self, prog, max_batch):
        self.prog = prog
        self.pending: deque = deque()
        self.slots: list = [None] * max_batch
        self.sources = np.zeros(max_batch, np.int64)
        self.state: Optional[list] = None   # [comp][B, n] carried between
                                            # launches; None ⇒ cold batch

    def live(self):
        return [i for i, r in enumerate(self.slots) if r is not None]

    def busy(self):
        return bool(self.pending) or any(r is not None for r in self.slots)


class _QueueLane:
    def __init__(self):
        self.pending: deque = deque()

    def busy(self):
        return bool(self.pending)


def _fusable_scalar(spec) -> bool:
    """Single-round scalar r-terms pair via fuse_many; LetRound chains and
    vertex-valued terms run solo."""
    return fusion._is_r_term(spec) and not isinstance(spec, L.LetRound)


def _host(t) -> np.ndarray:
    """A host copy of a tensor answer (never a view of device or carried
    memory)."""
    t = t.detach()
    return t.cpu().numpy() if t.device.type != "cpu" else t.numpy().copy()


def _answer(value):
    """An answer as the reference gives it: a numpy array for a vertex
    value, a Python float for a scalar."""
    if isinstance(value, torch.Tensor):
        return _host(value) if value.dim() else float(value)
    v = np.asarray(value)
    return np.array(v) if v.ndim else float(v)


class AnalyticsService:
    """Admission queues + lane scheduler over resident graphs.

    ``register(kind, spec_fn)`` declares a query shape (``spec_fn(source)``
    → Term); shapes whose fused program passes
    ``engine.batchable_program`` serve through the continuous-batching
    lane, the rest solo.  ``submit`` enqueues, ``step`` executes one
    launch, ``run_open_loop`` drives a whole seeded arrival trace."""

    def __init__(self, config: Optional[ServiceConfig] = None):
        self.cfg = config or ServiceConfig()
        self.clock = 0.0               # virtual seconds
        self._graphs: OrderedDict = OrderedDict()
        self._kinds: dict = {}         # kind -> (spec_fn, prog, batchable)
        self._lanes: OrderedDict = OrderedDict()  # key -> lane
        self._rr = 0                   # round-robin cursor over lane keys
        self._launch_seq = 0
        self.completed: list = []      # finished Requests, completion order
        # counters (all deterministic under the virtual clock)
        self.batch_launches = 0
        self.batch_completed = 0
        self.scalar_rounds = 0
        self.scalar_fused = 0
        self.solo_runs = 0
        self.graph_evictions = 0
        self.total_iterations = 0
        self.mutations = 0             # mutate_graph batches applied
        self.patched_layouts = 0       # layouts patched on their device
        self.rebuilt_layouts = 0       # layouts that fell back to a rebuild
        self.drain_launches = 0        # extra launches spent draining lanes
                                       # before a mutation swapped the graph
        self.warm_joins = 0            # batch joiners seeded from a retired
                                       # answer instead of a cold init row
        self._retired: OrderedDict = OrderedDict()  # (gname, kind, source) ->
                                       # per-component [n] converged state,
                                       # device clones
        self._occupancy: list = []     # live/max per batch launch
        self._wall_t0: Optional[float] = None
        self.wall_s = 0.0

    _RETIRED_MAX = 256                 # retired-answer memo LRU bound

    # ----- graphs (bounded residency, LRU) ---------------------------------

    @property
    def graphs(self):
        return dict(self._graphs)

    def add_graph(self, name: str, g) -> None:
        if g.device != self.cfg.device:
            raise ValueError(
                f"graph {name!r} lives on {g.device}, the service runs on "
                f"{self.cfg.device}; build the graph with "
                f"device={self.cfg.device}")
        if name in self._graphs:
            self._graphs.move_to_end(name)
            self._graphs[name] = g
            return
        self._graphs[name] = g
        self._evict_over_capacity()

    def _graph_busy(self, name: str) -> bool:
        return any(lane.busy() for key, lane in self._lanes.items()
                   if key[1] == name)

    def _evict_over_capacity(self) -> None:
        """Evict least-recently-used IDLE graphs down to ``max_graphs``:
        drop the graph's derived-structure caches (clear_graph_caches), its
        lanes and its memo rows.  Graphs with queued or in-flight work are
        never evicted (capacity is a soft bound under pathological
        pinning)."""
        while len(self._graphs) > self.cfg.max_graphs:
            victim = None
            names = list(self._graphs)
            for name in names[:-1]:        # newest (just added) is protected
                if not self._graph_busy(name):
                    victim = name
                    break
            if victim is None:
                break
            g = self._graphs.pop(victim)
            engine.clear_graph_caches(g)
            for key in [k for k in self._lanes if k[1] == victim]:
                del self._lanes[key]
            self._drop_retired(victim)
            self._rr = 0
            self.graph_evictions += 1

    # ----- graph mutation (DESIGN.md §15) ----------------------------------

    def _drop_retired(self, gname: str) -> None:
        for key in [k for k in self._retired if k[0] == gname]:
            del self._retired[key]

    def mutate_graph(self, gname: str, insert=None, delete=None, **kw):
        """Apply one batched edge insert/delete to a resident graph under
        live traffic: drain the graph's in-flight batch lanes to completion
        (queued requests stay queued and join on the MUTATED graph), patch
        the layouts through ``graph.mutate.mutate_edges``, and swap the
        resident graph.  Queued repeat queries of retired (kind, source)
        answers warm-start from the retired-answer memo, which survives
        inserts and is invalidated by deletions.  Returns the
        ``MutationDelta``."""
        from repro_torch.graph import mutate as _mutate
        if gname not in self._graphs:
            raise KeyError(f"graph {gname!r} is not resident; add_graph it")
        for key in [k for k in self._lanes if k[0] == "batch"
                    and k[1] == gname]:
            lane = self._lanes[key]
            while lane.live():
                self.drain_launches += 1
                self._step_batch(gname, lane, admit=False)
        old_g = self._graphs[gname]
        new_g, md = _mutate.mutate_edges(old_g, insert=insert, delete=delete,
                                         **kw)
        self._graphs[gname] = new_g
        self._graphs.move_to_end(gname)
        engine.clear_graph_caches(old_g)
        if md.has_deletes:
            self._drop_retired(gname)
        self.mutations += 1
        self.patched_layouts += md.patched_layouts
        self.rebuilt_layouts += md.rebuilt_layouts
        return md

    # ----- registration / admission ----------------------------------------

    def register(self, kind: str, spec_fn: Callable) -> bool:
        """Declare a query shape.  Returns True when it will serve through
        the continuous-batching lane (single idempotent sourced round)."""
        prog = fusion.fuse(spec_fn(0))
        batchable = engine.batchable_program(prog)
        self._kinds[kind] = (spec_fn, prog, batchable)
        return batchable

    def _lane(self, key):
        lane = self._lanes.get(key)
        if lane is None:
            if key[0] == "batch":
                _, prog, _ = self._kinds[key[2]]
                lane = _BatchLane(prog, self.cfg.max_batch)
            else:
                lane = _QueueLane()
            self._lanes[key] = lane
        return lane

    def submit(self, gname: str, req: Request) -> None:
        if gname not in self._graphs:
            raise KeyError(f"graph {gname!r} is not resident; add_graph it")
        self._graphs.move_to_end(gname)    # touch: residency is usage-driven
        req.gname = gname
        req._wall_submit = time.perf_counter()
        if req.kind is not None:
            if req.kind not in self._kinds:
                raise KeyError(f"unregistered request kind {req.kind!r}")
            spec_fn, _, batchable = self._kinds[req.kind]
            if batchable and req.source is not None:
                req.lane = "batch"
                self._lane(("batch", gname, req.kind)).pending.append(req)
                return
            req.spec = spec_fn(req.source)
            req.lane = "solo"
            self._lane(("solo", gname, None)).pending.append(req)
            return
        if req.spec is None:
            raise ValueError("a request needs a registered kind or a spec")
        if _fusable_scalar(req.spec):
            req.lane = "scalar"
            self._lane(("scalar", gname, None)).pending.append(req)
        else:
            req.lane = "solo"
            self._lane(("solo", gname, None)).pending.append(req)

    def _has_work(self) -> bool:
        return any(lane.busy() for lane in self._lanes.values())

    # ----- one scheduling step ---------------------------------------------

    def step(self) -> bool:
        """Execute ONE launch on the next lane with work (round-robin over
        lanes for fairness) and advance the virtual clock.  Returns False
        when every lane is idle."""
        keys = list(self._lanes)
        if not keys:
            return False
        for off in range(len(keys)):
            key = keys[(self._rr + off) % len(keys)]
            lane = self._lanes[key]
            if not lane.busy():
                continue
            self._rr = (self._rr + off + 1) % len(keys)
            if key[0] == "batch":
                return self._step_batch(key[1], lane)
            if key[0] == "scalar":
                return self._step_scalar(key[1], lane)
            return self._step_solo(key[1], lane)
        return False

    def _advance(self, iterations: int) -> None:
        self.clock += (self.cfg.launch_overhead_s
                       + self.cfg.iter_cost_s * int(iterations))

    def _complete(self, req: Request) -> None:
        req.completed = self.clock
        req.wall_latency_s = time.perf_counter() - req._wall_submit
        self.completed.append(req)

    def _splice(self, lane: _BatchLane, slots: list, rows: list) -> None:
        """Write per-component rows ``rows[c]`` ([len(slots), n]) into the
        carried state at ``slots``, on the device.  The write makes a new
        tensor, so nothing that viewed the old state changes."""
        idx = torch.tensor(slots, dtype=torch.int64,
                           device=lane.state[0].device)
        lane.state = [s.index_copy(0, idx, r.to(s.dtype))
                      for s, r in zip(lane.state, rows)]

    def _step_batch(self, gname: str, lane: _BatchLane,
                    admit: bool = True) -> bool:
        g = self._graphs[gname]
        B = self.cfg.max_batch
        # 1. join: queued arrivals take over free slots with fresh init rows
        # (or a retired answer's converged rows — the repeat-query warm
        # start).  ``admit=False`` is the mutation drain: in-flight slots
        # run to retirement, the queue holds for the mutated graph.
        joiners = []
        if admit:
            for i in range(B):
                if lane.slots[i] is None and lane.pending:
                    req = lane.pending.popleft()
                    lane.slots[i] = req
                    lane.sources[i] = int(req.source)
                    req.joined_launch = self._launch_seq
                    joiners.append(i)
        live = lane.live()
        if not live:
            return False
        kind = lane.slots[live[0]].kind
        memo_hits = {i: self._retired.get((gname, kind,
                                           int(lane.sources[i])))
                     for i in joiners}
        memo_hits = {i: rows for i, rows in memo_hits.items()
                     if rows is not None}
        if lane.state is None and memo_hits:
            # cold lane with a warm joiner: materialize the full carried
            # state so the memo rows have somewhere to splice into
            lane.state = list(engine.batch_init_state(
                g, lane.prog, [int(s) for s in lane.sources]))
        if lane.state is None:
            init = None                # cold batch: C1/C2 init from sources
        else:
            cold_joiners = [i for i in joiners if i not in memo_hits]
            if cold_joiners:
                rows = engine.batch_init_state(
                    g, lane.prog,
                    [int(lane.sources[i]) for i in cold_joiners])
                self._splice(lane, cold_joiners, list(rows))
            for i in memo_hits:
                self._retired.move_to_end((gname, kind,
                                           int(lane.sources[i])))
                self.warm_joins += 1
            if memo_hits:
                self._splice(lane, list(memo_hits), [
                    torch.stack([m[c] for m in memo_hits.values()])
                    for c in range(len(lane.state))])
            init = tuple(lane.state)
        # 2. one bounded chunk launch; converged slots retire, the rest carry.
        # The service plans ONCE per (graph, kind, hints): repeated chunk
        # launches of a lane reuse the cached ExecutionPlan (and, with
        # cfg.adaptive, pick up the recorded-stats feedback of this graph).
        plan = engine.plan_execution(
            g, lane.prog, engine=self.cfg.engine, batch=B,
            on_nonconverge="ignore", adaptive=self.cfg.adaptive,
            default_engine="cuda")
        outs, state = engine.run_program_batch(
            g, lane.prog, [int(s) for s in lane.sources],
            max_iter=self.cfg.chunk_iters,
            init_state=init, return_state=True, plan=plan,
            device=self.cfg.device)
        lane.state = list(state)       # stays on the device
        self._launch_seq += 1
        self.batch_launches += 1
        self._occupancy.append(len(live) / B)
        chunk_iters = 0
        for i in live:
            req = lane.slots[i]
            it = int(outs[i].stats.iterations)
            req.iterations += it
            req.chunks += 1
            chunk_iters = max(chunk_iters, it)
            if req.chunks > self.cfg.max_chunks_per_query:
                raise RuntimeError(
                    f"request {req.rid} ({req.kind}@{req.source}) exceeded "
                    f"{self.cfg.max_chunks_per_query} chunks without "
                    "converging")
        self.total_iterations += chunk_iters
        self._advance(chunk_iters)
        for i in live:
            req = lane.slots[i]
            if outs[i].stats.converged:
                req.value = _host(outs[i].value)
                self.batch_completed += 1
                self._complete(req)
                # retired-answer memo: the slot's converged per-component
                # state seeds future repeat queries of this (kind, source)
                key = (gname, req.kind, int(lane.sources[i]))
                self._retired[key] = [s[i].clone() for s in lane.state]
                self._retired.move_to_end(key)
                while len(self._retired) > self._RETIRED_MAX:
                    self._retired.popitem(last=False)
                lane.slots[i] = None
        if not lane.busy():
            lane.state = None          # drained: next arrival cold-starts
        return True

    def _step_scalar(self, gname: str, lane: _QueueLane) -> bool:
        g = self._graphs[gname]
        batch = []
        while lane.pending and len(batch) < self.cfg.max_scalar_fuse:
            batch.append(lane.pending.popleft())
        prog = fusion.fuse_many([(r.rid, r.spec) for r in batch])
        res = engine.run_program(g, prog, engine=self.cfg.engine,
                                 adaptive=self.cfg.adaptive,
                                 device=self.cfg.device)
        self.scalar_rounds += 1
        self.scalar_fused += len(batch)
        self.total_iterations += int(res.stats.iterations)
        self._advance(res.stats.iterations)
        for r in batch:
            r.value = float(res.value[r.rid])
            r.iterations = int(res.stats.iterations)
            self._complete(r)
        return True

    def _step_solo(self, gname: str, lane: _QueueLane) -> bool:
        g = self._graphs[gname]
        req = lane.pending.popleft()
        res = engine.run_program(g, fusion.fuse(req.spec),
                                 engine=self.cfg.engine,
                                 adaptive=self.cfg.adaptive,
                                 device=self.cfg.device)
        self.solo_runs += 1
        self.total_iterations += int(res.stats.iterations)
        self._advance(res.stats.iterations)
        req.value = _answer(res.value)
        req.iterations = int(res.stats.iterations)
        self._complete(req)
        return True

    # ----- the open-loop driver --------------------------------------------

    def run_open_loop(self, arrivals) -> dict:
        """Drive a whole arrival trace ([(t, gname, Request)] — see
        ``open_loop_arrivals``) to completion on the virtual clock: admit
        everything due, launch, repeat; idle gaps fast-forward to the next
        arrival.  Returns ``metrics()``."""
        evs = sorted(arrivals, key=lambda e: (e[0], e[2].rid))
        self._wall_t0 = time.perf_counter()
        i = 0
        while i < len(evs) or self._has_work():
            while i < len(evs) and evs[i][0] <= self.clock + 1e-12:
                t, gname, req = evs[i]
                req.arrival = t
                self.submit(gname, req)
                i += 1
            if not self._has_work():
                self.clock = evs[i][0]     # idle: jump to the next arrival
                continue
            self.step()
        self.wall_s = time.perf_counter() - self._wall_t0
        return self.metrics()

    def state_bytes(self) -> dict:
        """Device bytes held by the carried lane state and by the
        retired-answer memo."""
        lane = sum(s.numel() * s.element_size()
                   for ln in self._lanes.values()
                   if isinstance(ln, _BatchLane) and ln.state is not None
                   for s in ln.state)
        memo = sum(r.numel() * r.element_size()
                   for rows in self._retired.values() for r in rows)
        return {"lane_state_bytes": lane, "memo_bytes": memo,
                "memo_entries": len(self._retired)}

    def metrics(self) -> dict:
        """Deterministic serving metrics (virtual clock) + reported-only
        wall numbers.  ``queries_per_launch`` > 1 is the continuous-batching
        win: more than one answer per launch."""
        v_lat = np.array([r.completed - r.arrival for r in self.completed]
                         or [0.0])
        w_lat = np.array([r.wall_latency_s for r in self.completed] or [0.0])
        bl = max(self.batch_launches, 1)
        return {
            "completed": len(self.completed),
            "batch_launches": self.batch_launches,
            "batch_completed": self.batch_completed,
            "queries_per_launch": round(self.batch_completed / bl, 6),
            "occupancy": round(float(np.mean(self._occupancy))
                               if self._occupancy else 0.0, 6),
            "scalar_rounds": self.scalar_rounds,
            "scalar_fused": self.scalar_fused,
            "solo_runs": self.solo_runs,
            "graph_evictions": self.graph_evictions,
            "total_iterations": self.total_iterations,
            "mutations": self.mutations,
            "patched_layouts": self.patched_layouts,
            "rebuilt_layouts": self.rebuilt_layouts,
            "drain_launches": self.drain_launches,
            "warm_joins": self.warm_joins,
            "virtual_s": round(self.clock, 9),
            "v_p50_ms": round(float(np.percentile(v_lat, 50)) * 1e3, 6),
            "v_p99_ms": round(float(np.percentile(v_lat, 99)) * 1e3, 6),
            "v_qps": round(len(self.completed) / self.clock, 3)
            if self.clock > 0 else 0.0,
            # wall numbers: machine-dependent, never gated
            "wall_s": round(self.wall_s, 6),
            "wall_qps": round(len(self.completed) / self.wall_s, 3)
            if self.wall_s > 0 else 0.0,
            "wall_p50_ms": round(float(np.percentile(w_lat, 50)) * 1e3, 3),
            "wall_p99_ms": round(float(np.percentile(w_lat, 99)) * 1e3, 3),
        }


# ---------------------------------------------------------------------------
# Synthetic open-loop arrivals + the bitwise verification oracle.
# ---------------------------------------------------------------------------


def open_loop_arrivals(n_requests: int, rate: float, seed: int,
                       make_request: Callable) -> list:
    """Seeded OPEN-loop arrival trace: exponential interarrival times
    (Poisson process) whose timestamps are independent of service progress,
    so queueing pressure (and the batching opportunity) is real.
    ``make_request(rng, i) -> (gname, Request)`` draws each request; the
    trace is a pure function of the seed (the reference's draws).  Returns
    [(t, gname, Request)]."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for i in range(int(n_requests)):
        t += float(rng.exponential(1.0 / rate))
        gname, req = make_request(rng, i)
        req.rid = i
        out.append((t, gname, req))
    return out


def standard_mix(gname: str, n_vertices: int,
                 batch_kinds=("BFS", "SSSP"), scalar_share: float = 0.25):
    """``make_request`` factory for the serving bench/smoke: a seeded mix
    of single-source sweep queries over the registered ``batch_kinds``
    (random sources — the continuous-batching traffic) and cross-kind
    scalar queries (radius/drr over random vertex pairs — the fuse_many
    traffic)."""
    from repro_torch.core import usecases as U

    def make(rng, i):
        if rng.random() >= scalar_share:
            kind = batch_kinds[int(rng.integers(len(batch_kinds)))]
            return gname, Request(kind=kind,
                                  source=int(rng.integers(n_vertices)))
        a = int(rng.integers(n_vertices))
        b = int(rng.integers(n_vertices))
        spec = U.radius(a, b) if rng.random() < 0.5 else U.drr(a, b)
        return gname, Request(spec=spec)
    return make


def _bitwise_equal(a, b) -> bool:
    a = np.asarray(a)
    b = np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and a.tobytes() == b.tobytes()


def verify_sequential(svc: AnalyticsService, graphs: Optional[dict] = None,
                      engine_name: Optional[str] = None,
                      solo_walls: Optional[dict] = None) -> int:
    """Re-run every completed request SOLO (plain ``run_program``: one
    monolithic, unbatched, unchunked execution per request) and assert each
    service answer is bitwise-identical.  This is the serving layer's
    correctness oracle: continuous batching, chunked warm resume, slot
    joins and cross-kind scalar fusion must all be invisible in the bits.
    ``solo_walls``, where given, receives each re-run's wall seconds by
    request id (the device synchronized around it).  Returns the number of
    requests checked."""
    graphs = dict(svc.graphs, **(graphs or {}))
    eng = engine_name or svc.cfg.engine
    dev = svc.cfg.device
    checked = 0
    for req in svc.completed:
        g = graphs.get(req.gname)
        if g is None:                  # evicted graph without an override
            continue
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if req.lane == "batch":
            _, prog, _ = svc._kinds[req.kind]
            ref = engine.run_program(g, prog, engine=eng, source=req.source,
                                     device=dev).value
        else:
            ref = engine.run_program(g, fusion.fuse(req.spec), engine=eng,
                                     device=dev).value
        ref = _answer(ref)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if solo_walls is not None:
            solo_walls[req.rid] = time.perf_counter() - t0
        got = req.value
        if np.ndim(ref) == 0:
            ref = np.asarray(float(ref), np.float64)
            got = np.asarray(float(got), np.float64)
        if not _bitwise_equal(got, ref):
            raise AssertionError(
                f"request {req.rid} ({req.lane} lane, kind={req.kind!r}, "
                f"source={req.source}) diverged from its solo run")
        checked += 1
    return checked
