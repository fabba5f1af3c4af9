"""One run of one cell: set-up, the measured window, the check, the metrics.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json``; its configuration in the file that the
configuration's entry names (``bench/configs/``); its traffic in
``bench/mixes/<traffic>.json``; each metric's reader in
``bench/metrics/<metric>.py``.  The same code runs every cell.  A mix names
its driver (``drivers.DRIVERS``), the query kinds it sends, how many
clients keep one query each in flight (a closed loop), the pool of roots
its queries start from, how many queries of each kind warm the program
up, and how many answers of each kind the check compares with the
reference.  After the window the harness waits up to ``DRAIN_S`` seconds
for the answers still in flight.

``setup`` generates the configuration's graph (``reference.graphgen``),
builds it in the program and warms up the cell's own query kinds.
``window`` drives the closed loop for the given seconds, the first
``profile_window.TRACE_S`` of them under the profiler when traced, then
waits for the answers still in flight.  ``check`` compares a seeded sample
of the answers with the plain reference once ``free_program`` has dropped
the program's state.  ``metrics`` hands the run's record to each reader.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from drivers import DRIVERS, Query, build_graph
from profile_window import TRACE_S, Tracer, span
from reference import compare, graphgen, paths, roofline

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
DRAIN_S = 60.0


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict
    end_to_end: list         # the metric entries of BENCHMARK.json that
    per_layer: list          # this cell reports
    root: Path


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(bench: dict, workload: str, root: Path = ROOT) -> Cell:
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = by_name[workload]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    mix = json.loads((root / "bench" / "mixes" /
                      f"{w['traffic']}.json").read_text())
    return Cell(workload, w, config, mix,
                [m for m in bench["end_to_end"] if _reports(m, workload)],
                [m for m in bench["per_layer"] if _reports(m, workload)],
                root)


def seed_words(seed: int) -> int:
    """The seed as the unsigned 64-bit word both generators take."""
    return int(seed) % 2 ** 64


class Traffic:
    """Queries taken in order from a list of (kind, root) pairs, cycling
    through it."""

    def __init__(self, pairs: list):
        self.pairs = pairs
        self.rid = 0

    def next(self, client: int, t_send: float) -> Query:
        kind, root = self.pairs[self.rid % len(self.pairs)]
        q = Query(self.rid, kind, root, client, t_send)
        self.rid += 1
        return q


def mix_traffic(cell: Cell, edges: dict, seed: int) -> tuple:
    """The window's and the warm-up's traffic.  The window cycles through
    every kind of the mix from every root of a pool of ``root_pool``
    roots, the same pairs in every run, in an order drawn from the seed;
    the warm-up sends ``warmup_per_kind`` queries of each kind from roots
    outside the pool (from its own, on a graph smaller than the pool)."""
    mix = cell.mix
    size, warm = int(mix["root_pool"]), int(mix["warmup_per_kind"])
    pool = graphgen.root_pool(edges, size + warm,
                              int(cell.config["graph_seed"]))
    warm_roots = pool[size:] if pool.size > size else pool[-warm:]
    pairs = [(kind, int(r)) for r in pool[:size] for kind in mix["kinds"]]
    order = np.random.default_rng([seed_words(seed), 3]).permutation(
        len(pairs))
    warmup = [(kind, int(r)) for kind in mix["kinds"] for r in warm_roots]
    return Traffic([pairs[i] for i in order]), Traffic(warmup)


class Sample:
    """A seeded uniform sample (reservoir) of ``k`` answers of each kind."""

    def __init__(self, kinds: list, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed_words(seed), 2])
        self.seen = {kind: 0 for kind in kinds}
        self.kept = {kind: [] for kind in kinds}

    def offer(self, q: Query, value) -> None:
        self.seen[q.kind] += 1
        kept = self.kept[q.kind]
        if len(kept) < self.k:
            kept.append((q, value))
            return
        j = int(self.rng.integers(self.seen[q.kind]))
        if j < self.k:
            kept[j] = (q, value)

    def items(self) -> list:
        return [item for kind in self.kept for item in self.kept[kind]]


@dataclasses.dataclass
class Run:
    """What a run records; the metric readers read it."""
    cell: Cell
    seed: int
    device: torch.device
    edges: dict
    driver: object = None
    setup_s: float = 0.0
    graph_build_s: float = 0.0
    graph_resident_bytes: int = 0
    seconds: float = 0.0          # the window's length
    queries: list = dataclasses.field(default_factory=list)
    answered_in_window: int = 0
    unanswered: int = 0
    counters: dict = dataclasses.field(default_factory=dict)
    trace: Optional[dict] = None
    memory_peak_bytes: int = 0
    needed_bytes: Optional[float] = None
    built_in_window: int = 0
    sample: Optional[Sample] = None
    check: dict = dataclasses.field(default_factory=dict)
    device_name: str = ""
    wrong_answers: int = 0

    @property
    def latencies_s(self) -> np.ndarray:
        return np.array([q.t_done - q.t_send for q in self.queries
                         if q.t_done >= 0])


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mem(device) -> int:
    return torch.cuda.memory_allocated(device) if device.type == "cuda" \
        else 0


def _closed_loop(driver, traffic: Traffic, clients: int, on_answer,
                 t_end: Optional[float] = None, tracer=None,
                 trace_end: float = 0.0) -> list:
    """Each client sends a query.  With ``t_end``, an answered client sends
    its next one until ``t_end``, when the loop stops and returns the
    queries still in flight; without, the loop runs until every query is
    answered.  A ``tracer`` records from the start until ``trace_end``."""
    flight = {}

    def send(client):
        q = traffic.next(client, time.perf_counter())
        flight[q.rid] = q
        driver.submit(q)

    def open_():
        if t_end is None:
            return bool(flight)
        return time.perf_counter() < t_end

    for c in range(clients):
        send(c)
    while open_():
        with span("bench::program"):
            done = driver.step()
        t = time.perf_counter()
        with span("bench::clients"):
            for rid, value, iterations in done:
                q = flight.pop(rid)
                q.t_done = t
                q.iterations = iterations
                on_answer(q, value)
                if t_end is not None and open_():
                    send(q.client)
        if tracer is not None and tracer.open and t >= trace_end:
            tracer.stop()
    if tracer is not None:
        tracer.stop()
    return list(flight.values())


def setup(cell: Cell, seed: int, device, t_start: float,
          overrides: Optional[dict] = None) -> Run:
    """Generate the graph, build it in the program, warm up the cell's
    query kinds; the time from ``t_start`` to the end is ``setup_s``."""
    device = torch.device(device)
    config = dict(cell.config, **(overrides or {}))
    edges = graphgen.generate(config, device)
    run = Run(cell, seed, device, edges)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    mem0 = _mem(device)
    t0 = time.perf_counter()
    graph = build_graph(edges, device)
    run.driver = DRIVERS[cell.mix["driver"]](cell.mix, graph, device)
    del graph
    _, warm = mix_traffic(cell, edges, seed)
    _closed_loop(run.driver, warm, len(warm.pairs), lambda q, value: None)
    _sync(device)
    # what set-up made stays: later collections need not walk it again
    gc.collect()
    gc.freeze()
    run.graph_build_s = time.perf_counter() - t0
    run.graph_resident_bytes = _mem(device) - mem0
    run.setup_s = time.perf_counter() - t_start
    return run


def window(run: Run, seconds: float, trace: bool) -> Run:
    """The measured window, then the drain of the answers in flight."""
    mix = run.cell.mix
    window_traffic, _ = mix_traffic(run.cell, run.edges, run.seed)
    run.sample = Sample(mix["kinds"], int(mix["check_per_kind"]), run.seed)
    before = run.driver.counters()
    libraries = _libraries()
    tracer = Tracer(run.device) if trace else None

    def answered(q, value):
        run.queries.append(q)
        run.sample.offer(q, value)

    if tracer is not None:
        tracer.start()
    t_start = time.perf_counter()
    t_end = t_start + seconds
    flight = _closed_loop(run.driver, window_traffic, int(mix["clients"]),
                          answered, t_end, tracer,
                          t_start + min(seconds, TRACE_S))
    _sync(run.device)
    run.seconds = seconds
    after = run.driver.counters()
    run.counters = {k: after[k] - before[k] for k in after}
    run.answered_in_window = sum(q.t_done <= t_end for q in run.queries)
    if tracer is not None:
        trace_close = t_start + tracer.window_s
        answered_traced = [(q.kind, q.root) for q in run.queries
                           if q.t_done <= trace_close]
    # the answers still in flight: each one that comes counts its wait
    pending = {q.rid: q for q in flight}
    deadline = time.perf_counter() + DRAIN_S
    while pending and time.perf_counter() < deadline:
        for rid, value, iterations in run.driver.step():
            q = pending.pop(rid)
            q.t_done = time.perf_counter()
            q.iterations = iterations
            answered(q, value)
    run.unanswered = len(pending)
    run.built_in_window = len(_libraries() - libraries)
    if tracer is not None:
        run.trace = tracer.summary()
        run.trace["answered"] = answered_traced
    _sync(run.device)
    if run.device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device)
    return run


def _libraries() -> set:
    """The program's built CUDA libraries on disk."""
    from repro_torch.kernels import build
    return set(build.BUILD_DIR.glob("*.so"))


def by_kind(run: Run) -> dict:
    """Each kind's answered queries' latencies (s) and iterations."""
    out: dict = {}
    for q in run.queries:
        lat, it = out.setdefault(q.kind, ([], []))
        lat.append(q.t_done - q.t_send)
        it.append(q.iterations)
    return {k: (np.array(a), np.array(b)) for k, (a, b) in out.items()}


def free_program(run: Run) -> None:
    """Drop the program's state (its graph, layouts, lanes and memo) before
    the reference runs."""
    from repro_torch.core import engine
    run.driver = None
    engine.clear_program_caches()
    gc.unfreeze()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def check(run: Run) -> dict:
    """Compare the sampled answers with the plain reference (and, in a
    traced run, count the bytes the traced window's answers needed: the
    edges each reads, shared among at most the mix's ``clients`` queries
    in flight at once)."""
    g = paths.ref_graph(run.edges, run.device)
    wrong = [compare.wrong_vertices(value, paths.answer(g, q.kind, q.root))
             for q, value in run.sample.items()]
    run.wrong_answers = sum(w > 0 for w in wrong)
    run.check = {"wrong_vertices": sum(wrong), "unanswered": run.unanswered}
    if run.trace is not None:
        reach = {}
        total = 0.0
        sharing = int(run.cell.mix["clients"])
        for kind, root in run.trace["answered"]:
            if root not in reach:
                reach[root] = paths.reach(g, root)
            total += roofline.needed_bytes(kind, *reach[root], sharing)
        run.needed_bytes = total
    return run.check


def load_reader(root: Path, name: str):
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics(run: Run, trace: bool) -> dict:
    """The cell's end-to-end metrics (untraced) or per-layer metrics
    (traced), each from its reader; a reader that finds nothing is left
    out."""
    out = {}
    for m in run.cell.per_layer if trace else run.cell.end_to_end:
        value = load_reader(run.cell.root, m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
