"""A run with the timed path broken underneath comes out not correct: the
harness's set-up, window and check at a small size on the CPU, with one
fault planted in the program for each fault the cells can have (they run
on one chip, so no exchange between chips can be left out)."""
import time

import numpy as np
import pytest
import torch

import harness
from reference import compare

from repro_torch.core import engine, iterate
from repro_torch.launch import service


def _drive(workload: str) -> bool:
    cell = harness.load_cell(harness.load_benchmark(), workload)
    run = harness.setup(cell, 2 ** 31 + 3, "cpu", time.perf_counter(),
                        {"scale": 7})
    harness.window(run, 0.6, trace=False)
    harness.free_program(run)
    harness.check(run)
    assert run.sample.items()
    return compare.verdict(run.check)


def _state_unchanged(monkeypatch):
    merge = iterate.plan_merge

    def unchanged(plan, a, b, comps):
        return {c: a[c] for c in merge(plan, a, b, comps)}
    monkeypatch.setattr(iterate, "plan_merge", unchanged)


def _half_batch(monkeypatch):
    batch = engine.run_program_batch

    def half(g, prog, sources, **kw):
        keep = (len(sources) + 1) // 2
        outs, state = batch(g, prog, list(sources)[:keep], **{
            k: (None if v is None else tuple(s[:keep] for s in v))
            if k == "init_state" else v for k, v in kw.items()})
        outs = list(outs) + [outs[0]] * (len(sources) - keep)
        state = tuple(torch.cat([s] + [s[:1]] * (len(sources) - keep))
                      for s in state)
        return outs, state
    monkeypatch.setattr(engine, "run_program_batch", half)


def _altered_answer(monkeypatch):
    host = service._host
    finish = engine._finish_round

    def altered(value):
        out = np.array(host(value))
        out[len(out) // 2] += 1
        return out

    def finish_altered(g, round_, env):
        out = finish(g, round_, env).clone()
        out[g.n // 2] += 1
        return out
    monkeypatch.setattr(service, "_host", altered)
    monkeypatch.setattr(engine, "_finish_round", finish_altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "altered_answer": _altered_answer}
CASES = [("urand22-serve", f) for f in FAULTS] + \
        [("kron16-serve", f) for f in FAULTS] + \
        [("urand22-solo", f) for f in ("state_unchanged", "altered_answer")]


@pytest.mark.parametrize("workload", ["urand22-serve", "kron16-serve",
                                      "urand22-solo"])
def test_bench_sound_run_is_correct(workload):
    assert _drive(workload) is True


@pytest.mark.parametrize("workload,fault", CASES)
def test_bench_broken_run_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    assert _drive(workload) is False
