"""The port's engine fallback chain (cuda → adaptive) and its rule that a
kernel fault is never recoverable.

The counterparts of ``tests/test_checkpointed_fixpoint.py``'s fallback tests
and ``tests/test_runtime.py``'s ``bounded_retry`` test, with
``ops.iterate_cuda`` replaced by a function that raises.  A
``RuntimeError`` raised outside the kernel layer and an out-of-memory
error degrade to adaptive with one event; a kernel build or launch fault,
a CUDA runtime error, any other failure inside ``ops.iterate_cuda`` (a
missing entry point, a mis-typed ctypes call, a fault in the torch glue)
and every guard verdict propagate with no event and no retry."""
import ctypes
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import engine as TE
from repro_torch.core import fusion as TF
from repro_torch.core import guard
from repro_torch.core import usecases as TU
from repro_torch.graph import structure as TS
from repro_torch.kernels import build
from repro_torch.kernels import launch
from repro_torch.kernels import ops as kops
from repro_torch.runtime.ft import FTConfig, bounded_retry

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def g():
    return TS.rmat_graph(400, 3200, seed=11, device="cpu")


def _raiser(exc, calls):
    def boom(*a, **k):
        calls.append(1)
        raise exc
    return boom


def test_cuda_falls_back_to_adaptive(g, monkeypatch):
    dk = TU.handwritten_bfs_depth(0)
    ref = TE.run_direct(g, dk, engine="adaptive", device="cpu")
    calls = []
    monkeypatch.setattr(kops, "iterate_cuda",
                        _raiser(RuntimeError("forced failure outside the kernels"),
                                calls))
    r = TE.run_direct(g, dk, engine="cuda", fallback=True, device="cpu")
    assert torch.equal(ref.value, r.value)
    assert r.stats.engine_used == "adaptive"
    assert r.stats.fallbacks == (
        ("cuda", "adaptive",
         "RuntimeError: forced failure outside the kernels"),)
    assert r.stats.exec_retries == 1 == len(calls) - 1  # one retry first
    assert r.stats.plan.engine == "cuda" and r.stats.plan.fallback


def test_program_falls_back_to_adaptive(g, monkeypatch):
    prog = TF.fuse(TU.ALL_SPECS["SSSP"]())
    ref = TE.run_program(g, prog, engine="cuda", device="cpu")
    monkeypatch.setattr(kops, "iterate_cuda",
                        _raiser(RuntimeError("forced"), []))
    r = TE.run_program(g, prog, engine="cuda", fallback=True, device="cpu",
                       ft_config=FTConfig(max_retries=0))
    assert torch.equal(ref.value, r.value)
    assert (r.stats.engine_used, r.stats.exec_retries) == ("adaptive", 0)
    assert [(f, t) for f, t, _ in r.stats.fallbacks] == [("cuda", "adaptive")]


_OOM = "CUDA out of memory. Tried to allocate 2.00 GiB"


@pytest.mark.parametrize("where", ["engine", "kernel layer"])
def test_out_of_memory_falls_back_to_adaptive(g, monkeypatch, where):
    """An out-of-memory error takes the chain, raised by the engine call
    or inside ``ops.iterate_cuda`` alike."""
    dk = TU.handwritten_sssp(0)
    ref = TE.run_direct(g, dk, engine="cuda", device="cpu")
    calls = []
    boom = _raiser(torch.OutOfMemoryError(_OOM), calls)
    if where == "engine":
        monkeypatch.setattr(kops, "iterate_cuda", boom)
    else:
        monkeypatch.setattr(kops, "sweep_round", boom)
    r = TE.run_direct(g, dk, engine="cuda", fallback=True, device="cpu")
    assert torch.equal(ref.value, r.value)
    assert r.stats.engine_used == "adaptive"
    assert r.stats.fallbacks == (
        ("cuda", "adaptive", f"OutOfMemoryError: {_OOM}"),)
    assert r.stats.exec_retries == 1 == len(calls) - 1


@pytest.mark.parametrize("exc", [
    AttributeError("undefined symbol: grafs_pull_sweep"),
    ctypes.ArgumentError("argument 3: wrong type"),
    RuntimeError("The size of tensor a (512) must match the size of "
                 "tensor b (400)"),
    IndexError("index 512 is out of bounds for dimension 0 with size 400"),
], ids=["missing-entry-point", "ctypes-argument", "torch-glue", "index"])
def test_kernel_layer_faults_propagate(g, monkeypatch, exc):
    """A failure inside ``ops.iterate_cuda`` leaves it as a
    ``KernelLaunchError`` (the failure its cause): never retried, never
    degraded, with or without ``fallback``."""
    calls = []
    monkeypatch.setattr(kops, "sweep_round", _raiser(exc, calls))
    for fallback in (True, False):
        with pytest.raises(guard.KernelLaunchError,
                           match=f"the cuda engine failed: "
                                 f"{type(exc).__name__}") as info:
            TE.run_direct(g, TU.handwritten_sssp(0), engine="cuda",
                          fallback=fallback, device="cpu")
        assert info.value.__cause__ is exc
        assert not guard.recoverable(info.value)
    assert len(calls) == 2


@pytest.mark.parametrize("fault", ["missing-entry-point", "load"])
def test_library_load_faults_are_build_errors(monkeypatch, fault):
    """A built library that will not load, or lacks an entry point its
    declaration binds, is a ``KernelBuildError``."""
    def declare(lib):
        raise AttributeError("undefined symbol: grafs_pull_sweep")

    def cdll(path):
        if fault == "load":
            raise OSError(f"{path}: invalid ELF header")
        return object()

    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "_BY_UNIT", {})
    monkeypatch.setattr(build, "_start", lambda *a: None)
    monkeypatch.setattr(build.ctypes, "CDLL", cdll)
    monkeypatch.setattr(build, "_DECLARE", {"round": declare})
    with pytest.raises(guard.KernelBuildError, match="failed: ") as info:
        build.build_all([("round", "// a round unit\n")])
    assert isinstance(info.value.__cause__,
                      OSError if fault == "load" else AttributeError)
    assert not guard.recoverable(info.value)


def test_clean_fallback_query_stays_on_cuda(g):
    r = TE.run_direct(g, TU.handwritten_sssp(0), engine="cuda",
                      fallback=True, device="cpu")
    assert (r.stats.engine_used, r.stats.fallbacks,
            r.stats.exec_retries) == ("cuda", (), 0)


@pytest.mark.parametrize("max_retries", [0, 3])
def test_ft_config_sets_retry_budget(g, monkeypatch, max_retries):
    calls = []
    monkeypatch.setattr(kops, "iterate_cuda",
                        _raiser(RuntimeError("flaky"), calls))
    r = TE.run_direct(g, TU.handwritten_bfs_depth(0), engine="cuda",
                      fallback=True, device="cpu",
                      ft_config=FTConfig(max_retries=max_retries,
                                         backoff_s=0.0))
    assert r.stats.exec_retries == max_retries
    assert len(calls) == max_retries + 1
    assert r.stats.engine_used == "adaptive"


@pytest.mark.parametrize("exc", [
    guard.KernelBuildError("nvcc failed (exit 1) building x.so"),
    guard.KernelLaunchError("CUDA pull kernel launch failed: cudaError 700"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    type("AcceleratorError", (RuntimeError,), {})("sticky fault"),
], ids=["build", "launch", "cuda-error", "accelerator-error"])
def test_kernel_faults_propagate(g, monkeypatch, exc):
    """A kernel's build or launch fault and a CUDA runtime error are never
    retried nor degraded: the query raises the same error, with no event."""
    calls = []
    monkeypatch.setattr(kops, "iterate_cuda", _raiser(exc, calls))
    with pytest.raises(type(exc)) as info:
        TE.run_direct(g, TU.handwritten_sssp(0), engine="cuda",
                      fallback=True, device="cpu")
    assert info.value is exc
    assert len(calls) == 1
    assert not guard.recoverable(exc)


def test_fallback_never_swallows_guard_verdicts(g, monkeypatch):
    gneg = TS.from_edges(4, [0, 1, 2, 3], [1, 2, 3, 0],
                         weight=[1.0, -2.0, 1.0, 1.0], device="cpu")
    with pytest.raises(guard.TerminationPreconditionError):
        TE.run_direct(gneg, TU.handwritten_sssp(0), engine="cuda",
                      fallback=True, device="cpu")
    dk1 = dataclasses.replace(TU.handwritten_bfs_depth(0), max_iter=1)
    with pytest.raises(guard.NonConvergenceError):
        TE.run_direct(g, dk1, engine="cuda", fallback=True, device="cpu")


def test_fallback_off_propagates(g, monkeypatch):
    monkeypatch.setattr(kops, "iterate_cuda",
                        _raiser(RuntimeError("forced failure"), []))
    with pytest.raises(RuntimeError, match="forced failure"):
        TE.run_direct(g, TU.handwritten_bfs_depth(0), engine="cuda",
                      device="cpu")


def test_adaptive_is_the_floor(g, monkeypatch):
    from repro_torch.core import iterate
    monkeypatch.setattr(kops, "iterate_cuda",
                        _raiser(RuntimeError("cuda down"), []))
    monkeypatch.setattr(iterate, "iterate_adaptive",
                        _raiser(RuntimeError("adaptive down"), []))
    with pytest.raises(RuntimeError, match="adaptive down"):
        TE.run_direct(g, TU.handwritten_bfs_depth(0), engine="cuda",
                      fallback=True, device="cpu",
                      ft_config=FTConfig(max_retries=0))


def test_recoverable_rule():
    assert guard.FALLBACK_CHAIN == {"cuda_sharded": "cuda",
                                    "cuda": "adaptive"}
    assert guard.recoverable(RuntimeError("lowering failed"))
    assert guard.recoverable(torch.OutOfMemoryError("CUDA out of memory."))
    assert guard.out_of_memory(torch.OutOfMemoryError("CUDA out of memory."))
    assert not guard.out_of_memory(RuntimeError("CUDA out of memory."))
    for exc in (guard.NonConvergenceError("x"), ValueError("x"),
                TypeError("x"), AssertionError("x"),
                guard.KernelBuildError("x"), guard.KernelLaunchError("x"),
                RuntimeError("CUDA error: device-side assert triggered"),
                KeyboardInterrupt()):
        assert not guard.recoverable(exc), exc
    if hasattr(torch, "AcceleratorError"):
        assert not guard.recoverable(torch.AcceleratorError("x"))


def test_kernel_errors_are_runtime_errors(monkeypatch):
    """The wrappers' faults keep their messages and stay RuntimeErrors."""
    with pytest.raises(guard.KernelLaunchError,
                       match="CUDA pull kernel launch failed: cudaError 7"):
        launch.raise_on(7, "pull")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(build.Path, "is_file", lambda _self: False)
    with pytest.raises(RuntimeError, match="nvcc not found") as info:
        build.nvcc_path()
    assert isinstance(info.value, guard.KernelBuildError)
    assert issubclass(guard.KernelLaunchError, RuntimeError)
    # a round without P expressions has no kernel to generate
    from repro_torch.core.fusion import Prim
    from repro_torch.core.iterate import CompRuntime
    dk = dataclasses.replace(TU.handwritten_sssp(0), p_expr=None)
    comp = CompRuntime(0, "min", torch.float32, dk.p_fn, dk.init_fn, 0)
    with pytest.raises(guard.KernelBuildError, match="no P expression"):
        kops.sweep_round([comp], [Prim("min", 0)]).source()


def test_bounded_retry():
    fails = {"n": 2}

    def fn():
        if fails["n"] > 0:
            fails["n"] -= 1
            raise RuntimeError("transient")
        return 42

    out, retries = bounded_retry(fn, max_retries=3, backoff_s=0.0)
    assert (out, retries) == (42, 2)

    calls = {"n": 0}

    def always(exc_type):
        def f():
            calls["n"] += 1
            raise exc_type("boom")
        return f

    with pytest.raises(RuntimeError):      # budget exhausted → re-raise
        bounded_retry(always(RuntimeError), max_retries=2, backoff_s=0.0)
    assert calls["n"] == 3                 # initial call + 2 retries

    calls["n"] = 0
    with pytest.raises(ValueError):        # non-retryable → no retry at all
        bounded_retry(always(ValueError), max_retries=2, backoff_s=0.0,
                      retryable=lambda e: not isinstance(e, ValueError))
    assert calls["n"] == 1


def test_ft_config_defaults():
    """The reference's retry budget; the fields of later slices are not
    taken, so a caller who passes one learns it at once."""
    cfg = FTConfig()
    assert (cfg.max_retries, cfg.backoff_s) == (3, 0.05)
    assert [f.name for f in dataclasses.fields(FTConfig)] == [
        "max_retries", "backoff_s"]
    with pytest.raises(TypeError):
        FTConfig(ckpt_every=10)


def test_quickstart_matches_oracle_on_every_engine():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart_torch.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if "matches_oracle" in ln]
    assert [ln.split()[0] for ln in lines] == [
        f"engine={e}" for e in ("pull", "push", "adaptive", "dense",
                                "cuda")]
    assert all(ln.endswith("matches_oracle=True") for ln in lines), lines
