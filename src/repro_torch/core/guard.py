"""Structured errors of the guarded execution layer.

The port's copy of ``repro.core.guard``: the exception types every layer
raises (graph containers, reference engines, CUDA sweeps, the executor),
the ``FallbackEvent`` record (a batch's sequential degradation included)
and the engine fallback chain with its ``recoverable`` rule.
Dependency-free, so nothing here imports torch or another module of the
package.

One rule differs from the reference on purpose: a hand-written kernel that
fails to build (``KernelBuildError``) or to launch (``KernelLaunchError``),
and any CUDA runtime error, is never recoverable.  A fallback would finish
the query on the torch segment ops and hide the kernel's fault; a sticky
CUDA error has killed the device's context besides, so nothing on that
device would survive it.  The kernel engines (``kernels.ops.iterate_cuda``
and ``iterate_cuda_sharded``) raise every other failure of their own,
out-of-memory errors aside, as a ``KernelLaunchError``: only an
out-of-memory error, or a failure outside the kernel layer, takes the
chain.
"""
from __future__ import annotations

import dataclasses


class GuardError(Exception):
    """Base of every structured guard failure."""


class GraphValidationError(GuardError, ValueError):
    """The input graph (or a query source) violates the structural contract:
    edge indices out of [0, n), wrong dtype, non-finite weights/capacities,
    or a policy violation (self-loops/duplicates under an 'error' policy)."""


class TerminationPreconditionError(GuardError, ValueError):
    """The spec's termination condition is violated by this graph's actual
    edge-value ranges (e.g. strengthened C10 fails for min-plus once weights
    go negative).  ``condition`` names the violated paper condition."""

    def __init__(self, message: str, condition: str = "C10",
                 component: int = -1, detail: str = ""):
        super().__init__(message)
        self.condition = condition
        self.component = component
        self.detail = detail


class NonConvergenceError(GuardError, RuntimeError):
    """The fixpoint exhausted ``max_iter`` with vertices still active."""

    def __init__(self, message: str, iterations: int = 0, max_iter: int = 0,
                 active_count: int = 0, residual: float = float("nan")):
        super().__init__(message)
        self.iterations = iterations
        self.max_iter = max_iter
        self.active_count = active_count
        self.residual = residual


class DivergenceError(GuardError, RuntimeError):
    """The in-loop NaN/Inf sentinel fired: the iteration produced values
    outside the monoid's meaningful domain (a blown-up sum/prod component or
    a NaN anywhere)."""

    def __init__(self, message: str, iterations: int = 0):
        super().__init__(message)
        self.iterations = iterations


class CheckpointMismatchError(GuardError, RuntimeError):
    """A fixpoint checkpoint's fingerprint does not match the resuming
    executor — resuming would silently continue a DIFFERENT query."""


class KernelBuildError(RuntimeError):
    """A CUDA kernel library failed to build: no nvcc, or nvcc failed."""


class KernelLaunchError(RuntimeError):
    """A CUDA kernel's launch returned an error status, or the kernel engine
    failed around its launches (the error it raised is the ``__cause__``)."""


@dataclasses.dataclass(frozen=True)
class FallbackEvent:
    """One engine-degradation step, recorded in ``ExecStats.fallbacks``."""
    from_engine: str
    to_engine: str
    error: str

    def as_tuple(self):
        return (self.from_engine, self.to_engine, self.error)


def batch_degradation(engine: str, batch_size: int) -> FallbackEvent:
    """The planner's recorded decision that a [B]-source batch on an engine
    other than ``cuda`` runs as B sequential queries (the engine has no
    batched fixpoint).  Not an error: the event mirrors the plan's
    ``batch_lane="sequential"``, so batch degradations surface in the same
    ``ExecStats.fallbacks`` stream as guard fallbacks."""
    return FallbackEvent(
        f"batch[{batch_size}]:{engine}", f"sequential:{engine}",
        f"engine {engine!r} has no batched fixpoint; plan resolved "
        "batch_lane='sequential'")


# Degradation order: the sharded kernel engine falls back to the
# single-device one, which falls back to the adaptive reference engine
# (plain segment ops — the semantics every kernel engine is tested
# against).  ``adaptive`` is the floor: its failures propagate.
FALLBACK_CHAIN = {
    "cuda_sharded": "cuda",
    "cuda": "adaptive",
}


# Failures that retry/fallback must NEVER swallow: guard verdicts are
# engine-independent, programming errors are not infrastructure flakes,
# and a kernel's build or launch fault must surface, never be hidden
# behind the reference engine.
NON_RECOVERABLE = (GuardError, ValueError, TypeError, AssertionError,
                   KeyboardInterrupt, KernelBuildError, KernelLaunchError)


def _cuda_runtime_error(exc: BaseException) -> bool:
    """torch's ``AcceleratorError``, or a ``RuntimeError`` that carries a
    CUDA runtime error (its message starts with ``CUDA error``), matched
    without importing torch.  An out-of-memory error is neither."""
    if any(t.__name__ == "AcceleratorError" for t in type(exc).__mro__):
        return True
    return isinstance(exc, RuntimeError) and \
        str(exc).lstrip().startswith("CUDA error")


def out_of_memory(exc: BaseException) -> bool:
    """torch's ``OutOfMemoryError``, matched by class name without
    importing torch."""
    return any(t.__name__ == "OutOfMemoryError" for t in type(exc).__mro__)


def recoverable(exc: BaseException) -> bool:
    """True for infrastructure-shaped failures worth a retry or a fallback
    (an out-of-memory error, a failure outside the kernel layer); False for
    guard verdicts, programming errors, kernel build and launch faults and
    CUDA runtime errors, which must propagate unchanged."""
    return (isinstance(exc, Exception)
            and not isinstance(exc, NON_RECOVERABLE)
            and not _cuda_runtime_error(exc))
