"""Structured errors of the guarded execution layer.

The port's copy of ``repro.core.guard``: the exception types every layer
raises (graph containers, reference engines, CUDA sweeps, the executor) and
the ``FallbackEvent`` record.  Dependency-free, so nothing here imports
torch or another module of the package.  The engine fallback chain belongs
to a later slice of the port (``fallback=True`` raises ``NotImplementedError``
in ``core.engine``).
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


@dataclasses.dataclass(frozen=True)
class FallbackEvent:
    """One engine-degradation step, recorded in ``ExecStats.fallbacks``."""
    from_engine: str
    to_engine: str
    error: str

    def as_tuple(self):
        return (self.from_engine, self.to_engine, self.error)
