"""Fault-tolerance runtime: checkpoint/restart driver, straggler
detection, bounded retry, remesh.

The port of ``repro.runtime.ft``.  The mechanisms are host-side:

  * **Checkpoint/restart.**  The step loop snapshots every
    ``ckpt_every`` steps through ``CheckpointManager`` (async, atomic);
    on a persistent failure the driver restores the latest complete
    checkpoint, data-pipeline state included, and resumes.
  * **Bounded retry.**  A failing step retries up to ``max_retries``
    times with exponential backoff; past that the driver restores and
    restarts the budget, at most ``max_retries`` restores per incident.
    A step that writes its state in place and fails part way raises
    ``PartialStepError``: that state is never stepped again, the driver
    restores at once (or re-raises without a checkpoint to restore).
  * **Straggler detection.**  A per-step wall-clock EWMA; a step slower
    than ``straggler_factor ×`` the EWMA is flagged and counted in
    ``StepStats``, and does not move the baseline.
  * **Remesh.**  ``remesh(state, step, new_devices)`` moves the live state
    onto other devices through the checkpoint (save, then restore onto
    them) without losing the pipeline's position.

Where the reference waits on ``jax.block_until_ready``, the driver
synchronizes the state's device, and where it restores onto a tree of
shardings, it restores onto ``state_devices``: ``None`` (each leaf on the
device of its counterpart in ``state_like``), one device for every leaf,
or a tree of devices shaped like the state.  ``bounded_retry`` and
``FTConfig``'s ``max_retries`` / ``backoff_s`` are also the engine
fallback chain's retry budget (``core.engine``).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.tree import leaves


class PartialStepError(RuntimeError):
    """A step failed after it began to write its state in place (the
    AdamW update): part of the state holds the new step and part the old
    one, so the step must not be retried on it."""


def bounded_retry(fn: Callable[[], Any], max_retries: int, backoff_s: float,
                  retryable: Optional[Callable[[BaseException], bool]] = None):
    """Call ``fn()`` with bounded retry + exponential backoff.  Returns
    ``(result, retries_used)``.  ``retryable`` filters which exceptions are
    worth another attempt (default: any ``Exception``); a non-retryable
    failure — or exhausting the budget — re-raises the last error."""
    attempt = 0
    while True:
        try:
            return fn(), attempt
        except Exception as exc:
            if retryable is not None and not retryable(exc):
                raise
            attempt += 1
            if attempt > max_retries:
                raise
            time.sleep(backoff_s * (2 ** (attempt - 1)))


@dataclasses.dataclass
class FTConfig:
    """The driver's checkpoint, retry and straggler settings, with the
    reference's defaults (``max_retries`` / ``backoff_s`` also budget the
    fallback chain's ``bounded_retry``); ``ckpt_dir`` is ``repro_ckpt``
    under the temporary directory (``TMPDIR``, else ``/tmp``)."""
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    ckpt_every: int = 50
    max_retries: int = 3
    backoff_s: float = 0.05
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2


@dataclasses.dataclass
class StepStats:
    step: int = 0
    retries: int = 0
    restores: int = 0
    stragglers: int = 0
    ewma_step_s: float = 0.0
    last_step_s: float = 0.0


class StragglerDetector:
    def __init__(self, factor: float, alpha: float):
        self.factor = factor
        self.alpha = alpha
        self.ewma: Optional[float] = None
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        slow = self.ewma is not None and dt > self.factor * self.ewma
        if slow:
            self.flagged += 1
        else:
            # stragglers do not poison the baseline
            self.ewma = dt if self.ewma is None else \
                (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow


def _sync(tree):
    """Wait for the device of the tree's first tensor."""
    for leaf in leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.device.type == "cuda":
                torch.cuda.synchronize(leaf.device)
            return


class FaultTolerantDriver:
    """Wraps a step function with checkpoint/restart + retry.

    step_fn(state, batch) → (state, metrics); state is a tree (nested
    tuples, lists and dicts of tensors).  data_state_fn() → json-able
    dict; data_restore_fn(dict) rewinds the pipeline.  ``state_devices``:
    where ``restore`` puts the state (see the module docstring).
    """

    def __init__(self, cfg: FTConfig, step_fn: Callable,
                 data_state_fn: Callable[[], dict],
                 data_restore_fn: Callable[[dict], None],
                 state_devices: Any = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.data_state_fn = data_state_fn
        self.data_restore_fn = data_restore_fn
        self.state_devices = state_devices
        self.ckpt = CheckpointManager(cfg.ckpt_dir)
        self.detector = StragglerDetector(cfg.straggler_factor,
                                          cfg.ewma_alpha)
        self.stats = StepStats()

    # -- state management ---------------------------------------------------
    def maybe_checkpoint(self, state, step: int, force: bool = False):
        if force or (step > 0 and step % self.cfg.ckpt_every == 0):
            self.ckpt.save_async(step, state,
                                 extra={"data": self.data_state_fn()})

    def restore(self, state_like):
        state, step, extra = self.ckpt.restore_latest(
            state_like, devices=self.state_devices)
        if "data" in extra:
            self.data_restore_fn(extra["data"])
        self.stats.restores += 1
        return state, step

    def remesh(self, state, step: int, new_devices):
        """Move the state onto ``new_devices`` (a device, or a tree of
        devices shaped like the state): publish a checkpoint, then
        restore onto them."""
        self.ckpt.save_async(step, state,
                             extra={"data": self.data_state_fn()})
        self.ckpt.wait()
        self.state_devices = new_devices
        state, _ = self.restore(state)
        return state

    # -- the guarded step ---------------------------------------------------
    def run_step(self, state, batch, state_like=None):
        """Run one step with bounded retry; on exhausting the retry budget
        restores the latest checkpoint (at most ``max_retries`` restores for
        THIS incident) and re-raises once the restore budget is spent too.
        A ``PartialStepError`` skips the retries: the written state is
        restored at once, within the same restore budget."""
        attempt = 0
        incident_restores = 0
        while True:
            try:
                t0 = time.perf_counter()
                state2, metrics = self.step_fn(state, batch)
                _sync(state2)
                dt = time.perf_counter() - t0
                self.stats.last_step_s = dt
                if self.detector.observe(dt):
                    self.stats.stragglers += 1
                self.stats.ewma_step_s = self.detector.ewma or dt
                self.stats.step += 1
                return state2, metrics
            except Exception as exc:
                partial = isinstance(exc, PartialStepError)
                if not partial:
                    attempt += 1
                    self.stats.retries += 1
                if partial or attempt > self.cfg.max_retries:
                    # Retry budget spent, or the state written in part:
                    # restore and restart the budget.
                    # The abort decision uses the PER-INCIDENT restore
                    # count; the lifetime ``stats.restores`` keeps
                    # accumulating across healthy calls and must never
                    # abort a run that merely survived many incidents.
                    if state_like is None or \
                            incident_restores >= self.cfg.max_retries:
                        raise
                    state, _ = self.restore(state_like)
                    incident_restores += 1
                    attempt = 0
                    continue      # the restored state retries at once, no
                                  # backoff_s * 2**(-1) sleep from the reset
                time.sleep(self.cfg.backoff_s * (2 ** (attempt - 1)))

    def train(self, state, n_steps: int, next_batch: Callable[[], Any],
              start_step: int = 0, fail_hook: Optional[Callable] = None):
        """Step loop with periodic checkpointing.  ``fail_hook(step)`` lets
        tests inject failures."""
        step = start_step
        metrics = None
        while step < n_steps:
            batch = next_batch()
            if fail_hook is not None:
                fail_hook(step)
            state, metrics = self.run_step(state, batch, state_like=state)
            step += 1
            self.maybe_checkpoint(state, step)
        self.maybe_checkpoint(state, step, force=True)
        self.ckpt.wait()
        return state, step, metrics
