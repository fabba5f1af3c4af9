"""Fingerprinted checkpointing for chunked fixpoints.

The port of ``repro.checkpoint.fixpoint``.  ``kernels.ops.iterate_cuda``
can run its loop in host-stepped chunks; after each chunk the full loop
carry (state tuple, frontier, counters, sentinel flags) is snapshotted here
through ``checkpoint.CheckpointManager`` (atomic tmp+rename directories,
retention, async writer).  Because the carry is the loop state, restoring
it and continuing reproduces the exact iteration sequence: a killed and
resumed run is bitwise identical to an uninterrupted one.

The manifest's ``extra`` dict records a JSON fingerprint of the query
(graph shape, plan structure, component signature, sources, knobs).
``restore`` refuses a mismatching fingerprint with
``CheckpointMismatchError`` rather than silently continuing a different
query's fixpoint.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.checkpoint.ckpt import CheckpointManager, latest_step
from repro_torch.core.guard import CheckpointMismatchError


class FixpointCheckpointer:
    """Carry snapshots for one chunked fixpoint run.

    ``save`` is durable before it returns (async write + join, which
    raises what the writer raised): the chunk loop must not start the next
    chunk while the previous snapshot could still be lost to a crash.
    """

    def __init__(self, directory: str, fingerprint: dict, keep: int = 2):
        self.directory = str(directory)
        self.fingerprint = fingerprint
        self.manager = CheckpointManager(self.directory, keep=keep)

    def save(self, carry: Any, step: int) -> None:
        self.manager.save_async(int(step), carry,
                                extra={"fingerprint": self.fingerprint})
        self.manager.wait()

    def restore(self, carry_like: Any) -> Optional[Any]:
        """Newest snapshot restored into ``carry_like``'s structure, devices
        and dtypes, or None when the directory holds no completed
        checkpoint yet (fresh start).  Raises ``CheckpointMismatchError`` if
        the snapshot was written under a different fingerprint."""
        if latest_step(self.directory) is None:
            return None
        carry, step, extra = self.manager.restore_latest(carry_like)
        stored = (extra or {}).get("fingerprint")
        if stored != self.fingerprint:
            raise CheckpointMismatchError(
                f"checkpoint under {self.directory} (step {step}) was "
                f"written for a different fixpoint: stored fingerprint "
                f"{stored!r} != expected {self.fingerprint!r}")
        return carry
