"""Deterministic synthetic LM token stream, checkpointable.

The port of ``repro.data.tokens``.  A counter-based generator: each batch
is drawn from a ``torch.Generator`` seeded from (``seed``, ``step``)
alone, so the pipeline state is exactly ``{seed, step}`` and restoring
``step`` resumes the stream bit for bit.  The draws are torch's, not
JAX's threefry stream: the same state gives another batch than the
reference's, with the same law.  The stream has the reference's structure
(a truncated Zipf(1.1) unigram, every third token ``(t−2 + t−1) mod V``),
enough for a small model's loss to fall visibly.

Tokens and targets come out as int32 tensors on the CPU, as the
reference's are int32; a train step takes them to its device.
``host_batch`` is numpy in both packages and gives the reference's
arrays bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _seed_of(seed: int, step: int) -> int:
    """A 64-bit generator seed from (seed, step), well mixed so that
    neighbouring counters give unrelated streams."""
    return int(np.random.SeedSequence([int(seed), int(step)]).generate_state(
        1, np.uint64)[0])


@dataclasses.dataclass
class TokenStream:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    step: int = 0

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_state(cls, vocab, batch, seq, state):
        return cls(vocab=vocab, batch=batch, seq=seq,
                   seed=int(state["seed"]), step=int(state["step"]))

    def _zipf_tokens(self, gen, shape):
        u = torch.rand(shape, generator=gen, dtype=torch.float32)
        u = 1e-6 + (1.0 - 1e-6) * u                  # U[1e-6, 1)
        # inverse-CDF of a truncated Zipf(1.1)
        log_v = torch.log(torch.tensor(float(self.vocab)))
        ranks = torch.exp(u * log_v) - 1.0
        return torch.clamp(ranks.to(torch.int32), 0, self.vocab - 1)

    def next_batch(self) -> dict:
        gen = torch.Generator(device="cpu").manual_seed(
            _seed_of(self.seed, self.step))
        toks = self._zipf_tokens(gen, (self.batch, self.seq + 1))
        # order-2 structure: every third token repeats (t-2 + t-1) mod V
        mix = (torch.roll(toks, 2, dims=1) + torch.roll(toks, 1, dims=1)) \
            % self.vocab
        sel = (torch.arange(self.seq + 1) % 3 == 2)[None, :]
        toks = torch.where(sel, mix, toks)
        self.step += 1
        return {"tokens": toks[:, :-1].contiguous(),
                "targets": toks[:, 1:].contiguous()}


def host_batch(vocab: int, batch: int, seq: int, seed: int, step: int):
    """Stateless single-batch variant (numpy draws, the reference's) for
    tests and benchmarks: int32 tensors on the CPU."""
    rng = np.random.default_rng((seed << 20) ^ step)
    u = rng.random((batch, seq + 1))
    toks = np.clip((np.exp(u * np.log(vocab)) - 1).astype(np.int32),
                   0, vocab - 1)
    return {"tokens": torch.from_numpy(np.ascontiguousarray(toks[:, :-1])),
            "targets": torch.from_numpy(np.ascontiguousarray(toks[:, 1:]))}
