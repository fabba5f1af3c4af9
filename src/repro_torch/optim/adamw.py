"""AdamW with global-norm clipping and a cosine schedule.

The port of ``repro.optim.adamw`` over the port's parameter trees (nested
dicts and lists of tensors, ``optim.tree``).  The update is the
reference's arithmetic, all in float32: the moments, ``b ** step`` in
float32, the weight decay inside ``lr · delta``, the results cast back to
the parameter's and the state's dtypes (``state_dtype``: float32, or
bfloat16 for the configs above 1e11 parameters).  ``torch.optim.AdamW``
is not used: it orders the arithmetic otherwise.

Eager torch holds every temporary that XLA fuses, so a leaf is updated in
row chunks of at most ``_CHUNK`` elements: the transients stay a few
chunks of float32 whatever the leaf's size.  The new parameters, ``m``
and ``v`` are written into the given tensors (the reference's donated
step: a 3B-parameter model's parameters and float32 moments take 36 GB,
and a second copy would not fit beside them on one card); a caller that
keeps the old state clones it first.  A fault raised once the writes have
begun leaves some leaves at the new step and the rest at the old one, so
it is raised as ``runtime.ft.PartialStepError``: the state must be
restored, not stepped again.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.runtime.ft import PartialStepError
from repro_torch.tree import leaves, unflatten

# float32 elements of one leaf chunk of the update (64 MB)
_CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    state_dtype: str = "float32"       # "bfloat16" for the 671B config
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_lr(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an int or a tensor), float32: linear
    warmup, then a cosine decay to ``min_lr_frac`` of ``lr``."""
    if not isinstance(step, torch.Tensor):
        step = torch.tensor(float(step))
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def _rows(x: torch.Tensor):
    """Row slices of ``x`` of at most ``_CHUNK`` elements each (the whole
    tensor when it is small or 0-d)."""
    if x.dim() == 0 or x.numel() <= _CHUNK:
        yield x
        return
    per_row = max(1, x[0].numel())
    step = max(1, _CHUNK // per_row)
    for r0 in range(0, x.shape[0], step):
        yield x[r0:r0 + step]


def _square_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ x² in float64, chunk by chunk (chunk sums added in row order)."""
    total = None
    for c in _rows(x):
        s = torch.sum(torch.square(c.to(torch.float64)))
        total = s if total is None else total + s
    return total


def global_norm(tree) -> torch.Tensor:
    """√(Σ over the leaves of Σ x²), on the first leaf's device, returned
    in float32.  The squares are summed in float64: where the reference's
    float32 sum is finite the two agree to its rounding, and a gradient
    past ≈ 1.8e19 (the random 28-layer llama3.2-3B's reaches ≈ 1e20)
    gives a finite norm where the reference's Σ x² overflows to inf and
    its clip zeroes the step."""
    flat = leaves(tree)
    dev = flat[0].device
    total = 0
    for x in flat:
        total = total + _square_sum(x).to(dev)
    return torch.sqrt(total).to(torch.float32)


def adamw_init(cfg: AdamWConfig, params) -> dict:
    """Zero moments of ``state_dtype`` beside each parameter (on its
    device) and ``step`` 0 (int32, on the first parameter's device)."""
    dt = getattr(torch, cfg.state_dtype)
    flat = leaves(params)

    def zeros():
        return unflatten(params, [torch.zeros(p.shape, dtype=dt,
                                              device=p.device)
                                  for p in flat])
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32,
                                device=flat[0].device)}


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state):
    """Returns (params, new_state, metrics {grad_norm, lr}): ``params`` and
    the new state's ``m`` and ``v`` are the given trees, written in place.

    ``grads`` may be of any float dtype (the bfloat16 gradients of a
    bfloat16 model, or float32 accumulators); each is taken to float32,
    scaled by the clip factor there, as the reference's float32 scale
    promotes it; ``grads`` is never written.  A fault during the writes
    is raised as ``PartialStepError`` (its cause kept)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    lr = cosine_lr(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    sdt = getattr(torch, cfg.state_dtype)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)

    def upd(p, g, m, v):
        dev = p.device
        lr_d, bc1_d, bc2_d = lr.to(dev), bc1.to(dev), bc2.to(dev)
        scale_d = None if scale is None else scale.to(dev)
        for pc, gc, mc, vc in zip(_rows(p), _rows(g), _rows(m), _rows(v)):
            gf = gc.to(torch.float32)
            if scale_d is not None:
                gf = gf * scale_d
            m32 = mc.to(torch.float32) * b1 + gf * (1 - b1)
            v32 = vc.to(torch.float32) * b2 + gf * gf * (1 - b2)
            mhat = m32 / bc1_d
            vhat = v32 / bc2_d
            p32 = pc.to(torch.float32)
            delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
                + cfg.weight_decay * p32
            pc.copy_((p32 - lr_d * delta).to(p.dtype))
            mc.copy_(m32.to(sdt))
            vc.copy_(v32.to(sdt))

    flat_p = leaves(params)
    flat_g, flat_m, flat_v = (leaves(t) for t in (grads, state["m"],
                                                  state["v"]))
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and the moments differ in leaves")
    try:
        for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
            upd(p, g, m, v)
    except Exception as exc:
        raise PartialStepError(
            "AdamW failed while writing the state in place") from exc
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
