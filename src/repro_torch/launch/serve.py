"""Serving driver: prefill + batched greedy decode with a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
        [--smoke --device cpu] [--prompt-len 16 --decode-steps 8 --batch 2]

The port of ``repro.launch.serve``: the same flags (plus ``--device``,
default the CUDA card) and the same two printed lines.  The weights are
random, drawn from a seeded ``torch.Generator`` on the device, and so are
the prompts.  Requests are batched; decode is one token across the whole
batch per step, into a power-of-two cache.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch


@dataclasses.dataclass
class Generation:
    ids: torch.Tensor              # [B, decode_steps] greedy token ids
    prefill_logits: torch.Tensor   # [B, V] at the prompt's last position
    logits: torch.Tensor           # [B, V] of the last step
    prefill_s: float               # host clock, ending in a synchronize
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, prompts, decode_steps: int, cache: dict) -> Generation:
    """Greedy prefill of ``prompts`` [B, P], then ``decode_steps`` − 1
    batched decode steps (``decode_steps`` tokens in all, the first from
    the prefill), writing ``cache`` in place."""
    if decode_steps < 1:
        raise ValueError(f"decode_steps must be >= 1, got {decode_steps}")
    dev = prompts.device
    t0 = time.perf_counter()
    first, cache = model.prefill(prompts, cache)
    tok = torch.argmax(first, dim=-1)
    _sync(dev)
    t1 = time.perf_counter()
    out, logits = [tok], first
    for i in range(decode_steps - 1):
        logits, cache = model.decode_step(tok, prompts.shape[1] + i, cache)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    ids = torch.stack(out, dim=1)
    _sync(dev)
    return Generation(ids, first, logits, t1 - t0,
                      time.perf_counter() - t1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import repro_torch.configs as configs
    from repro_torch.graph.structure import resolve_device
    from repro_torch.models import transformer as tf

    entry = configs.get(args.arch)
    if entry.family != "lm":
        ap.error(f"serve.py drives LM archs, not {args.arch!r} "
                 f"({entry.family})")
    cfg = entry.smoke() if args.smoke else entry.full()

    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = tf.init_params(cfg, gen, device=dev)
    max_seq = args.prompt_len + args.decode_steps
    max_seq = 1 << (max_seq - 1).bit_length()          # pow2 cache
    cache = model.init_cache(args.batch, max_seq)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    res = generate(model, prompts, args.decode_steps, cache)
    tps = args.batch * args.decode_steps / (res.prefill_s + res.decode_s)
    print(f"[serve] arch={args.arch} batch={args.batch} "
          f"prompt={args.prompt_len} decoded={args.decode_steps} "
          f"tokens/s={tps:.1f}")
    print("sampled token ids:", res.ids[0][:8].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
