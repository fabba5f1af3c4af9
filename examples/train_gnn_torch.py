"""Train a GNN end to end with the PyTorch port: GAT node classification
on a synthetic cora-shaped graph, with the FT driver, checkpointing and
loss tracking.

    PYTHONPATH=src python examples/train_gnn_torch.py --device cpu [--steps 60]

Without ``--device`` it runs on the CUDA card.  The loss must fall: this
is the port of ``examples/train_gnn.py``, the few-hundred-steps
end-to-end driver at laptop scale.
"""
import argparse
import dataclasses
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import repro_torch.configs as configs  # noqa: E402
from repro_torch.data import graphs as dg  # noqa: E402
from repro_torch.graph.structure import resolve_device  # noqa: E402
from repro_torch.models import gnn as G  # noqa: E402
from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa: E402
                                     adamw_update)
from repro_torch.tree import leaves, unflatten  # noqa: E402
from repro_torch.runtime.ft import FTConfig, FaultTolerantDriver  # noqa


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = dataclasses.replace(configs.get("gat-cora").full(), n_layers=2,
                              d_hidden=8, n_heads=8, d_in=128, n_classes=7)
    batch = dg.cora_batch(n=400, e=2400, d_feat=cfg.d_in, seed=0,
                          device=dev)
    params = G.gat_init(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev).tree()
    start = [p.clone() for p in leaves(params)]
    opt_cfg = AdamWConfig(lr=5e-3, warmup_steps=10, total_steps=args.steps)

    def step(state, b):
        params, opt = state
        model = G.GNN(cfg, params).trainable()
        loss = model.loss(b)
        grads = unflatten(params, torch.autograd.grad(
            loss, leaves(model.tree(live=True))))
        params, opt, m = adamw_update(opt_cfg, params, grads, opt)
        return (params, opt), {"loss": loss.detach(), **m}

    ckpt_dir = tempfile.mkdtemp(prefix="gat_ckpt_")
    counter = {"step": 0}
    ft = FaultTolerantDriver(
        FTConfig(ckpt_dir=ckpt_dir, ckpt_every=25),
        step, lambda: dict(counter),
        lambda st: counter.update(step=int(st["step"])))

    def next_batch():
        counter["step"] += 1
        return batch

    state, n, _ = ft.train((params, adamw_init(opt_cfg, params)),
                           args.steps, next_batch)
    with torch.no_grad():
        l0 = float(G.GNN(cfg, unflatten(params, start)).loss(batch))
        trained = G.GNN(cfg, state[0])
        l1 = float(trained.loss(batch))
        pred = trained(batch["x"], batch["src"], batch["dst"],
                       batch["x"].shape[0]).argmax(-1)
        acc = float((pred == batch["y"].long()).float().mean())
    print(f"[train_gnn] steps={n} loss {l0:.4f} -> {l1:.4f} "
          f"(train acc {acc:.2f}); checkpoints in {ckpt_dir}")
    assert l1 < l0, "loss did not fall"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
