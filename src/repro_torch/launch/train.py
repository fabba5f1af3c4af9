"""Training driver of the port: the train step + fault-tolerant loop +
checkpoints.

Usage (CPU smoke scale):
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --shape train_4k --steps 20 --smoke --device cpu

The port of ``repro.launch.train``: the same arguments, data pipelines
(``TokenStream(seed=17)`` for the LMs, ``dlrm_batch`` and the GNN batch
generators seeded by the step) and ``[train]`` line, with ``--device``
(default: the CUDA card; ``RuntimeError`` without one).  One process
drives one device: ``--host-mesh`` and ``--multi-pod`` are accepted for
the reference's command lines and ignored, and the micro-batch rule sees
one data shard (no mesh).  The parameters are drawn from
``torch.Generator`` seed 0 on the device (the reference's distributions,
not its draws).  The FT driver
checkpoints every ``--ckpt-every`` steps into ``--ckpt-dir`` and at the
end; ``--resume`` restarts from the latest checkpoint there, parameters,
optimizer state and data cursor.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="accepted for the reference's command lines; "
                         "ignored")
    ap.add_argument("--host-mesh", action="store_true",
                    help="accepted for the reference's command lines; "
                         "ignored")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import repro_torch.configs as configs
    from repro_torch.data import graphs as dgraphs
    from repro_torch.data.tokens import TokenStream
    from repro_torch.graph.structure import resolve_device
    from repro_torch.launch.workloads import build_workload
    from repro_torch.models import dlrm as dlrm_mod
    from repro_torch.models import gnn as gnn_mod
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime.ft import FTConfig, FaultTolerantDriver

    entry = configs.get(args.arch)
    wl = build_workload(args.arch, args.shape, None, smoke=args.smoke)
    assert wl.kind == "train", f"{args.shape} is not a training shape"
    cfg = wl.cfg
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    if entry.family == "lm":
        params = tf.init_params(cfg, gen, device=dev).tree()
    elif entry.family == "gnn":
        init = {"gat": gnn_mod.gat_init, "egnn": gnn_mod.egnn_init,
                "mgn": gnn_mod.mgn_init,
                "dimenet": gnn_mod.dimenet_init}[entry.kind]
        params = init(cfg, gen, device=dev).tree()
    else:
        params = dlrm_mod.dlrm_init(cfg, gen, device=dev).tree()
    opt_state = adamw_init(wl.opt_cfg, params)
    _, _, b_abs = wl.abstract_args

    # --- data pipeline ------------------------------------------------------
    if entry.family == "lm":
        bshape = b_abs["tokens"].shape
        stream = TokenStream(vocab=cfg.vocab, batch=bshape[0],
                             seq=bshape[1], seed=17)
        next_batch = stream.next_batch
        data_state = stream.state

        def data_restore(st):
            stream.seed, stream.step = int(st["seed"]), int(st["step"])
    else:
        counter = {"step": 0}

        def next_batch():
            counter["step"] += 1
            s = counter["step"]
            if entry.family == "recsys":
                return dgraphs.dlrm_batch(cfg, b_abs["dense"].shape[0],
                                          seed=s, device=dev)
            gen_b = {"gat": lambda: dgraphs.cora_batch(
                         n=b_abs["x"].shape[0], e=b_abs["src"].shape[0],
                         d_feat=cfg.d_in, seed=s, device=dev),
                     "egnn": lambda: dgraphs.egnn_batch(seed=s, device=dev),
                     "mgn": lambda: dgraphs.mesh_batch(seed=s, device=dev),
                     "dimenet": lambda: dgraphs.molecule_batch(
                         seed=s, device=dev)}[entry.kind]
            b = gen_b()
            b.pop("n_graphs", None)
            return b

        def data_state():
            return dict(counter)

        def data_restore(st):
            counter.update(step=int(st["step"]))

    ft = FaultTolerantDriver(
        FTConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
        lambda state, batch: _split(wl.step_fn(state[0], state[1], batch)),
        data_state, data_restore, state_devices=dev)

    state = (params, opt_state)
    start = 0
    if args.resume:
        try:
            state, start = ft.restore(state)
            print(f"resumed from step {start}")
        except FileNotFoundError:
            pass

    t0 = time.time()
    state, step, metrics = ft.train(state, args.steps, next_batch,
                                    start_step=start)
    dt = time.time() - t0
    loss = float(metrics["loss"]) if metrics else float("nan")
    print(f"[train] arch={args.arch} shape={args.shape} steps={step} "
          f"loss={loss:.4f} wall={dt:.1f}s "
          f"stragglers={ft.stats.stragglers} retries={ft.stats.retries}")
    return 0


def _split(out):
    params, opt_state, metrics = out
    return (params, opt_state), metrics


if __name__ == "__main__":
    raise SystemExit(main())
