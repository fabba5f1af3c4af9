"""Per-(architecture × shape) training workloads of the port.

The port of the training kinds of ``repro.launch.workloads``:
``build_workload(arch, shape, mesh)`` returns a ``Workload`` whose
``step_fn(params, opt_state, batch) → (params, opt_state, metrics)`` is
the reference's train step (loss, gradients, AdamW; ``grad_fn(params,
batch) → (loss, gradients)`` is its first half alone), with the abstract
arguments as tensors on ``meta`` and the reference's ``meta`` bookkeeping
(model FLOPs, token counts, ``n_micro``).

  * ``params`` is the model's parameter tree (``model.tree()``: nested
    dicts and lists of tensors); each step wraps it in the model (the
    parameters share the tree's storage), takes the gradients with
    autograd and updates the tree and ``opt_state`` in place, as the
    reference's step donates them (a 3B-parameter model's state would
    not fit twice on one card).  A fault raised before the update leaves
    the state as it was; one raised during it is a
    ``runtime.ft.PartialStepError``, which the FT driver answers with a
    restore from the checkpoint, never a retry.
  * The LM step splits the batch into the reference's ``n_micro``
    micro-batches (strided: row i goes to micro-batch i mod n) and
    accumulates their gradients in float32, each cast then added, as the
    reference's scan does.
  * The GNN steps, and ``variant="dist"``'s vertex-cut step over a
    ``ShardMesh`` (its batch the k per-shard dicts of
    ``data.graphs.shard_batch``), and DLRM's.  The vertex-cut loss is one
    value on shard 0's device, so autograd gives the true gradient, the
    single device's (the reference's ``psum`` inside its loss scales each
    shard's gradient by k; not copied).
  * Every step runs with ``torch.use_deterministic_algorithms`` on, so
    the backward's gathers sum in a fixed order and a step repeats bit
    for bit.

The reference's sharding trees and ``donate`` have no counterpart; the
serving kinds (prefill, decode, serve, retrieval) and ``analysis=True``
belong to the dry-run's part of the port (ROADMAP Queue 1 item 12d) and
raise ``NotImplementedError``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Optional

import torch

import repro_torch.configs as configs
from repro_torch.graph.sampler import max_nodes_for
from repro_torch.launch.mesh import batch_axes, mesh_devices
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import leaves, unflatten

F32, I32 = torch.float32, torch.int32
_LATER = "ROADMAP Queue 1 item 12d"


@dataclasses.dataclass
class Workload:
    arch: str
    shape: str
    kind: str                   # train (the serving kinds: item 12d)
    step_fn: Callable
    # grad_fn(params, batch) → (loss, gradient tree): the step's first
    # half, which leaves the state untouched
    grad_fn: Callable
    abstract_args: tuple        # (params, opt_state, batch) on "meta"
    meta: dict
    cfg: Any                    # the model config the step runs
    opt_cfg: AdamWConfig


def _train(arch, shape_name, grad_fn, abstract_args, meta, cfg,
           opt_cfg) -> Workload:
    """The workload whose step is ``grad_fn`` then the in-place AdamW
    update, under deterministic algorithms."""
    def train_step(params, opt_state, b):
        with deterministic():
            loss, grads = grad_fn(params, b)
            params, opt_state, m = adamw_update(opt_cfg, params, grads,
                                                opt_state)
        return params, opt_state, {"loss": loss.detach(), **m}

    def grads_only(params, b):
        with deterministic():
            loss, grads = grad_fn(params, b)
        return loss.detach(), grads

    return Workload(arch, shape_name, "train", train_step, grads_only,
                    abstract_args, meta, cfg, opt_cfg)


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the block, the
    caller's setting restored after."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _dp(mesh) -> int:
    """The data-parallel width of the reference's micro-batch rule: the
    mesh's batch axes (1 without a mesh)."""
    if mesh is None:
        return 1
    return int(math.prod(mesh.shape[a] for a in batch_axes(mesh)))


def _batch_on(batch: dict, device) -> dict:
    """A batch's tensors on ``device`` (other values as they are)."""
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v
            for k, v in batch.items()}


def _autograd(loss, live):
    """d loss / d each of ``live``; a parameter the loss does not reach
    gets zeros (EGNN's last coordinate MLP), as JAX's gradient does."""
    return torch.autograd.grad(loss, live, allow_unused=True,
                               materialize_grads=True)


def _grads(loss, model):
    """The gradient tree of ``model``'s parameters."""
    live = leaves(model.tree(live=True))
    return unflatten(model.tree(), _autograd(loss, live))


# ---------------------------------------------------------------------------
# LM workloads
# ---------------------------------------------------------------------------

def n_micro_for(batch: int, seq: int, dp: int = 1, smoke: bool = False,
                analysis: bool = False) -> int:
    """The reference's micro-batch count: the largest divisor of the local
    batch that keeps a micro-batch near 8,192 local tokens (1 at smoke
    and analysis sizes)."""
    local_b = max(batch // dp, 1)
    if smoke or analysis:
        return 1
    target = max(1, (local_b * seq + 8191) // 8192)
    return max(d for d in range(1, local_b + 1)
               if local_b % d == 0 and d <= target)


def _lm_workload(arch: str, shape_name: str, shape: dict, mesh,
                 smoke: bool, cfg_changes: dict) -> Workload:
    entry = configs.get(arch)
    cfg = entry.smoke() if smoke else entry.full()
    dp = _dp(mesh)
    cfg = dataclasses.replace(
        cfg, hint_axes=tuple(mesh.axis_names) if mesh is not None else (),
        moe_groups=dp, **cfg_changes)
    seq, batch = shape["seq"], shape["batch"]
    if smoke:
        seq, batch = min(seq, 64), min(batch, 4)
    meta = {"params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "tokens": batch * seq, "seq": seq, "batch": batch}
    opt_cfg = AdamWConfig(
        state_dtype="bfloat16" if cfg.param_count() > 1e11 else "float32")
    params_abs = tf.init_params(cfg, None, device="meta").tree()
    opt_abs = adamw_init(opt_cfg, params_abs)
    batch_abs = {"tokens": _meta((batch, seq), I32),
                 "targets": _meta((batch, seq), I32)}
    n_micro = n_micro_for(batch, seq, dp, smoke)
    meta["n_micro"] = n_micro

    def grad_fn(params, b):
        model = tf.TransformerLM(cfg, params).trainable()
        dev = model.device
        b = {k: b[k].to(dev, torch.long) for k in ("tokens", "targets")}
        if n_micro == 1:
            loss = model.loss_fn(b)
            return loss, _grads(loss, model)
        live = leaves(model.tree(live=True))
        gsum = [torch.zeros(p.shape, dtype=F32, device=p.device)
                for p in live]
        lsum = torch.zeros((), dtype=F32, device=dev)
        for i in range(n_micro):
            # strided split: row r goes to micro-batch r mod n
            one = {k: v[i::n_micro] for k, v in b.items()}
            l = model.loss_fn(one)
            for acc, g in zip(gsum, _autograd(l, live)):
                acc.add_(g)                   # the bfloat16 grad in float32
            lsum = lsum + l.detach()
        for acc in gsum:
            acc.div_(n_micro)
        return lsum / n_micro, unflatten(params, gsum)

    # MODEL_FLOPS = 6·N_active·D tokens (fwd+bwd)
    meta["model_flops"] = 6 * cfg.active_param_count() * batch * seq
    return _train(arch, shape_name, grad_fn,
                  (params_abs, opt_abs, batch_abs), meta, cfg, opt_cfg)


# ---------------------------------------------------------------------------
# GNN workloads
# ---------------------------------------------------------------------------

def _gnn_sizes(shape: dict, smoke: bool):
    n, e = shape["n"], shape["e"]
    if shape["kind"] == "sample":
        bn, fan = shape["batch_nodes"], shape["fanout"]
        if smoke:
            bn, fan = 8, (3, 2)
        n = max_nodes_for(bn, list(fan))
        e = sum(bn * int(math.prod(fan[:i + 1])) for i in range(len(fan)))
    elif shape["kind"] == "batch":
        n = shape["n"] * shape["batch"]
        e = shape["e"] * shape["batch"]
    if smoke:
        n, e = min(n, 256), min(e, 1024)
    return n, e


def _gnn_batch_abs(kind: str, cfg, shape: dict, n: int, e: int,
                   smoke: bool) -> dict:
    """The batch's shapes and dtypes, as tensors on ``meta``."""
    ng = shape.get("batch", 32) if shape["kind"] == "batch" else \
        max(1, n // 30)
    if kind == "gat":
        return {"x": _meta((n, cfg.d_in), F32), "src": _meta((e,), I32),
                "dst": _meta((e,), I32), "y": _meta((n,), I32)}
    if kind == "egnn":
        return {"feats": _meta((n, cfg.d_in), F32),
                "coords": _meta((n, 3), F32),
                "src": _meta((e,), I32), "dst": _meta((e,), I32),
                "graph_id": _meta((n,), I32), "target": _meta((ng,), F32)}
    if kind == "mgn":
        return {"node_x": _meta((n, cfg.d_node_in), F32),
                "edge_x": _meta((e, cfg.d_edge_in), F32),
                "src": _meta((e,), I32), "dst": _meta((e,), I32),
                "target": _meta((n, cfg.d_out), F32)}
    if kind == "dimenet":
        avg_deg = max(1, min(e // max(n, 1), 32))
        t = min(e * avg_deg, 2_000_000_000 // 8)          # wedge count
        if smoke:
            t = min(t, 4096)
        return {"species": _meta((n,), I32), "coords": _meta((n, 3), F32),
                "src": _meta((e,), I32), "dst": _meta((e,), I32),
                "t_kj": _meta((t,), I32), "t_ji": _meta((t,), I32),
                "graph_id": _meta((n,), I32), "target": _meta((ng,), F32)}
    raise ValueError(kind)


_GNN_INIT = {"gat": gnn_mod.gat_init, "egnn": gnn_mod.egnn_init,
             "mgn": gnn_mod.mgn_init, "dimenet": gnn_mod.dimenet_init}


def _gnn_params_abs(kind: str, cfg):
    return _GNN_INIT[kind](cfg, None, device="meta").tree()


def _gnn_dist_workload(arch, shape_name, shape, mesh, smoke,
                       cfg_changes: dict) -> Workload:
    """The vertex-cut step of the full-graph MGN / EGNN cells over a
    ``ShardMesh``: the batch is the k per-shard dicts (``shard_batch`` of
    a ``dst_block_partition``), the loss ``*_loss_dist`` one value on
    shard 0's device, its gradient the single device's."""
    entry = configs.get(arch)
    kind = entry.kind
    cfg = entry.smoke() if smoke else entry.full()
    cfg = dataclasses.replace(cfg, **cfg_changes)
    n, e = _gnn_sizes(shape, smoke)
    k = mesh_devices(mesh)
    n_loc = -(-n // k)
    e_pad = max(1, int(math.ceil(e * 1.3 / k)))
    loss_fn = {"mgn": gnn_mod.mgn_loss_dist,
               "egnn": gnn_mod.egnn_loss_dist}[kind]
    opt_cfg = AdamWConfig()
    params_abs = _gnn_params_abs(kind, cfg)
    opt_abs = adamw_init(opt_cfg, params_abs)
    shard = {"src": _meta((e_pad,), I32), "dst": _meta((e_pad,), I32),
             "emask": _meta((e_pad,), torch.bool),
             "nmask": _meta((n_loc,), torch.bool)}
    if kind == "mgn":
        shard.update(node_x=_meta((n_loc, cfg.d_node_in), F32),
                     edge_x=_meta((e_pad, cfg.d_edge_in), F32),
                     target=_meta((n_loc, cfg.d_out), F32))
    else:
        shard.update(feats=_meta((n_loc, cfg.d_in), F32),
                     coords=_meta((n_loc, 3), F32),
                     target=_meta((n_loc, cfg.d_out), F32))
    batch_abs = [dict(shard) for _ in range(k)]

    def grad_fn(params, shards):
        model = gnn_mod.GNN(cfg, params).trainable()
        loss = loss_fn(cfg, model, shards, mesh)
        return loss, _grads(loss, model)

    flat = {key: torch.empty((k * v.shape[0],) + v.shape[1:], dtype=v.dtype,
                             device="meta") for key, v in shard.items()}
    meta = {"n": n, "e": e, "variant": "dist", "shards": k,
            "model_flops": _gnn_model_flops(kind, cfg, n, e, flat)}
    return _train(arch, shape_name, grad_fn,
                  (params_abs, opt_abs, batch_abs), meta, cfg, opt_cfg)


def _gnn_workload(arch: str, shape_name: str, shape: dict, mesh,
                  smoke: bool, cfg_changes: dict) -> Workload:
    entry = configs.get(arch)
    cfg = entry.smoke() if smoke else entry.full()
    kind = entry.kind
    if kind == "gat":
        cfg = dataclasses.replace(cfg, d_in=shape.get("d_feat", cfg.d_in))
    cfg = dataclasses.replace(cfg, **cfg_changes)
    n, e = _gnn_sizes(shape, smoke)
    opt_cfg = AdamWConfig()
    params_abs = _gnn_params_abs(kind, cfg)
    opt_abs = adamw_init(opt_cfg, params_abs)
    batch_abs = _gnn_batch_abs(kind, cfg, shape, n, e, smoke)

    def grad_fn(params, b):
        model = gnn_mod.GNN(cfg, params).trainable()
        loss = model.loss(_batch_on(b, model.device))
        return loss, _grads(loss, model)

    meta = {"n": n, "e": e,
            "model_flops": _gnn_model_flops(kind, cfg, n, e, batch_abs)}
    return _train(arch, shape_name, grad_fn,
                  (params_abs, opt_abs, batch_abs), meta, cfg, opt_cfg)


def _gnn_model_flops(kind, cfg, n, e, batch_abs) -> float:
    """Hand-derived useful FLOPs (fwd+bwd ≈ 3× fwd matmul flops)."""
    if kind == "gat":
        total, d_in = 0, cfg.d_in
        for li in range(cfg.n_layers):
            last = li == cfg.n_layers - 1
            h = 1 if last else cfg.n_heads
            d_out = cfg.n_classes if last else cfg.d_hidden
            total += 2 * n * d_in * h * d_out + 6 * e * h
            d_in = d_out if last else h * d_out
        return 3 * total
    if kind == "egnn":
        d = cfg.d_hidden
        per_layer = 2 * e * (2 * d + 1) * d + 2 * e * d * d * 2 \
            + 2 * n * 2 * d * d
        return 3 * cfg.n_layers * per_layer
    if kind == "mgn":
        d = cfg.d_hidden
        per_layer = 2 * e * (3 * d) * d + 2 * e * d * d \
            + 2 * n * (2 * d) * d + 2 * n * d * d
        return 3 * cfg.n_layers * per_layer
    if kind == "dimenet":
        d = cfg.d_hidden
        t = batch_abs["t_kj"].shape[0]
        per_block = (2 * e * d * d                      # w_kj
                     + 2 * t * d * cfg.n_bilinear * d   # bilinear
                     + 2 * e * d * d * 2 + 2 * e * d * d)
        return 3 * cfg.n_blocks * per_block
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# DLRM workloads
# ---------------------------------------------------------------------------

def _dlrm_workload(arch: str, shape_name: str, shape: dict, mesh,
                   smoke: bool, cfg_changes: dict) -> Workload:
    entry = configs.get(arch)
    cfg = entry.smoke() if smoke else entry.full()
    cfg = dataclasses.replace(cfg, **cfg_changes)
    batch = shape["batch"]
    if smoke:
        batch = min(batch, 32)
    meta = {"params": cfg.param_count(), "batch": batch}
    if shape["kind"] != "train":
        raise NotImplementedError(
            f"{arch} {shape_name}: the {shape['kind']} kind of "
            f"build_workload comes with {_LATER}")
    opt_cfg = AdamWConfig()
    params_abs = dlrm_mod.dlrm_init(cfg, None, device="meta").tree()
    opt_abs = adamw_init(opt_cfg, params_abs)
    sparse = (batch, cfg.n_sparse) if cfg.multi_hot == 1 else \
        (batch, cfg.n_sparse, cfg.multi_hot)
    batch_abs = {"dense": _meta((batch, cfg.n_dense), F32),
                 "sparse": _meta(sparse, I32), "label": _meta((batch,), F32)}

    def grad_fn(params, b):
        model = dlrm_mod.DLRM(cfg, params).trainable()
        loss = model.loss(_batch_on(b, model.device))
        return loss, _grads(loss, model)

    meta["model_flops"] = 3 * batch * _dlrm_dense_flops(cfg)
    return _train(arch, shape_name, grad_fn,
                  (params_abs, opt_abs, batch_abs), meta, cfg, opt_cfg)


def _dlrm_dense_flops(cfg) -> float:
    bot = sum(2 * a * b for a, b in zip(cfg.bot_mlp[:-1], cfg.bot_mlp[1:]))
    dims = [cfg.d_interact] + list(cfg.top_mlp_hidden)
    top = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    inter = 2 * cfg.n_feats * cfg.n_feats * cfg.embed_dim
    return bot + top + inter


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def build_workload(arch: str, shape_name: str, mesh=None,
                   smoke: bool = False, analysis: bool = False,
                   variant: str = "baseline",
                   shape_changes: Optional[dict] = None,
                   cfg_changes: Optional[dict] = None) -> Workload:
    """The training workload of (``arch``, ``shape_name``) on ``mesh`` (a
    ``ShardMesh``, or None for one device).  ``shape_changes`` cuts the
    shape (e.g. ``{"batch": 4}``) and ``cfg_changes`` replaces config
    fields (e.g. ``{"n_layers": 4}``, DLRM's ``{"vocab": …}``) before the
    workload is built; the reference's rules (``n_micro``, the smoke caps)
    apply to the cut shape, and ``meta["cuts"]`` lists the cuts."""
    if analysis:
        raise NotImplementedError(
            f"analysis=True (the dry-run's lowering) comes with {_LATER}")
    entry = configs.get(arch)
    shape = dict(entry.shapes[shape_name], **(shape_changes or {}))
    changes = dict(cfg_changes or {})
    if entry.family == "lm":
        if shape["kind"] != "train":
            raise NotImplementedError(
                f"{arch} {shape_name}: the {shape['kind']} kind of "
                f"build_workload comes with {_LATER}")
        wl = _lm_workload(arch, shape_name, shape, mesh, smoke, changes)
    elif entry.family == "gnn":
        if variant == "dist" and entry.kind in ("mgn", "egnn"):
            if mesh is None:
                raise ValueError("the vertex-cut step needs a ShardMesh")
            wl = _gnn_dist_workload(arch, shape_name, shape, mesh, smoke,
                                    changes)
        else:
            wl = _gnn_workload(arch, shape_name, shape, mesh, smoke,
                               changes)
    elif entry.family == "recsys":
        wl = _dlrm_workload(arch, shape_name, shape, mesh, smoke, changes)
    else:
        raise ValueError(f"{arch}: family {entry.family} has no shaped "
                         f"workloads")
    wl.meta["cuts"] = {**{k: [entry.shapes[shape_name].get(k), v]
                          for k, v in (shape_changes or {}).items()},
                       **{k: v for k, v in changes.items()}}
    return wl


def all_cells():
    """The 40 assigned (arch × shape) cells, with skip annotations."""
    cells = []
    for arch in configs.ASSIGNED:
        for shape in configs.get(arch).shapes:
            cells.append((arch, shape, configs.skip_reason(arch, shape)))
    return cells
