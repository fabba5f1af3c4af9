"""The port's training path against the JAX package's, on the CPU.

``repro_torch.runtime.ft``, ``repro_torch.checkpoint`` (bfloat16 leaves),
``repro_torch.launch.workloads`` and ``repro_torch.launch.train``:

  * the FT driver tests of the reference's ``tests/test_runtime.py`` run
    on the port: straggler detection, the loop and its resume, a
    transient retry, the restore after a persistent failure, the
    per-incident restore budget, no fractional backoff, and a remesh onto
    other devices; and a fault inside the in-place AdamW update, restored
    from the checkpoint or raised, never retried;
  * a bfloat16 checkpoint round trip, the port reading a checkpoint the
    reference wrote bitwise, and the port's chunk files and manifest
    byte-equal to the reference's for the same leaves;
  * one train step per family (llama3.2-3b, gat-cora, dlrm-rm2 at
    ``smoke()``) against the reference's ``build_workload`` step on the
    reference's own parameters: loss and gradient norm within rtol 1e-5,
    the moments within the gradient bound 1e-4·(|x| + max|x|), the
    parameters within 2·lr (an element whose gradient is near zero may
    flip the sign of its first Adam step) plus rtol 1e-5;
  * the LM step with ``n_micro`` 2: bitwise the reference's recipe
    (per-micro-batch gradients, each cast to float32 and added, divided by
    2) in bfloat16, and within float32 summation of ``n_micro`` 1;
  * ``launch.train.main --smoke --device cpu`` for one arch per family,
    stopped, resumed with ``--resume`` and held bitwise against an
    uninterrupted run.
"""
import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.checkpoint import ckpt as RCk
from repro.data import graphs as RDG
from repro.launch import workloads as RW
from repro.models import dlrm as RD
from repro.models import gnn as RG
from repro.models import transformer as RT
from repro.optim.adamw import adamw_init as r_adamw_init
from repro_torch.checkpoint import ckpt as TCk
from repro_torch.data.tokens import TokenStream, host_batch
from repro_torch.launch import train as TTr
from repro_torch.launch import workloads as TW
from repro_torch.models import dlrm as TD
from repro_torch.models import gnn as TG
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as TA
from repro_torch.tree import leaves, tree_map, unflatten
from repro_torch.runtime import ft as TFt
from repro_torch.runtime.ft import (FTConfig, FaultTolerantDriver,
                                    StragglerDetector)

KEY = jax.random.PRNGKey(0)


@pytest.fixture
def tmp_ckpt(tmp_path):
    return str(tmp_path / "ckpt")


# ---------------------------------------------------------------------------
# The FT driver (the reference's tests/test_runtime.py, on the port)
# ---------------------------------------------------------------------------

def test_straggler_detector():
    d = StragglerDetector(factor=3.0, alpha=0.5)
    for _ in range(5):
        assert not d.observe(0.10)
    assert d.observe(1.0)                 # 10× the EWMA → flagged
    assert d.flagged == 1
    assert not d.observe(0.1)             # baseline not poisoned


def _driver(tmp_ckpt, step_fn, stream, **kw):
    def restore(st):
        stream.seed, stream.step = int(st["seed"]), int(st["step"])
    return FaultTolerantDriver(
        FTConfig(ckpt_dir=tmp_ckpt, ckpt_every=2, max_retries=2,
                 backoff_s=0.001), step_fn, data_state_fn=stream.state,
        data_restore_fn=restore, **kw)


def _w(x):
    return {"w": torch.full((), float(x))}


def _good(state, batch):
    return {"w": state["w"] + 1.0}, {}


def test_ft_train_loop_and_resume(tmp_ckpt):
    stream = TokenStream(vocab=17, batch=2, seq=4, seed=1)

    def step_fn(state, batch):
        return {"w": state["w"] + 1.0}, {"loss": torch.tensor(1.0)}

    ft = _driver(tmp_ckpt, step_fn, stream)
    state, step, _ = ft.train(_w(0), 5, stream.next_batch)
    assert step == 5 and float(state["w"]) == 5.0
    assert ft.stats.step == 5 and ft.stats.retries == 0
    # resume from the published checkpoint (data cursor restored too)
    stream.step = 0
    ft2 = _driver(tmp_ckpt, step_fn, stream)
    restored, rstep = ft2.restore(_w(0))
    assert rstep == 5 and float(restored["w"]) == 5.0
    assert stream.step == 5


def test_ft_retry_recovers_from_transient_failure(tmp_ckpt):
    stream = TokenStream(vocab=17, batch=2, seq=4, seed=1)
    fails = {"n": 2}

    def step_fn(state, batch):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise RuntimeError("injected transient fault")
        return {"w": state["w"] + 1.0}, {}

    ft = _driver(tmp_ckpt, step_fn, stream)
    state, _ = ft.run_step(_w(0), stream.next_batch())
    assert float(state["w"]) == 1.0
    assert ft.stats.retries == 2


def _flaky_driver(tmp_ckpt, stream, crash):
    def flaky(st, batch):
        if crash["on"]:
            raise RuntimeError("persistent node failure")
        return {"w": st["w"] + 1.0}, {}

    ft2 = _driver(tmp_ckpt, flaky, stream)
    orig_restore = ft2.restore

    def restore_and_heal(like):
        crash["on"] = False
        return orig_restore(like)

    ft2.restore = restore_and_heal
    return ft2


def test_ft_restore_after_persistent_failure(tmp_ckpt):
    stream = TokenStream(vocab=17, batch=2, seq=4, seed=1)
    ft = _driver(tmp_ckpt, _good, stream)
    ft.train(_w(0), 4, stream.next_batch)                  # ckpt at 4
    ft2 = _flaky_driver(tmp_ckpt, stream, {"on": True})
    out, _ = ft2.run_step(_w(99), stream.next_batch(), state_like=_w(0))
    assert float(out["w"]) == 5.0          # restored 4.0 + one good step
    assert ft2.stats.restores == 1


def test_ft_restore_budget_is_per_incident(tmp_ckpt):
    """Three separate incidents, each healed by one restore: lifetime
    restores (3) exceed ``max_retries`` (2) and the run goes on."""
    stream = TokenStream(vocab=17, batch=2, seq=4, seed=1)
    ft = _driver(tmp_ckpt, _good, stream)
    ft.train(_w(0), 4, stream.next_batch)
    crash = {"on": False}
    ft2 = _flaky_driver(tmp_ckpt, stream, crash)
    for _ in range(3):
        crash["on"] = True
        out, _ = ft2.run_step(_w(99), stream.next_batch(), state_like=_w(0))
        assert float(out["w"]) == 5.0
    assert ft2.stats.restores == 3


def test_ft_persistent_failure_without_checkpoint_raises(tmp_ckpt):
    stream = TokenStream(vocab=17, batch=2, seq=4, seed=1)
    ft = _flaky_driver(tmp_ckpt, stream, {"on": True})
    with pytest.raises(RuntimeError):
        ft.run_step(_w(0), stream.next_batch())           # no state_like
    assert ft.stats.retries == 3


def test_ft_no_fractional_backoff_after_restore(tmp_ckpt, monkeypatch):
    sleeps = []
    monkeypatch.setattr(TFt.time, "sleep", sleeps.append)
    stream = TokenStream(vocab=17, batch=2, seq=4, seed=1)
    ft = _driver(tmp_ckpt, _good, stream)
    ft.train(_w(0), 4, stream.next_batch)
    ft2 = _flaky_driver(tmp_ckpt, stream, {"on": True})
    sleeps.clear()
    ft2.run_step(_w(0), stream.next_batch(), state_like=_w(0))
    b = ft2.cfg.backoff_s
    assert sleeps == [b, 2 * b]            # attempts 1..2 only, no 0.5·b


def _adamw_step(cfg):
    """A step whose state is (params, AdamW state), updated in place."""
    def step_fn(state, batch):
        params, opt = state
        grads = {k: torch.full_like(v, 0.5) for k, v in params.items()}
        params, opt, m = TA.adamw_update(cfg, params, grads, opt)
        return (params, opt), m
    return step_fn


@pytest.mark.parametrize("checkpoint", [True, False])
def test_ft_fault_inside_update_is_restored_not_retried(
        tmp_ckpt, monkeypatch, checkpoint):
    """A fault inside the in-place AdamW update, after its first leaf is
    written: the driver restores the checkpoint and steps once from it
    (bitwise one clean step), or without a checkpoint raises
    ``PartialStepError`` with the state stepped at most once, never
    retried on the half-written state."""
    cfg = TA.AdamWConfig(warmup_steps=1, lr=1e-2)
    params = {"a": torch.arange(6.0), "b": torch.ones(4),
              "c": torch.full((3,), -2.0)}
    state = (params, TA.adamw_init(cfg, params))
    start = tree_map(torch.clone, state)
    want, _ = _adamw_step(cfg)(tree_map(torch.clone, state), None)
    stream = TokenStream(vocab=17, batch=2, seq=4, seed=1)
    ft = _driver(tmp_ckpt, _adamw_step(cfg), stream)
    if checkpoint:
        ft.maybe_checkpoint(state, 0, force=True)
        ft.ckpt.wait()

    second, rows, calls = params["b"], TA._rows, []

    def faulty_rows(x):
        if x is second:
            calls.append(1)
            raise RuntimeError("injected fault in the update")
        return rows(x)

    monkeypatch.setattr(TA, "_rows", faulty_rows)
    if checkpoint:
        out, _ = ft.run_step(state, stream.next_batch(), state_like=state)
        assert ft.stats.restores == 1
        for x, y in zip(leaves(out), leaves(want)):
            assert torch.equal(x, y)
    else:
        with pytest.raises(TFt.PartialStepError):
            ft.run_step(state, stream.next_batch())
        # "a" took its one step, "b" and "c" none
        assert torch.equal(params["a"], want[0]["a"])
        for k in "bc":
            assert torch.equal(params[k], start[0][k])
    assert ft.stats.retries == 0 and len(calls) == 1


def test_remesh_moves_state_onto_other_devices(tmp_ckpt):
    """The state moves through the checkpoint onto the new devices (a
    tree of devices here: one leaf to ``meta``), values kept."""
    stream = TokenStream(vocab=17, batch=2, seq=4, seed=1)
    ft = _driver(tmp_ckpt, _good, stream)
    state = {"w": torch.arange(8.0), "b": torch.ones(3)}
    state2 = ft.remesh(state, 1, "cpu")
    assert torch.equal(state2["w"], state["w"]) and state2["w"] is not \
        state["w"]
    state3 = ft.remesh(state2, 2, {"w": "cpu", "b": "meta"})
    assert state3["b"].device.type == "meta"
    assert torch.equal(state3["w"], state["w"])
    assert ft.stats.restores == 2


# ---------------------------------------------------------------------------
# bfloat16 checkpoints
# ---------------------------------------------------------------------------

def _bf16_tree():
    rng = np.random.default_rng(0)
    big = rng.normal(size=(5, 7)).astype(np.float32)
    return ({"w": torch.from_numpy(big).to(torch.bfloat16),
             "s": torch.tensor(2.5, dtype=torch.bfloat16),
             "f": torch.arange(4, dtype=torch.float32)},
            {"w": jnp.asarray(big, jnp.bfloat16), "s": jnp.bfloat16(2.5),
             "f": jnp.arange(4, dtype=jnp.float32)})


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_bfloat16_checkpoint_round_trip(tmp_ckpt):
    tree, _ = _bf16_tree()
    TCk.save_checkpoint(tmp_ckpt, 3, tree)
    like = {k: torch.zeros_like(v) for k, v in tree.items()}
    got, step, _ = TCk.restore_checkpoint(tmp_ckpt, like)
    assert step == 3
    for k in tree:
        assert got[k].dtype == tree[k].dtype
        assert torch.equal(_bits(got[k]), _bits(tree[k]))
    # a numpy-like counterpart gets the bfloat16 tensor back on the CPU
    got, _, _ = TCk.restore_checkpoint(tmp_ckpt, {"w": 0, "s": 0, "f": 0})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(_bits(got["w"]), _bits(tree["w"]))


def test_bfloat16_checkpoint_is_the_reference_format(tmp_path):
    """The port's files byte-equal the reference's for the same leaves, and
    the port reads the reference's checkpoint bitwise."""
    tree, rtree = _bf16_tree()
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    RCk.save_checkpoint(a, 1, rtree, extra={"data": {"step": 4}})
    TCk.save_checkpoint(b, 1, tree, extra={"data": {"step": 4}})
    da, db = (os.path.join(d, "step_0000000001") for d in (a, b))
    names = sorted(os.listdir(da))
    assert names == sorted(os.listdir(db)) and "manifest.json" in names
    for name in names:
        assert filecmp.cmp(os.path.join(da, name), os.path.join(db, name),
                           shallow=False), name
    like = {k: torch.zeros_like(v) for k, v in tree.items()}
    got, _, extra = TCk.restore_checkpoint(a, like)
    assert extra == {"data": {"step": 4}}
    for k in tree:
        assert torch.equal(_bits(got[k]), _bits(tree[k]))


# ---------------------------------------------------------------------------
# One train step per family against the reference's
# ---------------------------------------------------------------------------

def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _host_mesh():
    """A one-device mesh whose axes the reference's sharding hints may
    name (``Auto`` axes)."""
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _ref_step(arch, shape, params, batch):
    mesh = _host_mesh()
    wl = RW.build_workload(arch, shape, mesh, smoke=True)
    opt = r_adamw_init(RW.AdamWConfig(), params)
    with mesh:
        return jax.jit(wl.step_fn)(params, opt, batch)


def _init_family(arch):
    """(reference params, port params tree, reference batch, port batch)."""
    entry = RC.get(arch)
    cfg = entry.smoke()
    tcfg = TW.build_workload(arch, _SHAPE[arch], None, smoke=True).cfg
    if entry.family == "lm":
        params = jax.jit(lambda k: RT.init_params(cfg, k))(KEY)
        tree = TT.load_reference_params(tcfg, jax.tree.map(np.asarray,
                                                           params),
                                        device="cpu").tree()
        hb = host_batch(cfg.vocab, 4, 64, seed=17, step=0)
        return params, tree, {k: jnp.asarray(v.numpy())
                              for k, v in hb.items()}, hb
    if entry.family == "gnn":
        params = jax.jit(lambda k: RG.gat_init(cfg, k))(KEY)
        tree = TG.load_reference_params(tcfg, jax.tree.map(np.asarray,
                                                           params),
                                        device="cpu").tree()
        b = RDG.cora_batch(n=256, e=1024, d_feat=cfg.d_in, seed=1)
    else:
        params = jax.jit(lambda k: RD.dlrm_init(cfg, k))(KEY)
        tree = TD.load_reference_params(tcfg, jax.tree.map(np.asarray,
                                                           params),
                                        device="cpu").tree()
        b = RDG.dlrm_batch(cfg, 32, seed=1)
    return params, tree, b, {k: torch.from_numpy(np.array(v))
                             for k, v in b.items()}


_SHAPE = {"llama3.2-3b": "train_4k", "gat-cora": "full_graph_sm",
          "dlrm-rm2": "train_batch"}


def _lm_pairs(port, ref):
    """Port leaves beside the reference's stacked leaves, layer by layer
    (the FFN set a layer does not run skipped)."""
    out = []
    for name in ("embed", "ln_f", "unembed"):
        out.append((port[name], ref[name]))
    for li, lp in enumerate(port["layers"]):
        for path, leaf in _walk(lp):
            node = ref["layers"]
            for k in path:
                node = node[k]
            out.append((leaf, node[li]))
    return out


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("arch", ["llama3.2-3b", "gat-cora", "dlrm-rm2"])
def test_train_step_matches_reference(arch):
    params, tree, rb, tb = _init_family(arch)
    rp, ropt, rm = _ref_step(arch, _SHAPE[arch], params, rb)
    wl = TW.build_workload(arch, _SHAPE[arch], None, smoke=True)
    opt = TA.adamw_init(wl.opt_cfg, tree)
    p, o, m = wl.step_fn(tree, opt, tb)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(rm[key]), rtol=1e-5)
    assert int(o["step"]) == int(ropt["step"]) == 1
    lr = float(rm["lr"])
    if RC.get(arch).family == "lm":
        ppairs = _lm_pairs(p, rp)
        mpairs = _lm_pairs(o["m"], ropt["m"])
        assert len(ppairs) == len(leaves(p))
    else:
        ppairs = list(zip(leaves(p), jax.tree.leaves(rp)))
        mpairs = list(zip(leaves(o["m"]), jax.tree.leaves(ropt["m"])))
    for got, want in ppairs:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=2 * lr)
    for got, want in mpairs:
        got, want = _np(got), _np(want)
        assert np.all(np.abs(got - want)
                      <= 1e-4 * (np.abs(want) + np.abs(want).max()))


def _clone(tree):
    return unflatten(tree, [x.clone() for x in leaves(tree)])


def _bf16_lm_workload():
    return TW.build_workload("llama3.2-3b", "train_4k", None, smoke=True,
                             cfg_changes={"dtype": "bfloat16",
                                          "param_dtype": "bfloat16"})


def test_lm_step_n_micro_2(monkeypatch):
    """n_micro 2 (strided micro-batches, float32 accumulation) bitwise the
    reference's recipe computed by hand, and within float32 summation of
    the n_micro 1 step."""
    wl1 = _bf16_lm_workload()
    gen = torch.Generator().manual_seed(0)
    base = TT.init_params(wl1.cfg, gen, device="cpu").tree()
    batch = host_batch(wl1.cfg.vocab, 4, 64, seed=3, step=0)

    # by hand: per micro-batch bfloat16 gradients, cast, add, halve
    model = TT.TransformerLM(wl1.cfg, base).trainable()
    live = leaves(model.tree(live=True))
    acc = [torch.zeros(x.shape, dtype=torch.float32) for x in live]
    lsum = torch.zeros(())
    b = {k: v.long() for k, v in batch.items()}
    for i in range(2):
        one = {k: v[i::2] for k, v in b.items()}
        loss = model.loss_fn(one)
        for a, g in zip(acc, torch.autograd.grad(loss, live)):
            assert g.dtype == torch.bfloat16
            a += g.float()
        lsum = lsum + loss.detach()
    grads = unflatten(base, [a / 2 for a in acc])
    hand_p, hand_o, hand_m = TA.adamw_update(
        wl1.opt_cfg, _clone(base), grads, TA.adamw_init(wl1.opt_cfg, base))

    monkeypatch.setattr(TW, "n_micro_for", lambda *a, **k: 2)
    wl2 = _bf16_lm_workload()
    assert wl2.meta["n_micro"] == 2
    p2 = _clone(base)
    p2, o2, m2 = wl2.step_fn(p2, TA.adamw_init(wl2.opt_cfg, p2), batch)
    assert float(m2["loss"]) == float(lsum / 2)
    assert float(m2["grad_norm"]) == float(hand_m["grad_norm"])
    for x, y in zip(leaves((p2, o2)), leaves((hand_p, hand_o))):
        assert torch.equal(x, y)

    # float32: n_micro 2 against 1
    monkeypatch.undo()
    wl1 = TW.build_workload("llama3.2-3b", "train_4k", None, smoke=True)
    f32 = TT.init_params(wl1.cfg, torch.Generator().manual_seed(0),
                         device="cpu").tree()
    p1 = _clone(f32)
    p1, o1, m1 = wl1.step_fn(p1, TA.adamw_init(wl1.opt_cfg, p1), batch)
    monkeypatch.setattr(TW, "n_micro_for", lambda *a, **k: 2)
    wl2 = TW.build_workload("llama3.2-3b", "train_4k", None, smoke=True)
    p2 = _clone(f32)
    p2, o2, m2 = wl2.step_fn(p2, TA.adamw_init(wl2.opt_cfg, p2), batch)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-5)
    for x, y in zip(leaves(o2["m"]), leaves(o1["m"])):
        torch.testing.assert_close(x, y, rtol=1e-4,
                                   atol=1e-4 * float(y.abs().max()))


def test_build_workload_kinds_and_cuts():
    wl = TW.build_workload("llama3.2-3b", "train_4k", None,
                           shape_changes={"batch": 4})
    assert wl.meta["n_micro"] == 2 and wl.meta["batch"] == 4
    assert wl.meta["cuts"] == {"batch": [256, 4]}
    assert wl.meta["model_flops"] == 6 * wl.cfg.param_count() * 4 * 4096
    assert all(t.device.type == "meta" for t in leaves(wl.abstract_args))
    assert TW.n_micro_for(256, 4096) == 128
    for arch, shape in (("llama3.2-3b", "decode_32k"),
                        ("dlrm-rm2", "serve_p99")):
        with pytest.raises(NotImplementedError, match="12d"):
            TW.build_workload(arch, shape, None, smoke=True)
    with pytest.raises(NotImplementedError, match="12d"):
        TW.build_workload("gat-cora", "full_graph_sm", None, analysis=True)
    assert TW.all_cells() == RW.all_cells()
    ref = RW.build_workload("gat-cora", "full_graph_sm", _host_mesh(),
                            smoke=True)
    got = TW.build_workload("gat-cora", "full_graph_sm", None, smoke=True)
    assert got.meta == {**ref.meta, "cuts": {}}


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------

def _main(arch, shape, d, steps, resume=False):
    argv = ["--arch", arch, "--shape", shape, "--smoke", "--device", "cpu",
            "--steps", str(steps), "--ckpt-every", "1", "--ckpt-dir", d]
    assert TTr.main(argv + (["--resume"] if resume else [])) == 0


@pytest.mark.parametrize("arch", ["llama3.2-3b", "gat-cora", "dlrm-rm2"])
def test_train_main_resume_is_bitwise(arch, tmp_path, capsys):
    """Two steps, then ``--resume`` to three, against three uninterrupted
    steps: the final checkpoints (parameters, moments, step, data cursor)
    are byte-equal."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _main(arch, _SHAPE[arch], a, 2)
    _main(arch, _SHAPE[arch], a, 3, resume=True)
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert f"[train] arch={arch} shape={_SHAPE[arch]} steps=3" in out
    assert "retries=0" in out
    _main(arch, _SHAPE[arch], b, 3)
    da, db = (os.path.join(d, "step_0000000003") for d in (a, b))
    names = sorted(os.listdir(da))
    assert names == sorted(os.listdir(db))
    for name in names:
        assert filecmp.cmp(os.path.join(da, name), os.path.join(db, name),
                           shallow=False), name


def test_train_main_device_rule(monkeypatch):
    """No card and no ``--device``: the entry point refuses to run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        TTr.main(["--arch", "gat-cora", "--shape", "full_graph_sm",
                  "--smoke", "--steps", "1"])


def test_train_gnn_example_loss_falls(tmp_path, monkeypatch, capsys):
    """``examples/train_gnn_torch.py --device cpu``: the loss falls (its
    own assertion), checkpoints under the temporary directory."""
    import importlib.util
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "train_gnn_torch.py")
    spec = importlib.util.spec_from_file_location("train_gnn_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--device", "cpu", "--steps", "30"]) == 0
    assert "[train_gnn] steps=30" in capsys.readouterr().out
