"""The port's AdamW and gradient compression against the JAX package's, on
the CPU.

``repro_torch.optim`` held against ``repro.optim``: ``cosine_lr`` at the
schedule's corners, ``global_norm`` (finite past float32's squares,
where the reference's overflows), three ``adamw_update`` steps on a
tree of float32 and bfloat16 parameters with float32 and bfloat16 state,
clip on and off (float32 leaves within rtol 1e-6, bfloat16 leaves within
one bfloat16 step, ``step`` equal), the update written in place and in
row chunks bitwise the whole-leaf one, ``compress_grads`` / ``decompress_grads`` bitwise, and
``error_feedback_update`` over k = 2 and 4 shards within scale/2 of the
mean, the bound of the reference's ``test_compressed_allreduce_matches_
mean``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as RA
from repro.optim import compress as RCo
from repro_torch.graph.partition import ShardMesh
from repro_torch.optim import adamw as TA
from repro_torch.optim import compress as TCo
from repro_torch.tree import leaves, tree_map

BF16_STEP = 2.0 ** -7          # one bfloat16 step of the element


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dtype))


def _j(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32), jnp.dtype(dtype))


@pytest.mark.parametrize("step", [0, 1, 100, 5050, 10_000, 12_000])
def test_cosine_lr_matches_reference(step):
    cfg = TA.AdamWConfig()
    ref = RA.cosine_lr(RA.AdamWConfig(), jnp.int32(step))
    got = TA.cosine_lr(cfg, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    assert float(TA.cosine_lr(cfg, step)) == float(got)


def test_config_equals_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(TA.AdamWConfig)] \
        == [(f.name, f.default) for f in dataclasses.fields(RA.AdamWConfig)]


def _tree(seed, dtypes=("float32", "bfloat16"), scale=1.0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "b": (5,), "layers": [(3, 4), (4,)]}
    raw = {"w": rng.normal(size=shapes["w"]) * scale,
           "b": rng.normal(size=shapes["b"]) * scale,
           "layers": [rng.normal(size=s) * scale for s in shapes["layers"]]}
    dt = {"w": dtypes[0], "b": dtypes[1], "layers": [dtypes[1], dtypes[0]]}
    port = {"w": _t(raw["w"], dt["w"]), "b": _t(raw["b"], dt["b"]),
            "layers": [_t(a, d) for a, d in zip(raw["layers"],
                                                dt["layers"])]}
    ref = {"w": _j(raw["w"], dt["w"]), "b": _j(raw["b"], dt["b"]),
           "layers": [_j(a, d) for a, d in zip(raw["layers"],
                                               dt["layers"])]}
    return port, ref


def test_global_norm_matches_reference():
    port, ref = _tree(0)
    got = TA.global_norm(port)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(RA.global_norm(ref)),
                               rtol=1e-6)


def test_global_norm_past_float32_squares_is_finite():
    """Gradients of 1e20 (a random 28-layer LM's): the reference's float32
    Σ x² overflows to inf, the port's float64 sum gives the norm."""
    big = np.full((4, 3), 1e20, np.float32)
    assert not np.isfinite(float(RA.global_norm({"w": _j(big, "float32")})))
    got = float(TA.global_norm({"w": _t(big, "float32")}))
    np.testing.assert_allclose(got, 1e20 * np.sqrt(12), rtol=1e-6)


def _close_leaf(got, want):
    got_np, want_np = _np(got).astype(np.float64), _np(want).astype(
        np.float64)
    if got.dtype == torch.bfloat16:
        assert np.all(np.abs(got_np - want_np)
                      <= BF16_STEP * np.abs(want_np) + 1e-30)
    else:
        np.testing.assert_allclose(got_np, want_np, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_three_steps_match_reference(state_dtype, clip):
    """Three updates with fresh gradients each (large enough that the clip
    acts when on), parameters float32 and bfloat16 side by side."""
    kw = dict(state_dtype=state_dtype, clip_norm=clip, warmup_steps=2,
              total_steps=10, lr=1e-2)
    tcfg, rcfg = TA.AdamWConfig(**kw), RA.AdamWConfig(**kw)
    p, rp = _tree(1)
    st, rst = TA.adamw_init(tcfg, p), RA.adamw_init(rcfg, rp)
    rupd = jax.jit(lambda a, g, s: RA.adamw_update(rcfg, a, g, s))
    for i in range(3):
        g, rg = _tree(10 + i, scale=3.0)
        p, st, m = TA.adamw_update(tcfg, p, g, st)
        rp, rst, rm = rupd(rp, rg, rst)
        assert int(st["step"]) == int(rst["step"]) == i + 1
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]),
                                   rtol=1e-6)
        for tree, rtree in ((p, rp), (st["m"], rst["m"]),
                            (st["v"], rst["v"])):
            for a, b in zip(leaves(tree), jax.tree.leaves(rtree)):
                assert a.dtype == getattr(torch, str(b.dtype))
                _close_leaf(a, b)


def test_adamw_inplace_and_chunked_are_bitwise(monkeypatch):
    """The update writes into the given tensors, and in row chunks (a small
    chunk forces several per leaf) gives the bits of the whole-leaf
    update."""
    cfg = TA.AdamWConfig(state_dtype="bfloat16")
    p, _ = _tree(3)
    g, _ = _tree(4)
    st = TA.adamw_init(cfg, p)
    p1, st1, _ = TA.adamw_update(cfg, tree_map(torch.clone, p), g,
                                 tree_map(torch.clone, st))
    monkeypatch.setattr(TA, "_CHUNK", 8)
    p2, st2, _ = TA.adamw_update(cfg, p, g, st)
    assert all(a is b for a, b in zip(leaves((p2, st2["m"], st2["v"])),
                                      leaves((p, st["m"], st["v"]))))
    for x, y in zip(leaves((p1, st1)), leaves((p2, st2))):
        assert torch.equal(x, y)


def test_compress_roundtrip_bitwise():
    rng = np.random.default_rng(0)
    raw = {"w": rng.normal(size=(64, 64)), "b": rng.normal(size=(7,))}
    g = {k: _t(v, "float32") for k, v in raw.items()}
    rg = {k: _j(v, "float32") for k, v in raw.items()}
    st, rst = TCo.init_compress_state(g), RCo.init_compress_state(rg)
    for _ in range(3):
        q, s, st = TCo.compress_grads(g, st)
        rq, rs, rst = RCo.compress_grads(rg, rst)
        for k in raw:
            assert np.array_equal(_np(q[k]), np.asarray(rq[k]))
            assert q[k].dtype == torch.int8
            assert np.array_equal(_np(s[k]), np.asarray(rs[k]))
            assert np.array_equal(_np(st.error[k]), np.asarray(rst.error[k]))
        deq, rdeq = TCo.decompress_grads(q, s), RCo.decompress_grads(rq, rs)
        for k in raw:
            assert np.array_equal(_np(deq[k]), np.asarray(rdeq[k]))


@pytest.mark.parametrize("k", [2, 4])
def test_error_feedback_update_matches_mean(k):
    """int8 sum over k shards with the shared scale ≈ the cross-shard mean,
    within scale/2 (the reference's bound), each shard's result the
    same."""
    rng = np.random.default_rng(k)
    grads = [{"w": _t(rng.normal(size=(16, 8)), "float32"),
              "b": _t(rng.normal(size=(8,)) * 0.01, "float32")}
             for _ in range(k)]
    states = [TCo.init_compress_state(g) for g in grads]
    red, new = TCo.error_feedback_update(grads, states,
                                         ShardMesh.on("cpu", k))
    for key in ("w", "b"):
        mean = sum(g[key] for g in grads) / k
        amax = max(float(g[key].abs().max()) for g in grads)
        scale = max(amax, 1e-12) / 127.0
        for r in red:
            assert torch.equal(r[key], red[0][key])
            assert float((r[key] - mean).abs().max()) <= scale / 2 + 1e-7
        for g, s in zip(grads, new):
            assert float(s.error[key].abs().max()) <= scale / 2 + 1e-7
    with pytest.raises(ValueError):
        TCo.error_feedback_update(grads[:1], states,
                                  ShardMesh.on("cpu", k))
