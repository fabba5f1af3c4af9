"""Chunked, checkpointed and warm-started cuda fixpoints, and the
checkpoint store, against the JAX package's.

The counterparts of ``tests/test_checkpointed_fixpoint.py``'s chunk, kill,
resume and warm-start tests on the port's ``ops.iterate_cuda`` (the plain
versions of its kernels, on the CPU), at RM-XS: ``uniform_graph(16, 48,
seed=5, weighted=True)``, carried across with ``from_arrays``.  Inside the
port a chunked, a killed-and-resumed and a monolithic fixpoint run the one
loop body, so they agree bitwise with every counter equal, PageRank
included.  Against the reference's chunked ``iterate_pallas`` (Pallas in
interpret mode): bitwise for BFS and SSSP, allclose (rtol 1e-5, atol 1e-7)
with equal iterations for PageRank, whose float sums run in another
order, and equal edge, resolve and gather work and push iterations.  A
checkpoint directory written by either package restores in the other.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as JC
from repro.core import fusion as JF
from repro.core import iterate as JI
from repro.core import usecases as JU
from repro.graph import structure as JS
from repro.kernels import ops as JO
from repro_torch.checkpoint import ckpt as TC
from repro_torch.checkpoint.fixpoint import FixpointCheckpointer
from repro_torch.core import engine as TE
from repro_torch.core import fusion as TF
from repro_torch.core import guard
from repro_torch.core import iterate as TI
from repro_torch.core import usecases as TU
from repro_torch.graph import structure as TS
from repro_torch.kernels import ops as TO

pytestmark = pytest.mark.faults

KERNELS = ("bfs", "sssp", "pagerank")


def _sets(mod, n):
    return {"bfs": mod.handwritten_bfs_depth(0),
            "sssp": mod.handwritten_sssp(0),
            "pagerank": mod.pagerank_kernels(n, tol=1e-6, max_iter=60)}


def _jcomp(dk):
    return JI.CompRuntime(idx=0, op=dk.rop, dtype=JI.DTYPES[dk.dtype],
                          p_fn=dk.p_fn, init_fn=dk.init_fn, source=dk.source,
                          e_fn=dk.e_fn)


def _tcomp(dk):
    return TI.CompRuntime(idx=0, op=dk.rop, dtype=TI.DTYPES[dk.dtype],
                          p_fn=dk.p_fn, init_fn=dk.init_fn, source=dk.source,
                          e_fn=dk.e_fn, p_expr=dk.p_expr)


@pytest.fixture(scope="module")
def graphs():
    jg = JS.uniform_graph(16, 48, seed=5, weighted=True)
    return jg, TS.from_arrays(jg.n, *jg.host_edges(), device="cpu")


@pytest.fixture
def g(graphs):
    return graphs[1]


def _port(g, kernel, **kw):
    dk = _sets(TU, g.n)[kernel]
    return TO.iterate_cuda(g, [_tcomp(dk)], [TF.Prim(dk.rop, 0)],
                           max_iter=dk.max_iter, tol=dk.tol, **kw)


def _ref(jg, kernel, **kw):
    dk = _sets(JU, jg.n)[kernel]
    return JO.iterate_pallas(jg, [_jcomp(dk)], [JF.Prim(dk.rop, 0)],
                             max_iter=dk.max_iter, tol=dk.tol, **kw)


def _counters(r):
    return (r.iterations, r.push_iters, r.pull_iters, r.edge_work,
            r.resolve_work, r.gather_work)


def _same(a, b):
    """Bitwise states, every counter equal."""
    assert _counters(a) == _counters(b)
    assert (a.converged, a.diverged, a.active_count) == \
        (b.converged, b.diverged, b.active_count)
    for x, y in zip(a.state, b.state):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _matches_reference(port, ref, kernel):
    assert port.iterations == int(ref.iterations)
    assert (port.edge_work, port.push_iters, port.resolve_work,
            port.gather_work) == (int(ref.edge_work), int(ref.push_iters),
                                  int(ref.resolve_work),
                                  int(ref.gather_work))
    have, want = port.state[0].numpy(), np.asarray(ref.state[0])
    if kernel == "pagerank":
        np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_array_equal(have, want)


class _Kill(Exception):
    pass


def _killer(k):
    if k >= 2:
        raise _Kill()


# ---------------------------------------------------------------------------
# Chunked ≡ monolithic; against the reference's chunked fixpoint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("direction", ["pull", "push", "auto"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_chunked_bitwise_equals_monolithic(graphs, kernel, direction,
                                           tmp_path):
    jg, g = graphs
    mono = _port(g, kernel, direction=direction)
    chunked = _port(g, kernel, direction=direction, checkpoint_every=2,
                    ckpt_dir=str(tmp_path / "port"))
    _same(mono, chunked)
    ref = _ref(jg, kernel, direction=direction, checkpoint_every=2,
               ckpt_dir=str(tmp_path / "ref"))
    _matches_reference(chunked, ref, kernel)


def test_single_chunk_mode_bitwise(g):
    """fault_hook alone selects chunked execution with one max_iter-sized
    chunk."""
    mono = _port(g, "sssp")
    seen = []
    chunked = _port(g, "sssp", fault_hook=seen.append)
    _same(mono, chunked)
    assert seen == [mono.iterations]


# ---------------------------------------------------------------------------
# Kill mid-fixpoint → resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["bfs", "pagerank"])
def test_kill_and_resume_bitwise(graphs, kernel, tmp_path):
    jg, g = graphs
    mono = _port(g, kernel)
    assert mono.iterations > 2, "need a multi-chunk fixpoint to kill"
    d = str(tmp_path / kernel)
    with pytest.raises(_Kill):            # the hook's own exception
        _port(g, kernel, checkpoint_every=1, ckpt_dir=d, fault_hook=_killer)
    assert TC.latest_step(d) == 2
    resumed = _port(g, kernel, checkpoint_every=1, ckpt_dir=d, resume=True)
    _same(mono, resumed)
    ref = _ref(jg, kernel, checkpoint_every=1,
               ckpt_dir=str(tmp_path / "ref"))
    _matches_reference(resumed, ref, kernel)


def test_resume_on_empty_dir_is_fresh_start(g, tmp_path):
    _same(_port(g, "bfs"), _port(g, "bfs", checkpoint_every=2,
                                 ckpt_dir=str(tmp_path / "fresh"),
                                 resume=True))


def test_resume_rejects_fingerprint_mismatch(g, tmp_path):
    d = str(tmp_path / "fp")
    _port(g, "bfs", checkpoint_every=1, ckpt_dir=d)
    with pytest.raises(guard.CheckpointMismatchError):
        _port(g, "bfs", sources={0: 3}, checkpoint_every=1, ckpt_dir=d,
              resume=True)


def test_checkpoint_knob_validation(g):
    with pytest.raises(ValueError, match="ckpt_dir"):
        _port(g, "bfs", checkpoint_every=2)
    with pytest.raises(ValueError, match="ckpt_dir"):
        _port(g, "bfs", resume=True)
    with pytest.raises(ValueError, match="checkpoint_every"):
        _port(g, "bfs", checkpoint_every=0, ckpt_dir="unused")


def test_fingerprint_fields(g):
    """The reference's fields: the layout's tiling and the effective
    source per component, −1 where the component has none."""
    bfs, cc = _tcomp(TU.handwritten_bfs_depth(0)), _tcomp(TU.handwritten_cc())
    cc = dataclasses.replace(cc, idx=1)
    assert TO._srcs_vector([bfs, cc], {0: 5}) == [5, -1]
    assert TO._srcs_vector([bfs, cc]) == [0, -1]
    fp = TO._fixpoint_fingerprint(g, [bfs], [TF.Prim("min", 0)], ("pull",),
                                  36, 0.0, 8, 128, "sorted", 20.0, [0])
    assert (fp["n"], fp["num_edges"], fp["block_v"], fp["block_e"],
            fp["srcs"], fp["comps"]) == (16, g.num_edges, 8, 128, [0],
                                         "((0, 'min', 'int32', False),)")
    json.dumps(fp)


# ---------------------------------------------------------------------------
# Warm start
# ---------------------------------------------------------------------------

def test_warm_start_from_converged_state(graphs):
    jg, g = graphs
    cold = _port(g, "sssp")
    warm = _port(g, "sssp", init_state=cold.state)
    assert warm.iterations <= 1 < cold.iterations
    assert torch.equal(cold.state[0], warm.state[0])
    # from the reference's converged state (numpy), as the reference does
    ref_cold = _ref(jg, "sssp")
    state = [np.asarray(s) for s in ref_cold.state]
    ref_warm = _ref(jg, "sssp", init_state=state)
    port_warm = _port(g, "sssp", init_state=state)
    _matches_reference(port_warm, ref_warm, "sssp")


def test_warm_start_shape_validation(g):
    with pytest.raises(ValueError, match="init_state"):
        _port(g, "bfs", init_state=[np.zeros(g.n - 1, np.int32)])
    with pytest.raises(ValueError, match="components"):
        _port(g, "bfs", init_state=[np.zeros(g.n, np.int32)] * 2)


# ---------------------------------------------------------------------------
# Engine threading (run_direct / run_program)
# ---------------------------------------------------------------------------

def test_run_direct_checkpointed_matches_plain(g, tmp_path):
    dk = TU.pagerank_kernels(g.n, tol=1e-6, max_iter=60)
    plain = TE.run_direct(g, dk, engine="cuda", device="cpu")
    ck = TE.run_direct(g, dk, engine="cuda", device="cpu",
                       checkpoint_every=3, ckpt_dir=str(tmp_path / "pr"))
    assert torch.equal(plain.value, ck.value)
    assert ck.stats.iterations == plain.stats.iterations
    assert ck.stats.edge_work == plain.stats.edge_work


def test_checkpoint_knobs_rejected_off_cuda(g, tmp_path):
    dk = TU.handwritten_bfs_depth(0)
    with pytest.raises(ValueError, match="cuda"):
        TE.run_direct(g, dk, engine="pull", device="cpu", checkpoint_every=2,
                      ckpt_dir=str(tmp_path))
    with pytest.raises(ValueError, match="cuda"):
        TE.run_direct(g, dk, engine="adaptive", device="cpu",
                      init_state=[np.zeros(g.n, np.int32)])
    prog = TF.fuse(TU.ALL_SPECS["BFS"]())
    with pytest.raises(ValueError, match="cuda"):
        TE.run_program(g, prog, engine="pull", device="cpu", resume=True,
                       ckpt_dir=str(tmp_path))
    with pytest.raises(ValueError, match="cuda"):
        TE.run_program(g, prog, engine="dense", device="cpu",
                       return_state=True)
    with pytest.raises(ValueError, match="cuda"):
        TE.run_direct(g, dk, engine="pull", device="cpu",
                      init_state=[np.zeros(g.n, np.int32)], delta=[0])


def test_return_state_warm_starts_the_same_query(g):
    """``return_state=True`` gives the round's [n] state, on the graph's
    device; fed back as ``init_state`` (the default engine is then cuda)
    it converges in one iteration to the same bits."""
    prog = TF.fuse(TU.ALL_SPECS["SSSP"]())
    cold, state = TE.run_program(g, prog, device="cpu", return_state=True)
    assert cold.stats.engine_used == "cuda" and cold.stats.iterations > 1
    assert len(state) == 1 and state[0].shape == (g.n,)
    assert state[0].device == g.device
    warm = TE.run_program(g, prog, device="cpu", init_state=state)
    assert warm.stats.engine_used == "cuda" and warm.stats.iterations == 1
    assert torch.equal(cold.value, warm.value)
    direct = TE.run_direct(g, TU.handwritten_sssp(0), device="cpu",
                           init_state=[s.numpy() for s in state])
    assert direct.stats.engine_used == "cuda"
    assert direct.stats.iterations == 1


def test_warm_hooks_need_a_single_round(g):
    prog = TF.fuse(TU.ALL_SPECS["RDS"]())
    assert len(prog.rounds) == 2
    with pytest.raises(ValueError, match="single-round"):
        TE.run_program(g, prog, engine="cuda", device="cpu",
                       return_state=True)


# ---------------------------------------------------------------------------
# The KernelLaunchError wrapper and the fallback chain
# ---------------------------------------------------------------------------

def test_checkpoint_write_fault_propagates_as_itself(g, tmp_path):
    """An OSError of the checkpoint writer (here: ``ckpt_dir`` is a file)
    is an infrastructure failure, never a kernel fault: it propagates as
    itself, and under ``fallback=True`` the query ends on adaptive, cold,
    with one event."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    dk = TU.handwritten_bfs_depth(0)
    with pytest.raises(FileExistsError):
        _port(g, "bfs", checkpoint_every=2, ckpt_dir=str(blocker))
    with pytest.raises(FileExistsError):
        TE.run_direct(g, dk, engine="cuda", device="cpu", checkpoint_every=2,
                      ckpt_dir=str(blocker))
    ref = TE.run_direct(g, dk, engine="adaptive", device="cpu")
    r = TE.run_direct(g, dk, engine="cuda", device="cpu", fallback=True,
                      checkpoint_every=2, ckpt_dir=str(blocker))
    assert r.stats.engine_used == "adaptive"
    assert [(f, t) for f, t, _ in r.stats.fallbacks] == [("cuda", "adaptive")]
    assert r.stats.fallbacks[0][2].startswith("FileExistsError")
    assert torch.equal(ref.value, r.value)


def test_save_fault_propagates_as_itself(g, tmp_path, monkeypatch):
    def boom(self, carry, step):
        raise OSError("disk full")

    monkeypatch.setattr(FixpointCheckpointer, "save", boom)
    prog = TF.fuse(TU.ALL_SPECS["BFS"]())
    with pytest.raises(OSError, match="disk full") as info:
        TE.run_program(g, prog, engine="cuda", device="cpu",
                       checkpoint_every=2, ckpt_dir=str(tmp_path))
    assert type(info.value) is OSError
    r = TE.run_program(g, prog, engine="cuda", device="cpu", fallback=True,
                       checkpoint_every=2, ckpt_dir=str(tmp_path))
    assert r.stats.engine_used == "adaptive"
    assert r.stats.fallbacks == (("cuda", "adaptive", "OSError: disk full"),)


def test_fault_in_the_loop_is_a_kernel_fault(g, monkeypatch):
    """A recoverable failure inside the loop body stays a kernel fault in
    chunk mode, as in the monolithic one."""
    def boom(*a, **k):
        raise RuntimeError("torch glue")

    monkeypatch.setattr(TO._er, "fused_ell_sweep_frontier", boom)
    for kw in ({}, {"fault_hook": lambda k: None}):
        with pytest.raises(guard.KernelLaunchError, match="torch glue"):
            _port(g, "bfs", direction="pull", **kw)


def test_mismatch_is_never_taken_by_the_chain(g, tmp_path):
    d = str(tmp_path / "fp")
    dk = TU.handwritten_bfs_depth(0)
    TE.run_direct(g, dk, engine="cuda", device="cpu", checkpoint_every=1,
                  ckpt_dir=d)
    with pytest.raises(guard.CheckpointMismatchError):
        TE.run_direct(g, dk, engine="cuda", device="cpu", source=3,
                      checkpoint_every=1, ckpt_dir=d, resume=True,
                      fallback=True)


# ---------------------------------------------------------------------------
# The checkpoint store
# ---------------------------------------------------------------------------

def _tree():
    rng = np.random.default_rng(21)
    return (torch.from_numpy(rng.integers(-9, 9, 7, dtype=np.int32)),
            (torch.from_numpy(rng.integers(0, 2 ** 40, (3, 2))),
             torch.from_numpy(rng.random(5) < 0.5)),
            torch.from_numpy(rng.standard_normal(6).astype(np.float32)),
            torch.tensor(5, dtype=torch.int64),
            torch.tensor(0.25, dtype=torch.float32))


def test_round_trip_nested_tensors(tmp_path):
    tree = _tree()
    d = str(tmp_path)
    TC.save_checkpoint(d, 3, tree, extra={"cursor": 7})
    like = (torch.zeros(7, dtype=torch.int32),
            (torch.zeros(3, 2, dtype=torch.int64),
             torch.zeros(5, dtype=torch.bool)),
            torch.zeros(6), torch.zeros((), dtype=torch.int64),
            torch.zeros(()))
    back, step, extra = TC.restore_checkpoint(d, like)
    assert (step, extra) == (3, {"cursor": 7})
    flat = [leaf for _, leaf in TC._flatten_with_paths(back)]
    want = [leaf for _, leaf in TC._flatten_with_paths(tree)]
    assert [k for k, _ in TC._flatten_with_paths(back)] == \
        ["0", "1/0", "1/1", "2", "3", "4"]
    for a, b in zip(flat, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    assert isinstance(back[1], tuple)


def test_latest_step_ignores_tmp_and_keep_retains(tmp_path):
    d = str(tmp_path)
    assert TC.latest_step(d) is None
    TC.save_checkpoint(d, 1, (torch.ones(2),))
    os.makedirs(os.path.join(d, "step_0000000009.tmp"))
    assert TC.latest_step(d) == 1
    mgr = TC.CheckpointManager(d, keep=2)
    for s in (2, 3, 4):
        mgr.save_async(s, (torch.full((2,), float(s)),))
    mgr.wait()
    assert mgr.last_saved == 4
    steps = sorted(x for x in os.listdir(d) if not x.endswith(".tmp"))
    assert steps == ["step_0000000003", "step_0000000004"]
    back, step, _ = mgr.restore_latest((torch.zeros(2),))
    assert step == 4 and torch.equal(back[0], torch.full((2,), 4.0))


def test_writer_fault_is_raised_by_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    mgr = TC.CheckpointManager(str(blocker))
    mgr.save_async(1, (torch.ones(1),))
    with pytest.raises(FileExistsError):
        mgr.wait()
    mgr.wait()                                 # raised once


def _np_tree():
    """32-bit and bool leaves: the reference restores through
    ``jax.device_put``, which narrows 64-bit arrays without x64 mode."""
    rng = np.random.default_rng(7)
    return (rng.integers(-5, 5, 9).astype(np.int32),
            (rng.integers(-2 ** 31, 2 ** 31, (4, 3)).astype(np.int32),
             rng.random(6) < 0.5),
            rng.standard_normal(5).astype(np.float32),
            np.asarray(3, dtype=np.int32))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_restores_across_packages(tmp_path, writer):
    """The on-disk format is the reference's: a tree of numpy arrays saved
    by one package restores bitwise in the other, with the same
    manifest."""
    tree = _np_tree()
    dp, dr = str(tmp_path / "port"), str(tmp_path / "ref")
    TC.save_checkpoint(dp, 5, tree, extra={"k": 1})
    JC.save_checkpoint(dr, 5, tree, extra={"k": 1})
    with open(os.path.join(dp, "step_0000000005", "manifest.json")) as f:
        mp = json.load(f)
    with open(os.path.join(dr, "step_0000000005", "manifest.json")) as f:
        mr = json.load(f)
    assert mp == mr
    src = dp if writer == "port" else dr
    if writer == "port":
        back, step, extra = JC.restore_checkpoint(src, tree)
    else:
        back, step, extra = TC.restore_checkpoint(src, tree)
    assert (step, extra) == (5, {"k": 1})
    flat = [np.asarray(x) for _, x in TC._flatten_with_paths(back)]
    for a, b in zip(flat, [x for _, x in TC._flatten_with_paths(tree)]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # and into tensors, on the CPU, with the dtypes of the tensors given
    like = tuple(torch.from_numpy(np.zeros_like(x)) for x in
                 (tree[0], tree[2]))
    back_t, _, _ = TC.restore_checkpoint(
        src, (like[0], (torch.zeros(4, 3, dtype=torch.int32),
                        torch.zeros(6, dtype=torch.bool)), like[1],
              torch.zeros((), dtype=torch.int32)))
    assert torch.equal(back_t[0], torch.from_numpy(tree[0]))
    assert torch.equal(back_t[1][0], torch.from_numpy(tree[1][0]))
    assert back_t[3].dtype == torch.int32 and int(back_t[3]) == 3
