"""The analytics dry-run of the port against the JAX package's.

``repro_torch.launch.analytics_dryrun`` builds the reference's sharded WSP
step over a ``ShardMesh`` and writes its record from shapes.  Held here:

- its record at ogb_products size on the 256- and 512-shard meshes against
  the reference's own ``python -m repro.launch.analytics_dryrun`` run (the
  keys the port must equal, the output bytes less XLA's tuple tables, the
  totals of ``analysis_cost``), and at small sizes where k does not divide
  e against the reference's ``build_step`` compiled on a (2, 2) mesh;
- its step run for real on ``ShardMesh.on("cpu", 4)`` against the
  reference's step run on a (2, 2) mesh of 4 forced host devices, on the
  same ``partition_edges`` blocks: bitwise states and equal iteration
  counts, on a graph that converges and on a line that stops at the
  64-iteration cap; and against the port's own ``pull`` and ``cuda``
  engines where it converges;
- its arguments on ``meta``, the configs, the mesh helpers, the
  ``Reckoner``'s counting rules, and ``analytics --dryrun``.

Each reference run happens once per module, in a subprocess.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import run_forced_devices
from repro.configs import grafs_analytics as JC
from repro.graph import partition as JP
from repro.graph import structure as JS
from repro_torch.configs import grafs_analytics as TC
from repro_torch.core import engine as TE
from repro_torch.core import fusion as TF
from repro_torch.core import usecases as TU
from repro_torch.graph import partition as TP
from repro_torch.graph import structure as TS
from repro_torch.launch import analytics as TA
from repro_torch.launch import analytics_dryrun as TAD
from repro_torch.launch import dryrun as TD
from repro_torch.launch import mesh as TM

ROOT = Path(__file__).resolve().parents[1]
# Keys of the record that equal the reference's.
SAME_KEYS = ("arch", "shape", "mesh", "status", "kind", "devices", "meta",
             "collectives")
TOP_OP_KEYS = ("bytes", "kind", "trips", "result_shape")
# XLA's tuple tables in the reference's output bytes: the port's output is
# the state plus the 4-byte counter alone.
XLA_TUPLE_BYTES = 24


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                JAX_PLATFORMS="cpu")


@pytest.fixture(autouse=True)
def _fresh_program_caches():
    """Overrides the suite's fixture of that name: both packages' caches."""
    yield
    from repro.core import engine as JE
    JE.clear_program_caches()
    TE.clear_program_caches()


@pytest.fixture(scope="module")
def ref_records(tmp_path_factory):
    """The reference's ogb_products records, {multi_pod: record}."""
    out = tmp_path_factory.mktemp("ref_dryrun")
    recs = {}
    for multi_pod in (False, True):
        cmd = [sys.executable, "-m", "repro.launch.analytics_dryrun",
               "--out", str(out)] + (["--multi-pod"] if multi_pod else [])
        run = subprocess.run(cmd, capture_output=True, text=True,
                             env=_env(), timeout=300, cwd=ROOT)
        assert run.returncode == 0, run.stderr[-3000:]
        path = out / TD._mesh_tag(multi_pod) / f"{TAD.RECORD_NAME}.json"
        recs[multi_pod] = json.loads(path.read_text())
    return recs


def _assert_record_matches(port, ref, keys=SAME_KEYS):
    for key in keys:
        assert port[key] == ref[key], key
    pm, rm = port["memory_analysis"], ref["memory_analysis"]
    assert pm["argument_size_in_bytes"] == rm["argument_size_in_bytes"]
    assert pm["output_size_in_bytes"] == \
        rm["output_size_in_bytes"] - XLA_TUPLE_BYTES
    assert [{k: op[k] for k in TOP_OP_KEYS}
            for op in port["collective_top_ops"]] == \
        [{k: op[k] for k in TOP_OP_KEYS} for op in ref["collective_top_ops"]]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_ogb_record_matches_reference(multi_pod, ref_records, tmp_path):
    """The port's record at ogb_products n and e against the reference's:
    the record keys the port must equal exactly, the output bytes less
    XLA's tuple tables, ``analysis_cost`` the per-device cost × devices."""
    argv = ["--out", str(tmp_path)] + (["--multi-pod"] if multi_pod else [])
    assert TAD.main(argv) == 0
    tag = TD._mesh_tag(multi_pod)
    port = json.loads((tmp_path / tag / f"{TAD.RECORD_NAME}.json")
                      .read_text())
    ref = ref_records[multi_pod]
    assert set(port) == set(ref)
    _assert_record_matches(port, ref)
    assert set(port["memory_analysis"]) == set(ref["memory_analysis"])
    k = 512 if multi_pod else 256
    assert port["devices"] == k
    assert port["memory_analysis"]["argument_size_in_bytes"] == \
        {256: 3_141_294, 512: 1_570_647}[k]
    assert port["collectives"]["all-reduce"] == \
        {"count": 2, "operand_bytes": 19_592_232}
    assert port["analysis_cost"] == {key: v * k for key, v in
                                     port["cost_analysis"].items()}
    assert port["cost_analysis"]["flops"] > 0
    assert port["memory_analysis"]["temp_size_in_bytes"] > 0


_REF_SMALL = """
    import json, jax
    from repro.launch.analytics_dryrun import build_step
    from repro.launch.dryrun import _mem_dict, collective_bytes
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    out = {}
    for n, e in SIZES:
        fn, args, shardings = build_step(mesh, n, e)
        with mesh:
            compiled = jax.jit(fn, in_shardings=shardings).lower(
                *args).compile()
        coll, top = collective_bytes(compiled.as_text())
        out[f"{n}/{e}"] = {"memory_analysis": _mem_dict(compiled),
                           "collectives": coll, "collective_top_ops": top}
    print(json.dumps(out))
"""
SMALL_SIZES = [(100, 1001), (37, 250), (5, 7)]


@pytest.fixture(scope="module")
def ref_small():
    code = textwrap.dedent(_REF_SMALL).replace("SIZES", repr(SMALL_SIZES))
    return json.loads(run_forced_devices(code, 4).strip().splitlines()[-1])


@pytest.mark.parametrize("n,e", SMALL_SIZES)
def test_small_record_matches_reference(n, e, ref_small):
    """At sizes where k = 4 does not divide e, the record's per-device
    bytes and collectives equal the reference's ``build_step`` compiled on
    a (2, 2) mesh of forced host devices."""
    assert e % 4
    port = TAD.build_record(TP.ShardMesh.on("meta", 4), n, e, "host2x2")
    ref = dict(ref_small[f"{n}/{e}"], arch="grafs-analytics")
    _assert_record_matches(port, ref, keys=("collectives",))
    assert port["memory_analysis"]["argument_size_in_bytes"] == \
        -(-e // 4) * 13
    assert port["devices"] == 4 and port["meta"]["e"] == e


_REF_RUN = """
    import json, numpy as np, jax
    from repro.launch.analytics_dryrun import build_step
    from repro.graph.partition import partition_edges
    from repro.graph.structure import line_graph, rmat_graph
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    out = {}
    for name, g in (("rmat", rmat_graph(256, 2048, seed=3)),
                    ("line", line_graph(80, weighted=True, seed=2))):
        part = partition_edges(g, 4)
        flat = [np.asarray(a).reshape(-1) for a in
                (part.src, part.dst, part.weight, part.capacity, part.mask)]
        fn, _, shardings = build_step(mesh, g.n, g.num_edges)
        with mesh:
            state, it = jax.jit(fn, in_shardings=shardings)(
                *flat, np.asarray(g.out_deg))
        out[name] = {"iterations": int(it), "state": [
            np.asarray(s).view(np.int32).tolist() for s in state]}
    print(json.dumps(out))
"""


def _ref_graph(name):
    if name == "rmat":
        return JS.rmat_graph(256, 2048, seed=3)
    return JS.line_graph(80, weighted=True, seed=2)


@pytest.fixture(scope="module")
def ref_runs():
    return json.loads(run_forced_devices(_REF_RUN, 4).strip()
                      .splitlines()[-1])


def _port_run(jg, mesh):
    """The port's step over ``mesh`` on the reference graph's
    ``partition_edges`` blocks (checked equal to the reference's):
    ``(state, iterations, shard_work, port graph, step)``."""
    tg = TS.from_arrays(jg.n, *jg.host_edges(), device="cpu")
    k = mesh.device_count
    jpart, tpart = JP.partition_edges(jg, k), TP.partition_edges(tg, k)
    flat = []
    for f in ("src", "dst", "weight", "capacity", "mask"):
        want = np.asarray(getattr(jpart, f))
        got = getattr(tpart, f).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f)
        flat.append(getattr(tpart, f).reshape(-1))
    fn, _ = TAD.build_step(mesh, tg.n, tg.num_edges)
    work = []
    dev = mesh.devices[0]
    state, it = fn(*(a.to(dev) for a in flat), tg.out_deg.to(dev),
                   shard_work=work)
    return state, it, work, tg, fn


def _bits(t):
    return t.cpu().view(torch.int32).numpy()


@pytest.mark.parametrize("name", ["rmat", "line"])
def test_step_runs_bitwise_with_reference(name, ref_runs):
    """The port's step on 4 CPU shards against the reference's on 4
    forced host devices: bitwise states, equal iterations; the line of 80
    vertices stops at the 64-iteration cap in both."""
    state, it, work, _, _ = _port_run(_ref_graph(name),
                                   TP.ShardMesh.on("cpu", 4))
    ref = ref_runs[name]
    assert it == ref["iterations"]
    assert len(state) == len(ref["state"]) == 2
    for got, want in zip(state, ref["state"]):
        np.testing.assert_array_equal(_bits(got), np.asarray(want, np.int32))
    assert len(work) == 4 and sum(work) > 0
    if name == "line":
        assert it == 64
    else:
        assert it < 64


@pytest.mark.parametrize("k", [1, 3, 4])
def test_step_matches_pull_and_cuda_engines(k):
    """Where the fixpoint converges under 64 iterations, the step over k
    CPU shards is bitwise the port's ``pull`` answer and the ``cuda``
    engine's whole state (plain versions on the CPU), with equal
    iterations; its shard work sums to the pull engine's edge work."""
    state, it, work, tg, fn = _port_run(_ref_graph("rmat"),
                                        TP.ShardMesh.on("cpu", k))
    (plan,) = fn.plans
    answer = [cr.idx for cr in fn.comps].index(TF.plan_output(plan))
    prog = TF.fuse(TU.wsp(0))
    pull = TE.run_program(tg, prog, engine="pull", device="cpu")
    cuda, cuda_state = TE.run_program(tg, prog, engine="cuda", device="cpu",
                                      return_state=True)
    assert it == pull.stats.iterations == cuda.stats.iterations
    np.testing.assert_array_equal(_bits(state[answer]), _bits(pull.value))
    for got, want in zip(state, cuda_state):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert sum(work) == pull.stats.edge_work


def test_step_arguments_live_on_meta():
    """``build_step`` makes its arguments on ``meta`` at the reference's
    shapes and dtypes, and allocates nothing; the production meshes are
    256 and 512 shards, on the card unless a device is named."""
    for multi_pod, k in ((False, 256), (True, 512)):
        mesh = TM.make_production_mesh(multi_pod=multi_pod, device="meta")
        assert TM.mesh_devices(mesh) == k
        assert TM.batch_axes(mesh) == ("data",)
        assert {d.type for d in mesh.devices} == {"meta"}
        fn, args = TAD.build_step(mesh, TAD.OGB_N, TAD.OGB_E)
        flat = k * -(-TAD.OGB_E // k)
        assert [(tuple(a.shape), a.dtype) for a in args] == [
            ((flat,), torch.int32), ((flat,), torch.int32),
            ((flat,), torch.float32), ((flat,), torch.float32),
            ((flat,), torch.bool), ((TAD.OGB_N,), torch.int32)]
        assert all(a.device.type == "meta" for a in args)
        assert fn.max_iter == 64 and fn.reads() == ("src", "dst", "c",
                                                    "mask")
        with pytest.raises(ValueError, match="k 256|k 512"):
            fn.shards(*(a[:-1] if a.shape[0] == flat else a for a in args))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TM.make_production_mesh()


def test_configs_match_reference():
    """``GrafsConfig``, ``full()`` and ``smoke()`` carry the reference's
    fields and defaults."""
    assert [f.name for f in dataclasses.fields(TC.GrafsConfig)] == \
        [f.name for f in dataclasses.fields(JC.GrafsConfig)]
    for make in ("full", "smoke"):
        assert dataclasses.asdict(getattr(TC, make)()) == \
            dataclasses.asdict(getattr(JC, make)())


def test_reckoner_counting_rules():
    """Operations per element of the widest tensor, none for moves and
    views, a scatter's per scattered element; bytes of operands and
    results; the peak of the bytes the mode made and still holds."""
    a = torch.empty(10, device="meta")
    idx = torch.empty(4, dtype=torch.int64, device="meta")
    with TD.Reckoner() as rk:
        b = a + 1.0
        v = b.view(2, 5)
        g = b[idx]
        del b, v
        s = torch.zeros(10, device="meta").scatter_reduce_(
            0, idx, g, "amax")
    assert rk.flops == 10 + 4
    assert rk.bytes == (40 + 40) + (40 + 32 + 16) + 40 + \
        (40 + 32 + 16 + 40)
    assert rk.peak_bytes == 40 + 16          # b and g, before b is freed
    assert rk.ops["view"] == 1 and rk.ops["scatter_reduce_"] == 1
    del s


def test_analytics_dryrun_writes_the_record(tmp_path):
    """``python -m repro_torch.launch.analytics --dryrun`` (and with
    ``--multi-pod``) exits 0 without a card and writes the record;
    ``analytics`` with nothing to do still refuses."""
    for extra, tag in (([], "pod16x16"), (["--multi-pod"], "pod2x16x16")):
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.analytics",
             "--dryrun", "--out", str(tmp_path)] + extra,
            capture_output=True, text=True, env=_env(), timeout=300,
            cwd=ROOT)
        assert run.returncode == 0, run.stderr[-3000:]
        assert f"[analytics:{tag}] ok" in run.stdout
        rec = json.loads((tmp_path / tag / f"{TAD.RECORD_NAME}.json")
                         .read_text())
        assert rec["mesh"] == tag and rec["status"] == "ok"
    with pytest.raises(SystemExit):
        TA.main([])                    # nothing to do
