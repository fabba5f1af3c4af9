"""The model cells' dry-run of the port against the JAX package's.

``repro_torch.launch.dryrun`` builds every (architecture × shape) cell
with ``launch.workloads.build_workload``, runs its step on ``meta`` under
the ``Reckoner`` and writes the record.  Held here:

- ``build_workload``'s ``kind`` and ``meta`` equal the reference's key for
  key for all 36 runnable cells, in every variant the reference takes
  (``kvq`` for the LM serving cells, ``dist`` for MeshGraphNet and EGNN),
  on both production meshes (the reference's built in a subprocess on
  512 forced host devices) and on no mesh (against a 1 × 1 reference
  mesh; a vertex-cut cell over one ``meta`` shard);
- the ``Reckoner``'s product rule (2·M·N·K for ``mm``, ``bmm``,
  ``addmm``, ``baddbmm`` and a 3-D ``@``);
- the ``analysis=True`` flops against XLA's ``cost_analysis()`` of the
  reference's analysis lowering at smoke: within 10 % for llama3.2-3B
  ``prefill_32k`` and ``decode_32k`` and RM2 ``serve_p99`` and
  ``retrieval_cand``; the ratio recorded and within [0.5, 2] for llama
  ``train_4k`` and GAT ``full_graph_sm``;
- ``main --smoke --both-meshes`` writes 80 records (72 ``ok``, 8
  ``skipped``) with the reference's keys and the port's two more, each
  accepted by ``benchmarks/roofline.derive``; the even split of the
  memory keys; ``--list`` prints what the reference's prints; the module
  runs as a script where ``import jax`` fails.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
from conftest import run_forced_devices
from repro.launch import workloads as RW
from repro_torch.graph.partition import ShardMesh
from repro_torch.launch import dryrun as TD
from repro_torch.launch import mesh as TM
from repro_torch.launch import workloads as TW

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "benchmarks"))
import roofline  # noqa: E402

MESHES = ("none", "pod16x16", "pod2x16x16")
ARCHS = list(RC.ASSIGNED)
# The reference's record keys (repro/launch/dryrun.py run_cell), and the
# port's two more.
REF_OK_KEYS = {"arch", "shape", "mesh", "status", "kind", "meta", "lower_s",
               "compile_s", "devices", "memory_analysis", "cost_analysis",
               "collectives", "collective_top_ops", "hlo_bytes",
               "analysis_cost"}
PORT_KEYS = {"per_device", "collectives_reckoned"}
SKIP_KEYS = {"arch", "shape", "mesh", "status", "skip_reason"}


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                JAX_PLATFORMS="cpu")


def _variants(arch, shape):
    entry = RC.get(arch)
    out = ["baseline"]
    if entry.family == "lm" and entry.shapes[shape]["kind"] in ("prefill",
                                                                "decode"):
        out.append("kvq")
    if entry.kind in ("mgn", "egnn"):
        out.append("dist")
    return out


_REF_META = """
    import json
    import jax
    import numpy as np
    import repro.configs as RC
    from repro.launch.mesh import make_production_mesh
    from repro.launch.workloads import all_cells, build_workload

    def plain(v):
        return int(v) if isinstance(v, (int, np.integer)) else v

    meshes = {"none": jax.make_mesh(
                  (1, 1), ("data", "model"),
                  axis_types=(jax.sharding.AxisType.Auto,) * 2),
              "pod16x16": make_production_mesh(multi_pod=False),
              "pod2x16x16": make_production_mesh(multi_pod=True)}
    out = {}
    for tag, mesh in meshes.items():
        for arch, shape, skip in all_cells():
            if skip:
                continue
            entry = RC.get(arch)
            variants = ["baseline"]
            if entry.family == "lm" and \\
                    entry.shapes[shape]["kind"] in ("prefill", "decode"):
                variants.append("kvq")
            if entry.kind in ("mgn", "egnn"):
                variants.append("dist")
            for v in variants:
                wl = build_workload(arch, shape, mesh, variant=v)
                out["|".join((tag, arch, shape, v))] = {
                    "kind": wl.kind,
                    "meta": {k: plain(x) for k, x in wl.meta.items()}}
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_meta():
    """{mesh|arch|shape|variant: {kind, meta}} of the reference's
    ``build_workload`` at full size, on the 1 × 1 and both production
    meshes (512 forced host devices, one subprocess)."""
    return json.loads(run_forced_devices(_REF_META, 512).strip()
                      .splitlines()[-1])


def _port_mesh(tag, variant):
    if tag == "none":
        return ShardMesh.on("meta", 1) if variant == "dist" else None
    return TM.model_mesh(multi_pod=tag == "pod2x16x16")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tag", MESHES)
def test_meta_matches_reference(ref_meta, tag, arch):
    """``kind`` and ``meta`` (JSON round trip, the port's ``cuts`` aside)
    equal the reference's for every runnable cell of ``arch`` and every
    variant the reference takes; abstract arguments all on ``meta``."""
    n = 0
    for shape in RC.get(arch).shapes:
        if RC.skip_reason(arch, shape):
            continue
        for v in _variants(arch, shape):
            wl = TW.build_workload(arch, shape, _port_mesh(tag, v),
                                   variant=v)
            want = ref_meta["|".join((tag, arch, shape, v))]
            assert wl.kind == want["kind"], (shape, v)
            assert wl.meta.pop("cuts") == {}
            assert json.loads(json.dumps(wl.meta)) == want["meta"], (shape,
                                                                    v)
            leaves = [t for t in torch.utils._pytree.tree_leaves(
                wl.abstract_args) if isinstance(t, torch.Tensor)]
            assert leaves and all(t.is_meta for t in leaves)
            n += 1
    assert n == sum(1 for k in ref_meta
                    if k.startswith(f"{tag}|{arch}|"))
    if arch == "llama3.2-3b" and tag != "none":
        wl = TW.build_workload(arch, "train_4k", _port_mesh(tag, "baseline"))
        assert wl.meta["n_micro"] == (8 if tag == "pod16x16" else 4)
        assert wl.cfg.moe_groups == (16 if tag == "pod16x16" else 32)
        assert wl.cfg.hint_axes == TM.model_mesh(
            multi_pod=tag == "pod2x16x16").axis_names


def test_model_mesh_has_the_reference_axes():
    for multi_pod, names, sizes, k in (
            (False, ("data", "model"), (16, 16), 256),
            (True, ("pod", "data", "model"), (2, 16, 16), 512)):
        mesh = TM.model_mesh(multi_pod=multi_pod)
        assert mesh.axis_names == names
        assert tuple(mesh.shape.values()) == sizes
        assert TM.mesh_devices(mesh) == k
        assert TM.batch_axes(mesh) == names[:-1]
    # a vertex-cut cell over the shape gets k shards on meta
    wl = TW.build_workload("meshgraphnet", "ogb_products",
                           TM.model_mesh(multi_pod=True), variant="dist")
    assert len(wl.abstract_args[2]) == 512
    assert wl.abstract_args[2][0]["src"].is_meta
    with pytest.raises(ValueError, match="needs a mesh"):
        TW.build_workload("egnn", "molecule", None, variant="dist")


# ---------------------------------------------------------------------------
# The Reckoner's product rule
# ---------------------------------------------------------------------------

def _meta(*shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("op", ["mm", "bmm", "addmm", "baddbmm",
                                "matmul3d", "matmul_batched"])
def test_reckoner_counts_products_as_2mnk(op):
    b, m, k, n = 3, 5, 7, 11
    calls = {
        "mm": (lambda: torch.mm(_meta(m, k), _meta(k, n)), 2 * m * n * k),
        "bmm": (lambda: torch.bmm(_meta(b, m, k), _meta(b, k, n)),
                2 * b * m * n * k),
        "addmm": (lambda: torch.addmm(_meta(m, n), _meta(m, k),
                                      _meta(k, n)), 2 * m * n * k),
        "baddbmm": (lambda: torch.baddbmm(_meta(b, m, n), _meta(b, m, k),
                                          _meta(b, k, n)),
                    2 * b * m * n * k),
        # [b, m, k] @ [k, n] folds into one mm of [b·m, k]
        "matmul3d": (lambda: _meta(b, m, k) @ _meta(k, n),
                     2 * b * m * n * k),
        "matmul_batched": (lambda: _meta(b, m, k) @ _meta(b, k, n),
                           2 * b * m * n * k)}
    fn, want = calls[op]
    with TD.Reckoner() as rk:
        out = fn()
    assert out.shape[-2:] == (m, n)
    assert rk.flops == want
    # an elementwise op still counts one per element of its widest tensor
    with TD.Reckoner() as rk:
        _meta(b, m, n) + 1.0
    assert rk.flops == b * m * n


def test_reckoner_shape_cache_keeps_the_counts():
    """A repeated call is served from the shape cache: the same results'
    shapes and the same counts as running every meta kernel."""
    x, w = _meta(4, 8), _meta(8, 8)
    with TD.Reckoner() as once:
        y = torch.relu(x @ w)
    with TD.Reckoner() as rk:
        outs = [torch.relu(x @ w) for _ in range(3)]
    assert all(o.shape == y.shape and o.dtype == y.dtype for o in outs)
    assert (rk.flops, rk.bytes) == (3 * once.flops, 3 * once.bytes)
    assert len(rk._shapes) == len(once._shapes)


# ---------------------------------------------------------------------------
# analysis=True against XLA's cost analysis
# ---------------------------------------------------------------------------

def _xla_flops(arch, shape):
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    wl = RW.build_workload(arch, shape, mesh, smoke=True, analysis=True)
    ca = jax.jit(wl.step_fn).lower(*wl.abstract_args).cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    return float(ca["flops"])


@pytest.mark.parametrize("arch,shape,bound", [
    ("llama3.2-3b", "prefill_32k", 0.1), ("llama3.2-3b", "decode_32k", 0.1),
    ("dlrm-rm2", "serve_p99", 0.1), ("dlrm-rm2", "retrieval_cand", 0.1),
    ("llama3.2-3b", "train_4k", None), ("gat-cora", "full_graph_sm", None)])
def test_analysis_flops_match_xla(arch, shape, bound, record_property):
    wl = TW.build_workload(arch, shape, None, smoke=True, analysis=True)
    rk, _, _ = TD.reckon(wl)
    ratio = rk.flops / _xla_flops(arch, shape)
    record_property("port_over_xla_flops", ratio)
    print(f"{arch} {shape}: port / XLA flops = {ratio:.4f}")
    if bound is None:
        assert 0.5 <= ratio <= 2.0
    else:
        assert abs(ratio - 1) <= bound


def test_analysis_build_is_the_reference_one():
    """One KV tile, unrolled loops, no hint axes, n_micro 1; a vertex-cut
    cell falls back to the single device's step; DLRM unchanged."""
    mesh = TM.model_mesh()
    wl = TW.build_workload("llama3.2-3b", "train_4k", mesh, analysis=True)
    assert (wl.cfg.kv_chunk, wl.cfg.loop_impl, wl.cfg.hint_axes,
            wl.meta["n_micro"]) == (1 << 30, "unroll", (), 1)
    assert wl.cfg.moe_groups == 16
    dist = TW.build_workload("egnn", "ogb_products", mesh, analysis=True,
                             variant="dist")
    assert "variant" not in dist.meta
    assert isinstance(dist.abstract_args[2], dict)
    a, b = (TW.build_workload("dlrm-rm2", "serve_bulk", mesh, analysis=x)
            for x in (False, True))
    assert a.meta == b.meta and a.cfg == b.cfg


# ---------------------------------------------------------------------------
# run_cell / main
# ---------------------------------------------------------------------------

def test_main_smoke_both_meshes_writes_80_records(tmp_path, capsys):
    assert TD.main(["--smoke", "--both-meshes", "--out", str(tmp_path)]) \
        == 0
    recs = [json.loads(p.read_text())
            for p in sorted(tmp_path.glob("*/*.json"))]
    assert len(recs) == 80
    status = [r["status"] for r in recs]
    assert status.count("ok") == 72 and status.count("skipped") == 8
    for r in recs:
        path = tmp_path / r["mesh"] / f"{r['arch']}__{r['shape']}.json"
        assert path.is_file()
        if r["status"] == "skipped":
            assert set(r) == SKIP_KEYS
            assert r["skip_reason"] == RC.skip_reason(r["arch"], r["shape"])
            continue
        assert set(r) == REF_OK_KEYS | PORT_KEYS
        assert r["devices"] == (256 if r["mesh"] == "pod16x16" else 512)
        assert r["per_device"] == "even_split"
        assert r["collectives_reckoned"] is False
        assert all(v == {"count": 0, "operand_bytes": 0}
                   for v in r["collectives"].values())
        assert r["analysis_cost"]["flops"] > 0
        d = roofline.derive(r)
        assert d["status"] == "ok" and d["t_collective_s"] == 0
        assert d["dominant"] in ("compute", "memory")
        assert d["useful_flops_frac"] > 0
    out = capsys.readouterr().out
    assert out.count("-> ok") == 72 and out.count("-> skipped") == 8


def test_record_memory_is_the_even_split():
    """RM2 ``serve_p99`` at full size on 256 devices: the arguments (the
    26.6 GB of tables, the MLPs, the batch) and the scores split evenly;
    a decode cell's cache is written in place (aliased)."""
    rec = TD.run_cell("dlrm-rm2", "serve_p99", False)
    wl = TW.build_workload("dlrm-rm2", "serve_p99", TM.model_mesh())
    args = sum(t.numel() * t.element_size() for t in
               torch.utils._pytree.tree_leaves(wl.abstract_args))
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == -(-args // 256)
    assert mem["output_size_in_bytes"] == -(-512 * 4 // 256)
    assert mem["alias_size_in_bytes"] == 0
    assert rec["cost_analysis"]["flops"] * 256 == \
        rec["analysis_cost"]["flops"]
    dec = TD.run_cell("llama3.2-3b", "decode_32k", True, smoke=True)
    wl = TW.build_workload("llama3.2-3b", "decode_32k",
                           TM.model_mesh(multi_pod=True), smoke=True)
    cache = sum(t.numel() * t.element_size()
                for t in wl.abstract_args[3].values())
    assert dec["memory_analysis"]["alias_size_in_bytes"] == -(-cache // 512)
    assert dec["kind"] == "decode" and dec["devices"] == 512


def test_vertex_cut_cell_reckons_on_meta():
    """The ``dist`` step over 256 ``meta`` shards: the pads' branch of
    ``gnn._real_edges`` and the segment sums' sort run without a read."""
    rec = TD.run_cell("meshgraphnet", "ogb_products", False, smoke=True,
                      variant="dist")
    assert rec["status"] == "ok" and rec["meta"]["variant"] == "dist"
    assert rec["cost_analysis"]["flops"] > 0


def _run(args, code=None):
    cmd = [sys.executable] + (["-c", code] if code else []) + args
    run = subprocess.run(cmd, capture_output=True, text=True, env=_env(),
                         timeout=300, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-3000:]
    return run.stdout


def test_list_prints_what_the_reference_prints():
    ref = _run(["-m", "repro.launch.dryrun", "--list"])
    port = _run(["-m", "repro_torch.launch.dryrun", "--list"])
    assert port == ref
    assert len(port.splitlines()) == 40 and port.count("SKIP:") == 4


def test_dryrun_runs_as_a_script_without_jax(tmp_path):
    code = textwrap.dedent("""
        import runpy, sys
        sys.modules["jax"] = None
        sys.argv = ["dryrun"] + sys.argv[1:]
        try:
            runpy.run_module("repro_torch.launch.dryrun",
                             run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        assert "jax" not in [m for m in sys.modules
                             if sys.modules[m] is not None]
    """)
    out = _run(["--smoke", "--out", str(tmp_path)], code=code)
    recs = list((tmp_path / "pod16x16").glob("*.json"))
    assert len(recs) == 40 and out.count("-> ok") == 36
