"""Import hygiene of the port: it imports without JAX, and no file of the
package (nor chip_smoke.py, nor the port's quickstart) imports ``jax`` or
the JAX package ``repro``.  Both tests walk every file under
``src/repro_torch/``, ``launch/``, ``models/``, ``configs/`` and ``data/``
included (the LM serving path's, the GNNs', DLRM's and the training
path's files are checked to be among them, and the training example with
chip_smoke.py).
``launch.analytics`` needs no guard at import time, since its
``--dryrun`` runs the port's own ``repro_torch.launch.analytics_dryrun``,
never the reference's."""
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(PKG.parent).with_suffix("")
        yield ".".join(rel.parts).removesuffix(".__init__")


def test_port_imports_without_jax():
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        for name in {list(_modules())!r}:
            importlib.import_module(name)
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok"


_BAD = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)|"
                  r"from\s+repro\b(?!_))", re.M)


# The LM serving path's files, which the walk below must reach.
LM_FILES = ["models/__init__.py", "models/layers.py", "models/transformer.py",
            "launch/serve.py", "configs/__init__.py", "configs/llama3_2_3b.py",
            "configs/qwen2_72b.py", "configs/yi_9b.py",
            "configs/deepseek_v3_671b.py",
            "configs/llama4_maverick_400b_a17b.py"]
# The GNNs' files and their data path.
GNN_FILES = ["models/gnn.py", "data/__init__.py", "data/graphs.py",
             "graph/sampler.py", "configs/gat_cora.py", "configs/egnn.py",
             "configs/meshgraphnet.py", "configs/dimenet.py"]
# DLRM's files.
DLRM_FILES = ["models/dlrm.py", "configs/dlrm_rm2.py"]
# The training path's files.
TRAIN_FILES = ["optim/__init__.py", "optim/adamw.py", "optim/compress.py",
               "tree.py", "data/tokens.py", "runtime/ft.py",
               "launch/workloads.py", "launch/train.py",
               "checkpoint/ckpt.py"]


def test_no_jax_or_reference_imports_in_sources():
    files = sorted(PKG.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py",
        ROOT / "examples" / "train_gnn_torch.py"]
    assert {PKG / f for f in LM_FILES + GNN_FILES + DLRM_FILES
            + TRAIN_FILES} <= set(files)
    bad = []
    for f in files:
        for m in _BAD.finditer(f.read_text()):
            bad.append(f"{f.relative_to(ROOT)}: {m.group(0).strip()}")
    assert not bad, bad
    assert (ROOT / "chip_smoke.py").is_file()


def test_graph_package_imports_without_mutate():
    """``repro_torch.graph`` does not pull in ``graph.mutate``, and
    ``graph.mutate`` imports first, on its own, with no cycle through
    ``core.guard``."""
    code = textwrap.dedent("""
        import sys
        import repro_torch.graph
        assert "repro_torch.graph.mutate" not in sys.modules
        print("ok")
    """)
    first = textwrap.dedent("""
        from repro_torch.graph import mutate
        from repro_torch.core import guard
        assert mutate.GraphValidationError is guard.GraphValidationError
        print("ok")
    """)
    _run_each(code, first)


def test_partition_imports_first_without_cycle():
    """``graph.partition`` imports first, on its own, with no cycle through
    ``graph.structure`` or ``core.plan``, and ``repro_torch.graph``
    exports its mesh and partition."""
    first = textwrap.dedent("""
        from repro_torch.graph import partition
        from repro_torch.core import plan
        import repro_torch.graph as G
        assert G.ShardMesh is partition.ShardMesh
        assert G.partition_edges is partition.partition_edges
        assert plan.check_mesh is partition.check_mesh
        print("ok")
    """)
    _run_each(first)


def _run_each(*codes):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for c in codes:
        out = subprocess.run([sys.executable, "-c", c], capture_output=True,
                             text=True, env=env, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        assert out.stdout.strip() == "ok"
