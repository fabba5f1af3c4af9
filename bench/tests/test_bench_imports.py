"""Nothing of the benchmark loads JAX or the JAX package, and the
reference takes nothing of the program."""
import ast
import json
import subprocess
import sys

import harness

ROOT = harness.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _top_imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_bench_sources_import_no_jax_nor_the_jax_package():
    for path in (ROOT / "bench").rglob("*.py"):
        assert not _top_imports(path) & FORBIDDEN, path


def test_bench_reference_imports_nothing_of_the_program():
    for path in (ROOT / "bench" / "reference").rglob("*.py"):
        assert "repro_torch" not in _top_imports(path), path


CODE = """
import json, sys, time
sys.path[:0] = [sys.argv[1] + "/bench", sys.argv[1] + "/src"]
import harness
from run import forbidden_modules
cell = harness.load_cell(harness.load_benchmark(), sys.argv[2])
run = harness.setup(cell, 2 ** 31 + 5, "cpu", time.perf_counter(),
                    {"scale": 7})
harness.window(run, 0.3, trace=False)
harness.free_program(run)
harness.check(run)
print(json.dumps({"forbidden": forbidden_modules(),
                  "tops": sorted({m.split(".")[0] for m in sys.modules}),
                  "check": run.check}))
"""


def test_bench_cell_loads_no_jax_nor_the_jax_package():
    for workload in ("urand22-serve", "urand22-solo"):
        p = subprocess.run([sys.executable, "-c", CODE, str(ROOT),
                            workload], capture_output=True, text=True,
                           timeout=300)
        assert p.returncode == 0, p.stderr[-2000:]
        out = json.loads(p.stdout.strip().splitlines()[-1])
        assert out["forbidden"] == []
        assert "repro_torch" in out["tops"]
        assert not set(out["tops"]) & FORBIDDEN
        assert out["check"] == {"wrong_vertices": 0, "unanswered": 0}


def test_bench_forbidden_names_are_compared_whole(monkeypatch):
    from run import forbidden_modules
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro_torch", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert forbidden_modules() == ["jax", "repro"]
