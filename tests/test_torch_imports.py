"""Import hygiene of the port: it imports without JAX, and no file of the
package (nor chip_smoke.py) imports ``jax`` or the JAX package ``repro``."""
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


def test_no_jax_or_reference_imports_in_sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = []
    for f in files:
        for m in _BAD.finditer(f.read_text()):
            bad.append(f"{f.relative_to(ROOT)}: {m.group(0).strip()}")
    assert not bad, bad
    assert (ROOT / "chip_smoke.py").is_file()
