"""The benchmark's own CPU tests (not collected by the repository's test
run): ``python -m pytest -q bench/tests`` from the root of a checkout."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT / "bench"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
