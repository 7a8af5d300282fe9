"""pytest settings of the benchmark's own tests: the program's ``src/``
and the repository root on the path, and the ``chip`` marker."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (runs the benchmark itself); "
        "skips where there is none")
