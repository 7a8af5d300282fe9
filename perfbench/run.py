"""Run one cell of ``BENCHMARK.json`` on this machine's card and print one
JSON line:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

It imports the program from ``src/`` of the same checkout, builds its
kernels there on the first run (``build/repro_torch/``), and exits with a
code other than 0, printing no result, where there is no card.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
