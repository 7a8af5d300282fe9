"""Readings that the limits of a cell's check are set from, on the card:

    python3 perfbench/calibrate.py --workload <name> --seeds 1-12 \\
        [--control-seeds 1-3] [--fault-seeds 1-3] [--dump <dir>]

Every reading is a run of the cell through the harness's own path
(``harness.execute``), the check included, with a short window at the
cell's own load: on each seed the program; on the control seeds the
control (``faults.CONTROL``, the reference with float8 matrix products)
in the program's place; on the fault seeds each fault of
``faults.PREFILL`` and ``faults.LOCAL``.  One process runs them all and
prints one JSON line a run: every number the check compares, whether the
run came out correct against the committed limits, and its requests.  ``--dump`` writes each
run's compared rows (program and reference log-probabilities) to
``<dir>/<side>-<seed>.npz``.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import faults, harness  # noqa: E402


def seeds(text: str) -> list[int]:
    out = []
    for part in filter(None, text.split(",")):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def reading(workload: str, seed: int, side: str, fault, seconds: float,
            dump: Path | None) -> dict:
    t0 = time.perf_counter()
    run, line = harness.execute(workload, seed, seconds, False, t0,
                                fault=fault)
    if dump is not None:
        import numpy as np
        import torch

        dump.mkdir(parents=True, exist_ok=True)
        np.savez(dump / f"{side}-{seed}.npz",
                 got=torch.stack([g for g, _ in run.compared]).numpy(),
                 want=torch.stack([w for _, w in run.compared]).numpy())
    return {"workload": workload, "seed": seed, "side": side,
            "correct": line["correct"], "requests": run.requests,
            "compared": len(run.compared), **run.numbers,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control-seeds", default="1-3")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0,
                    help="window of a run of the program or a fault")
    ap.add_argument("--control-seconds", type=float, default=8.0,
                    help="window of a run of the control, long enough "
                    "for as many requests as a run compares")
    ap.add_argument("--dump", type=Path)
    args = ap.parse_args(argv)
    runs = [(s, "program", None, args.seconds) for s in seeds(args.seeds)]
    runs += [(s, "control", faults.CONTROL, args.control_seconds)
             for s in seeds(args.control_seeds)]
    runs += [(s, f"fault.{name}", fault, args.seconds)
             for s in seeds(args.fault_seeds)
             for name, fault in {**faults.PREFILL, **faults.LOCAL}.items()]
    for seed, side, fault, seconds in runs:
        print(json.dumps(reading(args.workload, seed, side, fault, seconds,
                                 args.dump)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
