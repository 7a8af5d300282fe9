"""One run of one cell: find the cell's files by the names in
``BENCHMARK.json``, hand the run to the runner of its traffic's kind,
read the metrics, check the outputs, print the result line.

Files of a cell, all found by name:

* ``configs/<config>.json``: the model as it is run (``family`` names the
  plain reference, ``reference/<family>.py``);
* ``traffic/<traffic>.json``: the mix's parameters (``kind`` names the
  runner, ``kinds/<kind>.py``);
* ``metrics/<metric>.py``: one reader a metric, ``read(run) -> float |
  None`` (None: nothing to read in this run, and the metric is left out);
* ``limits/<workload>.json``: the limit of each number the check compares.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Run:
    """What a runner measured, for the metric readers."""
    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    setup_s: float = 0.0
    marks: dict = field(default_factory=dict)   # set-up part -> its end
    setup_parts: dict = field(default_factory=dict)   # part -> seconds
    window_s: float = 0.0
    requests: int = 0              # finished in the window
    tokens: int = 0                # scored in the window
    latencies_s: list = field(default_factory=list)
    enqueue_s: list = field(default_factory=list)
    flops_per_request: float = 0.0
    peak: dict = field(default_factory=dict)
    trace: object = None           # trace.Trace of the traced stretch
    traced_requests: int = 0
    compared: list = field(default_factory=list)  # (program, reference)
    numbers: dict = field(default_factory=dict)   # every number compared
    checks: list = field(default_factory=list)    # (name, value, limit)
    device: dict = field(default_factory=dict)

    def mfu_pct(self) -> float | None:
        if not self.window_s or not self.peak:
            return None
        return 100.0 * self.flops_per_request * self.requests \
            / self.window_s / self.peak["bf16_flops"]

    def idle_pct(self) -> float | None:
        if self.trace is None or not self.trace.ops:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)

    def per_request_ms(self, pred) -> float | None:
        """Device ms a traced request of the ops that ``pred`` picks."""
        if self.trace is None or not self.trace.ops \
                or not self.traced_requests:
            return None
        return 1e3 * self.trace.device_s(pred) / self.traced_requests


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(bench: dict, workload: str) -> tuple[dict, dict, dict, dict]:
    """(cell, configuration, traffic mix, limits) of ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(ROOT / conf["file"])
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    return cell, config, mix, limits


def metrics_of(bench: dict, workload: str, trace: bool) -> list[dict]:
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: every
    module this process has loaded), compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def execute(workload: str, seed: int, seconds: float, trace: bool,
            t_start: float, device: str = "cuda", config_override=None,
            mix_override=None, fault=None,
            marks: dict | None = None) -> tuple[Run, dict]:
    """Run one cell; -> (run, result line).  ``device``,
    ``config_override`` and ``mix_override`` are for the CPU tests, and
    ``fault`` (``faults.py``: what the window drives in the program's
    place) for them and ``calibrate.py``: the runs of the benchmark take
    the defaults.  ``marks``: the clock at the end of each part of the
    set-up done before the call (``Run.marks``)."""
    bench = manifest()
    cell, config, mix, limits = cell_files(bench, workload)
    if config_override:
        config = {**config, "model": {**config["model"], **config_override}}
    if mix_override:
        mix = {**mix, **mix_override}
    run = Run(cell=workload, config=config, traffic=mix, seed=seed,
              seconds=seconds, marks=dict(marks or {}))
    kind = importlib.import_module(f"perfbench.kinds.{mix['kind']}")
    ref = importlib.import_module(f"perfbench.reference.{config['family']}")
    kind.run(run, ref, limits, device=device, trace=trace, t_start=t_start,
             fault=fault)
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = bool(run.checks) and all(
        math.isfinite(v) and v <= lim for _, v, lim in run.checks)
    line = {"correct": correct, "attempted": run.requests, "failed": 0,
            "metrics": metrics, "device": run.device}
    if trace and run.trace is not None and run.trace.ops:
        line["breakdown"] = run.trace.breakdown()
    line["setup_parts"] = run.setup_parts
    line["checks"] = {n: {"value": v if math.isfinite(v) else None,
                          "limit": lim} for n, v, lim in run.checks}
    return run, line


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    marks = {"imports_s": time.perf_counter()}
    bench = manifest()
    chips = next((w["chips"] for w in bench["workloads"]
                  if w["name"] == args.workload), 1)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"needs {chips} CUDA device(s), found {found}", file=sys.stderr)
        return 2
    marks["driver_s"] = time.perf_counter()
    run, line = execute(args.workload, args.seed, args.seconds,
                        bool(args.trace), t_start, marks=marks)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures repro_torch "
              f"alone", file=sys.stderr)
        return 3
    for name, v in line["checks"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
