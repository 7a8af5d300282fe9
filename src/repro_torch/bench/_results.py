"""Shared writer for ``artifacts/torch_bench_results.json``, and the
``--device`` flag every script takes.

Port of ``benchmarks/_results.py``.  ``repro_torch.bench.run`` rewrites the
whole document after a full suite; individually-run gated scripts
(bench_sw_dse, bench_serve, bench_obs, bench_serve_tp) call
:func:`publish` to merge just their own entry.  The document has the
reference's shape, under its own name: it is never the reference's
``artifacts/bench_results.json``, and it is no ``BENCHMARK.json``.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

RESULTS_PATH = (Path(__file__).resolve().parents[3] / "artifacts"
                / "torch_bench_results.json")


def publish(name: str, metrics: dict, *, failed: bool) -> None:
    """Merge one benchmark's entry into torch_bench_results.json (the
    shape ``repro_torch.bench.run`` writes) without clobbering other
    entries."""
    RESULTS_PATH.parent.mkdir(parents=True, exist_ok=True)
    try:
        doc = json.loads(RESULTS_PATH.read_text())
        assert isinstance(doc.get("results"), list)
    except Exception:
        doc = {"results": []}
    doc["generated_unix"] = int(time.time())
    doc["results"] = [r for r in doc["results"] if r.get("name") != name]
    doc["results"].append({"name": name, "failed": failed,
                           "metrics": metrics})
    RESULTS_PATH.write_text(json.dumps(doc, indent=2) + "\n")


def parse_device(argv=None, description: str | None = None,
                 parser: argparse.ArgumentParser | None = None
                 ) -> argparse.Namespace:
    """``--device`` (default the card): where the DQNs, models and kernels
    run.  Asking for the card where there is none raises, as
    ``core.qlearning.resolve_device`` does."""
    from repro_torch.core.qlearning import resolve_device

    ap = parser or argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain versions)")
    args = ap.parse_args(argv)
    args.device = str(resolve_device(args.device))
    return args


def impl_for(device) -> str:
    """The serving ``impl`` for a device: the kernels on the card, the
    plain versions on the CPU."""
    return "cuda" if str(device).startswith("cuda") else "torch"
