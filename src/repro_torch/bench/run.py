"""Benchmark harness of the port: one module per paper table/figure
(DESIGN.md §7).  Port of ``benchmarks/run.py``.

  fig7_intrinsics    Fig. 7   tensor computations × hardware intrinsics
  fig10_hw_dse       Fig. 10 + Table II  MOBO vs NSGA-II vs random
  fig11_sw_dse       Fig. 11  HASCO software vs im2col library vs template
  table3_codesign    Table III  co-design vs decoupled, edge/cloud power
  kernel_micro       host-side kernel microbenchmarks
  bench_batched_eval batched vs scalar cost-model evaluation throughput
  bench_acquisition  vectorized Pareto/HVI engine vs per-candidate loops
                     (DESIGN.md §9)
  bench_sw_dse       lock-step batched software-DSE engine vs sequential
                     per-search reference (DESIGN.md §10)
  bench_calibration  analytical-vs-measured rank correlation, before/after
                     per-op calibration (DESIGN.md §8)
  bench_serve        continuous-batching serving engine vs sequential
                     one-request-at-a-time baseline (DESIGN.md §11)

Each prints CSV; ``python -m repro_torch.bench.run`` runs them all on
``--device`` (default the card) and writes a machine-readable summary —
per-benchmark name, key metrics (a module's ``LAST_METRICS`` dict, when it
publishes one), wall-clock, gate outcome — to
``artifacts/torch_bench_results.json``.  A missed gate fails the run after
the rest of the suite has run.

    PYTHONPATH=src python -m repro_torch.bench.run [--device cpu]
"""
from __future__ import annotations

import json
import time

from repro_torch.bench import _results


def main(argv=None) -> None:
    from repro_torch.bench import (ablation_qlearning, bench_acquisition,
                                   bench_batched_eval, bench_calibration,
                                   bench_serve, bench_sw_dse,
                                   fig7_intrinsics, fig10_hw_dse,
                                   fig11_sw_dse, kernel_micro,
                                   table3_codesign)

    device = _results.parse_device(argv, __doc__.splitlines()[0]).device
    results_path = _results.RESULTS_PATH

    failures = []
    results = []
    try:
        for mod in (kernel_micro, bench_batched_eval, bench_acquisition,
                    bench_sw_dse, bench_serve, bench_calibration,
                    fig7_intrinsics,
                    fig11_sw_dse, fig10_hw_dse, table3_codesign,
                    ablation_qlearning):
            name = mod.__name__.split(".")[-1]
            print(f"# === {name} ===", flush=True)
            t0 = time.time()
            failed = False
            try:
                mod.main(argv=["--device", device])
            except SystemExit as e:  # a gated benchmark (e.g. the 10x
                # batched-eval target) must not abort the rest of the suite
                if e.code:
                    failed = True
                    failures.append(name)
                    print(f"# {name} FAILED its gate (exit {e.code})",
                          flush=True)
            wall = time.time() - t0
            print(f"# {name} done in {wall:.1f}s", flush=True)
            results.append({"name": name, "wall_clock_s": round(wall, 3),
                            "failed": failed,
                            "metrics": getattr(mod, "LAST_METRICS", None)
                            or {}})
    finally:
        # persist whatever completed even if a benchmark crashes outright
        results_path.parent.mkdir(parents=True, exist_ok=True)
        results_path.write_text(json.dumps(
            {"generated_unix": int(time.time()), "results": results,
             "quarantined_candidates": _quarantined_count()},
            indent=2) + "\n")
        print(f"# wrote {results_path}", flush=True)
    if failures:
        raise SystemExit(f"gated benchmarks failed: {', '.join(failures)}")


def _quarantined_count() -> int:
    """Persistently-failing kernel candidates in the default tuning DB
    (DESIGN.md §14) — surfaced so a growing quarantine is visible in the
    tracked benchmark artifact, not buried in the DB."""
    try:
        from repro_torch.tuner.db import DEFAULT_DB_PATH, TuningDB

        n = len(TuningDB.load(DEFAULT_DB_PATH).quarantine)
    except Exception:
        return 0
    if n:
        print(f"# WARNING: {n} kernel candidate(s) quarantined in "
              f"{DEFAULT_DB_PATH} — these are skipped by measurement runs",
              flush=True)
    return n


if __name__ == "__main__":
    main()
