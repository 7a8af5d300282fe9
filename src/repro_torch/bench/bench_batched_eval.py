"""Microbenchmark: batched vs scalar cost-model evaluation (DESIGN.md §4.3).

The DSE hot path scores thousands of (hw config, schedule) candidates per
run.  This benchmark times a 1024-candidate population three ways:

  scalar   — the original per-candidate Python loop (``_evaluate_reference``)
  batched  — one ``evaluate_batch`` call (vectorized structure-of-arrays)
  cached   — ``evaluate_batch`` re-scoring an already-seen population
             through an :class:`EvalCache` (the repeated-probe case MOBO
             iterations hit constantly)

Acceptance target: batched >= 10x scalar throughput on 1024 candidates.
Prints CSV like the other benchmarks; exit code 1 if the target is missed.
Port of ``benchmarks/bench_batched_eval.py`` (host numpy, no device).

    PYTHONPATH=src python -m repro_torch.bench.bench_batched_eval [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core import workloads as W
from repro_torch.core.cost_model import (EvalCache, _evaluate_reference,
                                         evaluate_batch)
from repro_torch.core.hw_space import HWSpace
from repro_torch.core.intrinsics import ALL_INTRINSICS
from repro_torch.core.matching import match
from repro_torch.core.sw_space import SoftwareSpace

N_CANDIDATES = 1024
TARGET_SPEEDUP = 10.0

LAST_METRICS: dict = {}   # filled by main(); read by repro_torch.bench.run


def _population(wl, intrinsic: str, n: int, seed: int):
    """n random (hw, schedule) candidates for one workload × intrinsic."""
    rng = np.random.default_rng(seed)
    choices = match(ALL_INTRINSICS[intrinsic], wl)
    hws = HWSpace(intrinsic).sample(rng, 8)
    space = SoftwareSpace(wl, choices, hws[0], "spatial")
    schedules = [space.random_schedule(rng) for _ in range(n)]
    hw_list = [hws[int(rng.integers(len(hws)))] for _ in range(n)]
    return hw_list, schedules


def _best_of(fn, repeats: int = 3) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def run(n: int = N_CANDIDATES, seed: int = 0):
    rows = []
    cases = [
        ("gemm512", W.gemm(512, 512, 512), "GEMM"),
        ("conv2d_resnet", W.conv2d(128, 64, 28, 28), "GEMM"),
    ]
    for name, wl, intrinsic in cases:
        hw_list, schedules = _population(wl, intrinsic, n, seed)
        evaluate_batch(wl, hw_list, schedules)   # warm prep caches

        t_scalar = _best_of(lambda: [
            _evaluate_reference(wl, s, h, "spatial")
            for s, h in zip(schedules, hw_list)])
        t_batch = _best_of(lambda: evaluate_batch(wl, hw_list, schedules))
        cache = EvalCache()
        evaluate_batch(wl, hw_list, schedules, cache=cache)  # populate
        t_cached = _best_of(lambda: evaluate_batch(wl, hw_list, schedules,
                                                   cache=cache))
        rows.append((name, n, t_scalar, t_batch, t_cached,
                     t_scalar / t_batch, t_scalar / t_cached))
    return rows


def main(argv=None) -> None:
    from repro_torch.bench._results import parse_device

    # the cost model is host numpy: the flag only checks where it may run
    parse_device(argv, __doc__.splitlines()[0])
    rows = run()
    print("bench,case,candidates,scalar_s,batched_s,cached_s,"
          "speedup_batched,speedup_cached")
    worst = float("inf")
    for name, n, ts, tb, tc, sp_b, sp_c in rows:
        print(f"bench_batched_eval,{name},{n},{ts:.4f},{tb:.4f},{tc:.4f},"
              f"{sp_b:.1f},{sp_c:.1f}")
        worst = min(worst, sp_b)
    ok = worst >= TARGET_SPEEDUP
    print(f"bench_batched_eval,summary,worst_speedup,{worst:.1f},"
          f"target,{TARGET_SPEEDUP:.0f},{'PASS' if ok else 'FAIL'}")
    global LAST_METRICS
    LAST_METRICS = {
        "worst_speedup_batched": round(worst, 1),
        "target_speedup": TARGET_SPEEDUP, "pass": ok,
        "cases": {name: {"scalar_s": round(ts, 4), "batched_s": round(tb, 4),
                         "cached_s": round(tc, 4)}
                  for name, _, ts, tb, tc, _, _ in rows},
    }
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
