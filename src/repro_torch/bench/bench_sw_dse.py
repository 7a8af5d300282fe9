"""Microbenchmark: the lock-step batched software-DSE engine (DESIGN.md §10)
against the sequential per-search reference.

Two measurements, both gated:

  round_loop — 16 concurrent searches (4 GEMM/conv workloads × 4 accelerator
               candidates, the shape of one ``mobo(q=4)`` trial) × 12-pool ×
               16-round × k=6 heuristic+Q-learning DSE: ``engine="batched"``
               vs ``engine="reference"``.  96 transitions per search, so the
               per-search DQNs genuinely train.  Gate: >= 5x speedup AND
               bit-exact best-schedule/latency parity per search (best-of-2
               timings).
  codesign_q4 — a full same-seed ``codesign(q=4)`` run (2 workloads, GEMM
               intrinsic) with both engines, warmed up.  Gate: batched is
               strictly faster AND commits the identical solution.

Prints CSV; exit code 1 if a gate is missed.  Also merges its metrics into
``artifacts/torch_bench_results.json`` without running the whole
``repro_torch.bench.run`` suite.  Port of ``benchmarks/bench_sw_dse.py``: the
DQNs (the batched bank and the per-search agents alike) train on
``--device`` (the card by default).

    PYTHONPATH=src python -m repro_torch.bench.bench_sw_dse [--device cpu]
"""
from __future__ import annotations

import time

N_SEARCHES = 16
POOL = 12
ROUNDS = 16
K = 6
TARGET_SPEEDUP = 5.0

LAST_METRICS: dict = {}


def _specs():
    from repro_torch.core import workloads as W
    from repro_torch.core.hw_primitives import HWBuilder
    from repro_torch.core.intrinsics import ALL_INTRINSICS
    from repro_torch.core.matching import match
    from repro_torch.core.sw_dse import SearchSpec

    gemm = ALL_INTRINSICS["GEMM"]
    wls = [W.gemm(256, 256, 128, name="g0"), W.gemm(512, 128, 256, name="g1"),
           W.gemm(128, 512, 512, name="g2"),
           W.conv2d(32, 16, 14, 14, name="c0")]
    hws = [(HWBuilder("GEMM").reshapeArray([r, c], depth=16)
            .addCache(kib).partitionBanks(2).build())
           for r, c, kib in [(16, 16, 256), (8, 32, 128), (32, 8, 512),
                             (16, 8, 256)]]
    out, n = [], 0
    for hw in hws:
        for w in wls:
            out.append(SearchSpec(w, match(gemm, w), hw, 17 * n))
            n += 1
    assert len(out) == N_SEARCHES
    return out


def run_round_loop(device="cuda", n_searches: int = N_SEARCHES):
    from repro_torch.core.sw_dse import run_searches

    cfg = dict(pool_size=POOL, rounds=ROUNDS, k=K, device=device)
    specs = _specs()[:n_searches]
    bat = run_searches(specs, engine="batched", **cfg)    # warm-up
    ref = run_searches(specs, engine="reference", **cfg)
    parity = all(r.schedule == b.schedule and r.latency_s == b.latency_s
                 and r.history == b.history for r, b in zip(ref, bat))

    t_bat = t_ref = float("inf")                      # best-of-2: de-noise
    for _ in range(2):                                # shared-runner jitter
        t0 = time.perf_counter()
        run_searches(specs, engine="batched", **cfg)
        t_bat = min(t_bat, time.perf_counter() - t0)
        t0 = time.perf_counter()
        run_searches(specs, engine="reference", **cfg)
        t_ref = min(t_ref, time.perf_counter() - t0)
    return t_ref, t_bat, parity, ref, bat


def run_codesign_q4(device="cuda"):
    from repro_torch.core import workloads as W
    from repro_torch.core.codesign import codesign

    wl = [W.gemm(256, 256, 128, name="g0"),
          W.conv2d(32, 16, 14, 14, name="c0")]
    kw = dict(intrinsics=["GEMM"], n_trials=10, n_init=4, seed=0, q=4,
              device=device)
    rb = codesign(wl, **kw)                           # warm-up
    rr = codesign(wl, engine="reference", **kw)

    def _best_of(fn, repeats: int = 2) -> float:      # de-noise: these are
        best = float("inf")                           # single-second runs on
        for _ in range(repeats):                      # a shared host
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best

    t_bat = _best_of(lambda: codesign(wl, **kw))
    t_ref = _best_of(lambda: codesign(wl, engine="reference", **kw))
    same = (rb.solution is not None and rr.solution is not None
            and rb.solution.latency_s == rr.solution.latency_s
            and rb.solution.hw.encode() == rr.solution.hw.encode()
            and rb.solution.schedules == rr.solution.schedules)
    return t_ref, t_bat, same, rb.solution


def main(argv=None) -> None:
    from repro_torch.bench._results import parse_device

    device = parse_device(argv, __doc__.splitlines()[0]).device
    print("bench,case,metric,reference_s,batched_s,speedup,detail")
    t_ref, t_bat, parity, _, _ = run_round_loop(device)
    sp = t_ref / t_bat
    print(f"bench_sw_dse,round_loop,{N_SEARCHES}x{POOL}x{ROUNDS},"
          f"{t_ref:.3f},{t_bat:.3f},{sp:.1f},parity={parity}")

    t_cref, t_cbat, same, _ = run_codesign_q4(device)
    sp_c = t_cref / t_cbat
    print(f"bench_sw_dse,codesign_q4,10_trials,{t_cref:.3f},{t_cbat:.3f},"
          f"{sp_c:.1f},identical_solution={same}")

    ok = (sp >= TARGET_SPEEDUP) and parity and (t_cbat < t_cref) and same
    verdict = "PASS" if ok else "FAIL"
    print(f"bench_sw_dse,summary,round_loop_speedup,{sp:.1f},target,"
          f"{TARGET_SPEEDUP:.0f},{verdict}")

    global LAST_METRICS
    LAST_METRICS = {
        "round_loop_speedup": round(sp, 1),
        "round_loop_reference_s": round(t_ref, 3),
        "round_loop_batched_s": round(t_bat, 3),
        "round_loop_parity": parity,
        "codesign_q4_speedup": round(sp_c, 2),
        "codesign_q4_reference_s": round(t_cref, 3),
        "codesign_q4_batched_s": round(t_cbat, 3),
        "codesign_q4_identical": same,
        "target_speedup": TARGET_SPEEDUP,
        "pass": ok,
    }
    from repro_torch.bench._results import publish
    publish("bench_sw_dse", LAST_METRICS, failed=not ok)
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
