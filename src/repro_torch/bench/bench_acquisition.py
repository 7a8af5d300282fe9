"""Microbenchmark: the vectorized Pareto/hypervolume acquisition engine
(DESIGN.md §9) against the pre-engine per-candidate scoring loops.

Two measurements, both gated:

  hvi        — exclusive-hypervolume scoring of a 256-candidate × 24-draw
               acquisition workload (the per-trial cost of MOBO stage 2)
               via one ``BoxDecomposition`` + ``hvi`` pass, vs the
               per-candidate ``_reference_hypervolume`` recompute loop.
               Gate: >= 10x speedup.
  mobo_e2e   — a full same-seed ``mobo()`` run (synthetic objectives, so
               acquisition dominates the wall-clock) with
               ``acquisition="vectorized"`` vs ``acquisition="reference"``.
               Gate: vectorized is strictly faster at equal trial budget
               AND reaches the same final hypervolume within 1e-6 relative
               (with these seeds the pick sequences are identical, so the
               histories agree to float precision).

A third, ungated row reports the q-batch mode (``q=4``) at the same trial
budget for context.  Prints CSV; exit code 1 if a gate is missed.  Port of
``benchmarks/bench_acquisition.py`` (host numpy, no device).

    PYTHONPATH=src python -m repro_torch.bench.bench_acquisition [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.hw_space import HWSpace
from repro_torch.core.mobo import mobo
from repro_torch.core.pareto import (BoxDecomposition,
                                     _reference_hypervolume,
                                     default_reference, pareto_front)

N_CANDIDATES = 256
N_DRAWS = 24
N_TRIALS = 18
TARGET_SPEEDUP = 10.0
HV_PARITY_RTOL = 1e-6

LAST_METRICS: dict = {}


def _objectives(hw):
    """Synthetic 3-objective surface over the hardware space (cheap on
    purpose: the benchmark times the *acquisition* machinery)."""
    n = hw.pe_rows * hw.pe_cols
    lat = 1.0 / n + hw.burst_bytes * 1e-9
    pow_ = n * 1e-3 + hw.vmem_kib * 1e-4
    area = n * 10.0 + hw.vmem_kib * 5.0
    return (lat, pow_, area)


def _best_of(fn, repeats: int = 3) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def run_hvi(n_cands: int = N_CANDIDATES, n_draws: int = N_DRAWS,
            seed: int = 0):
    """One acquisition round's worth of HVI scoring, both engines."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (48, 3))         # log-space objective cloud
    ref = default_reference(pts, margin=1.3)
    front = pareto_front(pts)
    cands = rng.uniform(0, 1.1, (n_cands * n_draws, 3))

    def scalar():
        hv0 = _reference_hypervolume(front, ref)
        return np.array([_reference_hypervolume(np.vstack([front, c[None]]),
                                                ref) - hv0 for c in cands])

    def vectorized():
        return BoxDecomposition(front, ref).hvi(cands)

    ref_vals = scalar()
    vec_vals = vectorized()
    err = float(np.abs(ref_vals - vec_vals).max())
    t_scalar = _best_of(scalar, repeats=1)   # ~10 s per rep; once is plenty
    t_vec = _best_of(vectorized)
    return t_scalar, t_vec, err, len(front)


def run_mobo(seed: int = 0, n_trials: int = N_TRIALS):
    """End-to-end same-seed MOBO, reference vs vectorized vs q-batch."""
    space = HWSpace("GEMM")
    t0 = time.perf_counter()
    res_v = mobo(space, _objectives, n_init=5, n_trials=n_trials, seed=seed)
    t_vec = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_r = mobo(space, _objectives, n_init=5, n_trials=n_trials, seed=seed,
                 acquisition="reference")
    t_ref = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_q = mobo(space, _objectives, n_init=5, n_trials=n_trials, seed=seed,
                 q=4)
    t_q = time.perf_counter() - t0
    return (t_ref, t_vec, t_q, res_r.hv_history[-1], res_v.hv_history[-1],
            res_q.hv_history[-1])


def main(argv=None) -> None:
    from repro_torch.bench._results import parse_device

    # the acquisition engine is host numpy: the flag only checks where it
    # may run
    parse_device(argv, __doc__.splitlines()[0])
    print("bench,case,metric,scalar_s,vectorized_s,speedup,detail")
    t_s, t_v, err, front_n = run_hvi()
    sp_hvi = t_s / t_v
    print(f"bench_acquisition,hvi,{N_CANDIDATES}x{N_DRAWS},{t_s:.4f},"
          f"{t_v:.4f},{sp_hvi:.1f},front={front_n} maxerr={err:.2e}")

    t_ref, t_vec, t_q, hv_r, hv_v, hv_q = run_mobo()
    sp_e2e = t_ref / t_vec
    hv_err = abs(hv_v - hv_r) / max(abs(hv_r), 1e-9)
    print(f"bench_acquisition,mobo_e2e,{N_TRIALS}_trials,{t_ref:.3f},"
          f"{t_vec:.3f},{sp_e2e:.1f},hv_ref={hv_r:.6f} hv_vec={hv_v:.6f} "
          f"rel_err={hv_err:.2e}")
    print(f"bench_acquisition,mobo_q4,{N_TRIALS}_trials,,{t_q:.3f},,"
          f"hv_q4={hv_q:.6f}")

    ok_hvi = sp_hvi >= TARGET_SPEEDUP
    ok_e2e = t_vec < t_ref
    ok_parity = hv_err <= HV_PARITY_RTOL and err <= 1e-9
    verdict = "PASS" if (ok_hvi and ok_e2e and ok_parity) else "FAIL"
    print(f"bench_acquisition,summary,hvi_speedup,{sp_hvi:.1f},target,"
          f"{TARGET_SPEEDUP:.0f},{verdict}")

    global LAST_METRICS
    LAST_METRICS = {
        "hvi_speedup": round(sp_hvi, 1),
        "hvi_scalar_s": round(t_s, 4), "hvi_vectorized_s": round(t_v, 4),
        "mobo_e2e_speedup": round(sp_e2e, 1),
        "mobo_reference_s": round(t_ref, 3),
        "mobo_vectorized_s": round(t_vec, 3), "mobo_q4_s": round(t_q, 3),
        "hv_parity_rel_err": hv_err, "target_speedup": TARGET_SPEEDUP,
        "pass": ok_hvi and ok_e2e and ok_parity,
    }
    if verdict == "FAIL":
        raise SystemExit(1)


if __name__ == "__main__":
    main()
