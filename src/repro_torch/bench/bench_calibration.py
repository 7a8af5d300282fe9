"""Calibration benchmark (DESIGN.md §8.2): does fitting the per-op
correction on measured latencies improve how well the cost model *ranks*
candidates?

Builds a 64-candidate GEMM population (random hardware knobs × random
schedules), measures every candidate through the tuner's measurement backend
(deduplicated lowerings): on the card (``--device cuda``, the default) the
hand-written ``gemm`` kernel, on the CPU its plain version.  Fits the
log-linear correction on a train split, and reports the Spearman rank
correlation between predicted and measured latency on the held-out split —
before vs. after calibration.  Port of ``benchmarks/bench_calibration.py``.

The tuner times a candidate by the host clock around a synchronised call
(``tuner/measure.py``); a 64³ GEMM's device time is below the host cost of
one call, so the measured ranking is mostly host noise.

  PYTHONPATH=src python -m repro_torch.bench.bench_calibration [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np

POPULATION = 64
TRAIN = 44

LAST_METRICS: dict = {}   # filled by main(); read by repro_torch.bench.run


def build_population(wl, choice, n, seed=7):
    from repro_torch.core.hw_primitives import HWConfig
    from repro_torch.core.sw_primitives import Schedule

    rng = np.random.default_rng(seed)
    loops = list(choice.mapped_compute_indices)
    hws, scheds = [], []
    for _ in range(n):
        hws.append(HWConfig(
            intrinsic="GEMM", pe_rows=int(rng.choice([8, 16, 32])),
            pe_cols=int(rng.choice([8, 16, 32])),
            pe_depth=int(rng.choice([8, 16, 32])),
            vmem_kib=int(rng.choice([256, 1024, 4096])),
            banks=int(rng.choice([1, 2])),
            burst_bytes=int(rng.choice([256, 1024, 4096])),
            dataflow=str(rng.choice(["OS", "WS", "IS"]))))
        tiles = tuple(sorted((c, int(rng.choice([16, 32, 64])))
                             for c in loops))
        order = list(wl.all_indices())
        rng.shuffle(order)
        scheds.append(Schedule(choice, tiles, tuple(order), 0))
    return hws, scheds


def run(backend: str = "cuda") -> dict:
    """Measure the population on ``backend`` ('cuda' or 'torch'), fit,
    and return the row's values."""
    from repro_torch.core import workloads as W
    from repro_torch.core.cost_model import evaluate_batch_reports
    from repro_torch.core.intrinsics import GEMM
    from repro_torch.core.matching import match
    from repro_torch.tuner import calibrate as C
    from repro_torch.tuner import measure as M

    wl = W.gemm(64, 64, 64, name="bench_cal")
    choice = match(GEMM, wl)[0]
    hws, scheds = build_population(wl, choice, POPULATION)

    reports = evaluate_batch_reports(wl, hws, scheds, "tpu")
    t0 = time.time()
    meas = M.measure_batch(wl, hws, scheds,
                           M.MeasureOptions(backend=backend, warmup=2,
                                            repeats=7))
    t_measure = time.time() - t0
    n_points = len({m.point for m in meas if m.ok})
    n_fail = sum(not m.ok for m in meas)

    pred = np.array([r.latency_s for r in reports])
    truth = np.array([m.latency_s for m in meas])

    cal = C.fit(C.collect_samples(wl, reports[:TRAIN], meas[:TRAIN]))
    corrected = C.CalibratedCostModel(cal).predict_latency(
        wl, reports[TRAIN:])
    before = C.spearman(pred[TRAIN:], truth[TRAIN:])
    after = C.spearman(corrected, truth[TRAIN:])
    before_all = C.spearman(pred, truth)
    return {"n_points": n_points, "n_fail": n_fail, "t_measure": t_measure,
            "before_all": before_all, "before": before, "after": after,
            "correction": cal.for_op("gemm").kind}


def main(argv=None) -> None:
    from repro_torch.bench._results import impl_for, parse_device

    device = parse_device(argv, __doc__.splitlines()[0]).device
    r = run(impl_for(device))
    n_points, n_fail, t_measure = r["n_points"], r["n_fail"], r["t_measure"]
    before_all, before, after = r["before_all"], r["before"], r["after"]
    print("population,train,heldout,distinct_kernels,failures,"
          "measure_s,spearman_before_all,spearman_before,spearman_after,"
          "correction")
    print(f"{POPULATION},{TRAIN},{POPULATION - TRAIN},{n_points},{n_fail},"
          f"{t_measure:.1f},{before_all:.3f},{before:.3f},{after:.3f},"
          f"{r['correction']}")
    print(f"# held-out Spearman(analytical, measured): {before:.3f} -> "
          f"{after:.3f} after calibration "
          f"({'improved' if after > before else 'NOT improved'})")
    global LAST_METRICS
    LAST_METRICS = {
        "population": POPULATION, "train": TRAIN,
        "spearman_before": round(float(before), 3),
        "spearman_after": round(float(after), 3),
        "measure_s": round(t_measure, 1), "failures": int(n_fail),
        "backend": impl_for(device),
    }


if __name__ == "__main__":
    main()
