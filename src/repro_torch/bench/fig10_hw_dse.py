"""Paper Fig. 10 + Table II: hardware DSE — MOBO vs NSGA-II vs random.
Port of ``benchmarks/fig10_hw_dse.py``; the inner software DSE's DQNs
train on ``--device`` (the card by default).

All methods get the same trial budget (evaluations are the expensive
resource); hypervolume curves are rescored against a shared reference so the
runs are comparable (paper plots all methods on one axis).  Reports the
paper's two headline metrics: final-hypervolume ratio MOBO/NSGA-II and the
trial count at which MOBO first exceeds NSGA-II's final hypervolume.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import workloads as W
from repro_torch.core.codesign import hw_objectives
from repro_torch.core.hw_space import HWSpace
from repro_torch.core.intrinsics import ALL_INTRINSICS
from repro_torch.core.matching import partition_space
from repro_torch.core.mobo import (mobo, rescore_hv_history,
                                   shared_reference)
from repro_torch.core.nsga2 import nsga2
from repro_torch.core.random_search import random_search


PAPER_AXES = {
    # the paper's FPGA regime: 4x4..64x64 PE arrays, <=1 MiB scratchpads
    "pe_rows": (4, 8, 16, 32, 64),
    "pe_cols": (4, 8, 16, 32, 64),
    "pe_depth": (4, 8, 16, 32, 64),
    "vmem_kib": (128, 256, 512, 1024),
}


def run(n_trials: int = 20, seed: int = 0, device="cuda"):
    wl = W.xception_ground_truth()[:4]
    part = partition_space([ALL_INTRINSICS["GEMM"]], wl)
    # one shared evaluation cache: hardware points probed by several methods
    # (same seed -> overlapping initial designs) are scored once
    from repro_torch.core.cost_model import EvalCache
    f = hw_objectives(wl, part, "GEMM", sw_budget="small", seed=seed,
                      cache=EvalCache(), device=device)
    base = HWSpace("GEMM")
    space = HWSpace("GEMM", axes={**base.axes, **PAPER_AXES})
    res_m = mobo(space, f, n_init=5, n_trials=n_trials, seed=seed)
    res_n = nsga2(space, f, pop_size=5, n_trials=n_trials, seed=seed)
    res_r = random_search(space, f, n_trials=n_trials, seed=seed)
    ref = shared_reference([res_m, res_n, res_r])
    curves = {
        "MOBO": rescore_hv_history(res_m, ref),
        "NSGAII": rescore_hv_history(res_n, ref),
        "random": rescore_hv_history(res_r, ref),
    }
    return curves, (res_m, res_n, res_r)


def main(seeds=(0, 1, 2), argv=None) -> None:
    """Multi-seed means: 20-trial DSE runs are noisy; the paper's comparison
    is about the expected behaviour of the methods."""
    from repro_torch.bench._results import parse_device

    device = parse_device(argv, __doc__.splitlines()[0]).device
    finals = {"MOBO": [], "NSGAII": [], "random": []}
    reach_speedups = []
    lat_under = {"MOBO": [], "NSGAII": [], "random": []}
    print("benchmark,method,trial,hypervolume,seed")
    for seed in seeds:
        curves, (res_m, res_n, res_r) = run(seed=seed, device=device)
        for method, hv in curves.items():
            finals[method].append(hv[-1])
            for t, v in enumerate(hv):
                print(f"fig10,{method},{t + 1},{v:.4f},{seed}")
        hv_n = curves["NSGAII"][-1]
        reach = next((t + 1 for t, v in enumerate(curves["MOBO"])
                      if v >= hv_n), None)
        if reach:
            reach_speedups.append(len(curves["NSGAII"]) / reach)
        bound = float(np.nanmedian(np.concatenate(
            [res_m.ys[:, 1], res_n.ys[:, 1], res_r.ys[:, 1]])))
        for name, res in (("MOBO", res_m), ("NSGAII", res_n),
                          ("random", res_r)):
            pick = res.best_under({1: bound})
            lat_under[name].append(pick[1][0] if pick else float("inf"))
    m, n, r = (float(np.mean(finals[k]))
               for k in ("MOBO", "NSGAII", "random"))
    print(f"fig10_summary,hv_ratio_mobo_vs_nsga2,,{m / n:.3f}")
    print(f"fig10_summary,hv_ratio_mobo_vs_random,,{m / r:.3f}")
    print(f"fig10_summary,trials_speedup_vs_nsga2,,"
          f"{float(np.mean(reach_speedups)) if reach_speedups else float('nan'):.2f}")
    print("table2,method,mean_best_latency_s_under_power_bound")
    for name, lats in lat_under.items():
        print(f"table2,{name},{float(np.mean(lats)):.4e}")


if __name__ == "__main__":
    main()
