"""Ablation: the Q-learning revision policy vs random revisions in the
software DSE (paper §VI-B motivates DQN over 'exhaustively trying out all
the possible revision choices'; this quantifies the component's value under
equal evaluation budgets, 3-seed means).  Port of
``benchmarks/ablation_qlearning.py``; the DQNs train on ``--device`` (the
card by default)."""
from __future__ import annotations

import numpy as np

from repro_torch.core import workloads as W
from repro_torch.core.hw_primitives import HWBuilder
from repro_torch.core.intrinsics import GEMM
from repro_torch.core.matching import match
from repro_torch.core.sw_dse import optimize

HW = (HWBuilder("GEMM").reshapeArray([16, 16], depth=16)
      .addCache(256).partitionBanks(2).build())


def run(seeds=(0, 1, 2), device="cuda"):
    wls = [W.gemm(512, 512, 512), W.conv2d(128, 64, 28, 28),
           W.ttm(128, 64, 64, 64)]
    rows = []
    for w in wls:
        choices = match(GEMM, w)
        for use_q in (True, False):
            lats = []
            for seed in seeds:
                res = optimize(w, choices, HW, pool_size=16, rounds=8, k=4,
                               seed=seed, use_qlearning=use_q,
                               device=device)
                lats.append(res.latency_s)
            rows.append((w.name, "dqn" if use_q else "random-revision",
                         float(np.mean(lats)), float(np.std(lats))))
    return rows


def main(argv=None) -> None:
    from repro_torch.bench._results import parse_device

    device = parse_device(argv, __doc__.splitlines()[0]).device
    rows = run(device=device)
    print("benchmark,workload,revision_policy,mean_latency_us,std_us")
    for name, pol, mean, std in rows:
        print(f"ablation_ql,{name},{pol},{mean*1e6:.2f},{std*1e6:.2f}")
    by = {}
    for name, pol, mean, _ in rows:
        by.setdefault(name, {})[pol] = mean
    for name, d in by.items():
        print(f"ablation_ql_summary,{name},dqn_speedup,"
              f"{d['random-revision'] / d['dqn']:.3f},")


if __name__ == "__main__":
    main()
