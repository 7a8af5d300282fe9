"""Paper Fig. 7: tensor computations × hardware intrinsics.  Port of
``benchmarks/fig7_intrinsics.py``; the software DSE's DQNs train on
``--device`` (the card by default).

All four intrinsics get the same resource budget (the paper's 64 PEs +
256 KiB scratchpad); per (workload, intrinsic) the software DSE finds the
best schedule and we report normalized throughput.  Expected orderings
(paper §VII-B): TTM/GEMM prefer GEMM, conv prefers CONV2D, DOT is worst
everywhere, MTTKRP prefers GEMV (via the two-stage rewrite).
"""
from __future__ import annotations

import math

from repro_torch.core import workloads as W
from repro_torch.core.hw_primitives import HWBuilder
from repro_torch.core.intrinsics import ALL_INTRINSICS
from repro_torch.core.matching import partition_space
from repro_torch.core.sw_dse import optimize

PE_BUDGET_HW = {
    # same 64-PE + 256 KiB budget, shaped per intrinsic family
    "GEMM": HWBuilder("GEMM").reshapeArray([8, 8], depth=16)
    .addCache(256).partitionBanks(2).build(),
    "CONV2D": HWBuilder("CONV2D").reshapeArray([8, 8], depth=16)
    .addCache(256).partitionBanks(2).build(),
    "GEMV": HWBuilder("GEMV").reshapeArray([8, 8], depth=8)
    .addCache(256).partitionBanks(2).build(),
    "DOT": HWBuilder("DOT").reshapeArray([8, 8], depth=64)
    .addCache(256).partitionBanks(2).build(),
}


def workload_sets() -> dict[str, list]:
    return {
        "GEMM": W.table1_gemm()[2:6],
        "TTM": W.table1_ttm()[2:6],
        "CONV": W.table1_conv()[:4],
        "MTTKRP": [w for i in (1, 3) for w in W.mttkrp_stages(
            *[64, 64, 64, 32][:4], name=f"mtt{i}")],
    }


HOST_FALLBACK_FLOPS = 1e9  # workloads the intrinsic cannot tile run here
# (paper §VII-B: the GEMM intrinsic covers only MTTKRP's first stage; the
#  uncovered stage determines the application-level preference)


def run(budget_rounds: int = 3, pool: int = 10, device="cuda"
        ) -> list[tuple]:
    rows = []
    intr = list(ALL_INTRINSICS.values())
    for comp_name, wl in workload_sets().items():
        part = partition_space(intr, wl)
        for iname, hw in PE_BUDGET_HW.items():
            total_lat, total_flops, covered = 0.0, 0.0, 0
            for w in wl:
                choices = part.get((w.name, iname))
                res_lat = math.inf
                if choices:
                    res = optimize(w, choices, hw, pool_size=pool,
                                   rounds=budget_rounds, k=4, seed=0,
                                   device=device)
                    res_lat = res.latency_s
                if math.isfinite(res_lat):
                    covered += 1
                else:
                    res_lat = w.flops() / HOST_FALLBACK_FLOPS
                total_lat += res_lat
                total_flops += w.flops()
            if covered:
                thr = total_flops / total_lat / 1e9  # GFLOP/s, app level
                rows.append((comp_name, iname, covered, thr,
                             total_lat * 1e6 / len(wl)))
    return rows


def main(argv=None) -> None:
    from repro_torch.bench._results import parse_device

    rows = run(device=parse_device(argv, __doc__.splitlines()[0]).device)
    best = {}
    for comp, iname, covered, thr, us in rows:
        best.setdefault(comp, (0.0, ""))
        if thr > best[comp][0]:
            best[comp] = (thr, iname)
    print("benchmark,workload,intrinsic,covered,gflops,us_per_call")
    for comp, iname, covered, thr, us in rows:
        print(f"fig7,{comp},{iname},{covered},{thr:.3f},{us:.2f}")
    for comp, (thr, iname) in best.items():
        print(f"fig7_best,{comp},{iname},,{thr:.3f},")


if __name__ == "__main__":
    main()
