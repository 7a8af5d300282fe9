"""Paper Table III: overall co-design benefit under power constraints.
Port of ``benchmarks/table3_codesign.py``; the software DSE's DQNs train on
``--device`` (the card by default).

Edge (2 W) and cloud (20 W) scenarios.  Baseline = the traditional decoupled
flow (a fixed default GEMMCore, AutoTVM-style software tuned afterwards);
HASCO-GEMMCore / HASCO-ConvCore = the full co-design loop per intrinsic.
Paper claims 1.25–1.44× latency from co-design, and ConvCore a further
≈1.42× on convolution sets.
"""
from __future__ import annotations

import math

from repro_torch.core import workloads as W
from repro_torch.core.codesign import Constraints, codesign, separate_design
from repro_torch.core.hw_primitives import HWBuilder

SCENARIOS = {
    "edge": dict(power_w=2.0,
                 base=HWBuilder("GEMM").reshapeArray([8, 8], depth=16)
                 .addCache(256).partitionBanks(1).build()),
    "cloud": dict(power_w=20.0,
                  base=HWBuilder("GEMM").reshapeArray([64, 64], depth=64)
                  .addCache(1024).partitionBanks(1).build()),
}


def run(n_layers: int = 6, n_trials: int = 20, device="cuda"):
    wl = W.cnn_set("resnet")[:n_layers]
    rows = []
    for scen, spec in SCENARIOS.items():
        cons = Constraints(power_w=spec["power_w"])
        base = separate_design(wl, spec["base"], tuned_software=True, seed=0)
        gemm = codesign(wl, intrinsics=["GEMM"], constraints=cons,
                        n_trials=n_trials, n_init=6, seed=0,
                        device=device)
        conv = codesign(wl, intrinsics=["CONV2D"], constraints=cons,
                        n_trials=n_trials, n_init=6, seed=0,
                        device=device)
        rows.append((scen, base, gemm.solution, conv.solution))
    return rows


def main(argv=None) -> None:
    from repro_torch.bench._results import parse_device

    device = parse_device(argv, __doc__.splitlines()[0]).device
    rows = run(device=device)
    print("benchmark,scenario,system,pe,vmem_kib,banks,latency_us,power_w,"
          "speedup_vs_baseline")
    for scen, base, gemm, conv in rows:
        def emit(tag, sol):
            if sol is None:
                print(f"table3,{scen},{tag},,,,inf,,")
                return
            hw = sol.hw
            sp = base.latency_s / sol.latency_s \
                if math.isfinite(sol.latency_s) else 0.0
            print(f"table3,{scen},{tag},{hw.pe_rows}x{hw.pe_cols},"
                  f"{hw.vmem_kib},{hw.banks},{sol.latency_s*1e6:.1f},"
                  f"{sol.power_w:.2f},{sp:.2f}")
        emit("baseline-GEMMCore", base)
        emit("HASCO-GEMMCore", gemm)
        emit("HASCO-ConvCore", conv)


if __name__ == "__main__":
    main()
