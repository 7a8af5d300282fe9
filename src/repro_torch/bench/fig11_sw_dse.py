"""Paper Fig. 11 + §VII-D: software quality on a fixed accelerator.  Port
of ``benchmarks/fig11_sw_dse.py``; HASCO's DQNs train on ``--device`` (the
card by default).

GEMMCore (16×16 PE, 256 KiB scratchpad) runs ResNet convolutions under three
software stacks:
  * library    — im2col conversion + array-shape splitting (Gemmini library
                 style; pays materialized im2col/col2im traffic),
  * template   — AutoTVM-style: fixed tensorize choice + source loop order,
                 only tile sizes tuned,
  * HASCO      — full tensorize-choice + primitive exploration
                 (heuristic + Q-learning).
Paper claims: HASCO ≈3.17× vs library, ≈1.21× vs AutoTVM.
"""
from __future__ import annotations

from repro_torch.core import workloads as W
from repro_torch.core.codesign import (human_template_choice,
                                       library_schedule, template_search)
from repro_torch.core.cost_model import evaluate
from repro_torch.core.hw_primitives import HWBuilder
from repro_torch.core.intrinsics import GEMM
from repro_torch.core.matching import match
from repro_torch.core.sw_dse import optimize

GEMMCORE = (HWBuilder("GEMM").reshapeArray([16, 16], depth=16)
            .addCache(256).partitionBanks(2).build())


def run(n_layers: int = 10, device="cuda"):
    rows = []
    for w in W.cnn_set("resnet")[:n_layers]:
        choices = match(GEMM, w)
        _, lib_lat, lib_ovh = library_schedule(w, GEMMCORE)
        tmpl_choice = human_template_choice(w, choices)
        tmpl = template_search(w, tmpl_choice, GEMMCORE, seed=0, budget=48)
        tmpl_lat = evaluate(w, tmpl, GEMMCORE).latency_s
        hasco = optimize(w, choices, GEMMCORE, pool_size=24, rounds=10, k=6,
                         seed=0, device=device)
        rows.append((w.name, lib_lat, lib_ovh, tmpl_lat, hasco.latency_s))
    return rows


def main(argv=None) -> None:
    from repro_torch.bench._results import parse_device

    device = parse_device(argv, __doc__.splitlines()[0]).device
    rows = run(device=device)
    print("benchmark,layer,library_us,im2col_overhead_us,template_us,"
          "hasco_us,speedup_vs_library,speedup_vs_template")
    gl, gt, gh = 0.0, 0.0, 0.0
    for name, lib, ovh, tmpl, hasco in rows:
        print(f"fig11,{name},{lib*1e6:.2f},{ovh*1e6:.2f},{tmpl*1e6:.2f},"
              f"{hasco*1e6:.2f},{lib/hasco:.2f},{tmpl/hasco:.2f}")
        gl += lib
        gt += tmpl
        gh += hasco
    print(f"fig11_summary,geo_total,,,,,"
          f"{gl/gh:.2f},{gt/gh:.2f}")


if __name__ == "__main__":
    main()
