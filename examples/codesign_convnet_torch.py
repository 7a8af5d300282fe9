"""End-to-end HASCO flow on a CNN workload set (the paper's primary
scenario) on the PyTorch port: ResNet convolution layers, edge power budget,
GEMM vs CONV2D intrinsics compared, Pareto front printed.  The software
DSE's DQNs train on the card; pass ``--device cpu`` to train them on the
CPU.

    PYTHONPATH=src python examples/codesign_convnet_torch.py [--layers 6] \\
        [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import Constraints, codesign, separate_design
from repro_torch.core import workloads as W
from repro_torch.core.hw_primitives import HWBuilder
from repro_torch.core.qlearning import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--power-w", type=float, default=2.0)
    ap.add_argument("--device", default="cuda",
                    help="where the DQNs train: 'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    wl = W.cnn_set("resnet")[: args.layers]
    cons = Constraints(power_w=args.power_w)
    print(f"application: {len(wl)} ResNet convolutions, "
          f"edge budget {args.power_w} W")

    report = codesign(wl, intrinsics=["GEMM", "CONV2D"], constraints=cons,
                      n_trials=args.trials, n_init=4, seed=0, device=device)
    for intr, res in report.per_intrinsic.items():
        ys = res.pareto_ys
        print(f"\n{intr} Pareto front ({len(ys)} points):")
        print("  latency_s      power_w    area_um2")
        for lat, pw, area in sorted(map(tuple, ys)):
            print(f"  {lat:.4e}  {pw:9.3f}  {area:.3e}")

    base_hw = (HWBuilder("GEMM").reshapeArray([8, 8], depth=16)
               .addCache(256).partitionBanks(1).build())
    base = separate_design(wl, base_hw, tuned_software=True)
    print(f"\ndecoupled baseline: {base.describe()}")
    if report.solution:
        print(f"co-designed       : {report.solution.describe()}")
        print(f"co-design speedup : "
              f"{base.latency_s / report.solution.latency_s:.2f}x")
    else:
        print("no feasible point under the constraint — raise --trials")


if __name__ == "__main__":
    main()
