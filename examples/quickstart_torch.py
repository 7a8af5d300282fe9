"""Quickstart of the PyTorch/CUDA port: HASCO co-design in ~40 lines.

Co-designs one accelerator (hardware intrinsic + parameters) and per-workload
schedules for a tiny two-workload application, saves the solution registry,
and runs the hand-written GEMM kernel with the co-designed block shapes on
the card, printing its max error against the plain PyTorch version.

    PYTHONPATH=src python examples/quickstart_torch.py               # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.core import Constraints, codesign
from repro_torch.core import solution as registry
from repro_torch.core import workloads as W
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ops import IMPLEMENTATIONS, DEVICE_OF


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (the CUDA kernel), or the CPU (the plain "
                         "PyTorch version)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run on the card, or pass "
                         "--device cpu")
    impl = next(i for i in IMPLEMENTATIONS if DEVICE_OF[i] == args.device)

    # 1. an "application": two tensor computations sharing one accelerator
    app = [W.conv2d(64, 32, 28, 28, name="conv3x3"),
           W.gemm(256, 256, 128, name="proj")]

    # 2. co-design: partition (TST matching) -> MOBO hardware DSE driven by
    #    heuristic + Q-learning software DSE -> constrained solution
    report = codesign(app, intrinsics=["GEMM"], n_trials=8, n_init=4,
                      constraints=Constraints(power_w=50.0), seed=0,
                      device=args.device)
    sol = report.solution
    if sol is None:
        raise SystemExit("no feasible design point under constraints")
    print("co-designed solution:")
    print(" ", sol.describe())
    for wname, sched in sol.schedules.items():
        print(f"  {wname}: {sched.describe()}")

    # 3. persist and consume: the registry feeds kernel block shapes (the
    #    port's own registry file, beside the reference's)
    path = Path("artifacts/torch_solutions.json")
    registry.save("quickstart", sol, path)
    bm, bn, bk = registry.kernel_blocks("quickstart", path)
    print(f"tuned GEMM blocks: bm={bm} bn={bn} bk={bk}")

    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal((128, 96)), dtype=torch.float32,
                        device=args.device)
    b = torch.as_tensor(np.random.default_rng(1).standard_normal((96, 64)),
                        dtype=torch.float32, device=args.device)
    out = ops.matmul(a, b, bm=min(bm, 64), bn=min(bn, 64), bk=min(bk, 64),
                     implementation=impl)
    err = float(torch.max(torch.abs(out - ref.gemm_ref(a, b))))
    print(f"tuned {impl} GEMM on {args.device}: max abs err vs the plain "
          f"version {err!r}")


if __name__ == "__main__":
    main()
