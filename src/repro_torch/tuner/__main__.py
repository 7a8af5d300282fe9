"""Command-line entry for the measured-autotuning loop (DESIGN.md §8.4).

Runs the HASCO co-design flow over a workload set and — with ``--measure``
— re-ranks the Pareto frontier by the hand-written CUDA kernels' timings,
fits the per-op calibration, and persists the tuning database the dispatch
layer (``kernels/ops.py``) consults.

  # tune on the card: explore analytically, commit to measured truth
  PYTHONPATH=src python -m repro_torch.tuner --workload gemm:1024,1024,1024 \
      --measure --trials 8 --db artifacts/torch_tuning_db.json

  # CPU smoke (plain versions): one tiny GEMM population, asserts a
  # calibration was fitted
  PYTHONPATH=src python -m repro_torch.tuner --smoke --backend torch

``--backend cuda`` (the default) runs the DQN and the kernels on the card
and raises where there is none; ``--backend torch`` runs both on the CPU.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.core import workloads as W
from repro_torch.core.codesign import Constraints, codesign
from repro_torch.core.tst import TensorExpr
from repro_torch.kernels.ops import DEVICE_OF

from .db import DEFAULT_DB_PATH
from .measure import MeasureOptions


def parse_workload(spec: str) -> TensorExpr:
    """'gemm:M,N,K' | 'gemv:M,K' | 'dot:K' | 'conv:K,C,X,Y[,R,S]'."""
    kind, _, dims = spec.partition(":")
    try:
        v = [int(x) for x in dims.split(",") if x]
    except ValueError:
        raise SystemExit(f"bad --workload spec {spec!r}")
    kind = kind.lower()
    if kind == "gemm" and len(v) == 3:
        return W.gemm(*v)
    if kind == "gemv" and len(v) == 2:
        return W.gemv(*v)
    if kind == "dot" and len(v) == 1:
        return W.dot(*v)
    if kind == "conv" and len(v) in (4, 6):
        return W.conv2d(*v)
    if kind == "ttm" and len(v) == 4:
        return W.ttm(*v)
    raise SystemExit(f"bad --workload spec {spec!r} (want gemm:M,N,K | "
                     f"gemv:M,K | dot:K | conv:K,C,X,Y[,R,S] | ttm:I,J,K,L)")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tuner",
        description="HASCO co-design with measured re-ranking + tuning DB")
    ap.add_argument("--workload", action="append", default=[],
                    help="gemm:M,N,K | gemv:M,K | conv:K,C,X,Y[,R,S]; "
                         "repeatable (one app = one workload set)")
    ap.add_argument("--app", default="default",
                    help="application name keying the solution registry")
    ap.add_argument("--intrinsics", default="GEMM",
                    help="comma-separated intrinsic families to explore")
    ap.add_argument("--target", default="tpu", choices=["tpu", "spatial"])
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--init", type=int, default=3)
    ap.add_argument("--sw-budget", default="small", choices=["small", "full"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--power-w", type=float, default=float("inf"))
    ap.add_argument("--measure", action="store_true",
                    help="re-rank the frontier by real kernel timings")
    ap.add_argument("--backend", default="cuda", choices=["cuda", "torch"],
                    help="cuda: the DQN and the kernels on the card; torch: "
                         "the DQN and the plain kernel versions on the CPU")
    ap.add_argument("--top-k", type=int, default=3,
                    help="feasible Pareto candidates to measure per intrinsic")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--db", type=Path, default=DEFAULT_DB_PATH,
                    help="tuning database path (merge-on-save)")
    ap.add_argument("--solutions", type=Path, default=None,
                    help="also save the full solution (schedules included) "
                         "to this registry path")
    ap.add_argument("--checkpoint-dir", type=Path, default=None,
                    help="checkpoint the co-design round state here after "
                         "every intrinsic (DESIGN.md §14)")
    ap.add_argument("--resume", type=Path, default=None,
                    help="resume from the newest clean checkpoint in this "
                         "directory (a foreign or empty one starts fresh)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny GEMM preset; exit non-zero unless a "
                         "calibrated model is produced (CI gate)")
    args = ap.parse_args(argv)

    if args.smoke:
        args.workload = args.workload or ["gemm:64,64,64"]
        args.measure = True
        args.trials, args.init = min(args.trials, 6), min(args.init, 3)

    workloads = [parse_workload(s) for s in (args.workload
                                             or ["gemm:256,256,128"])]
    opts = MeasureOptions(backend=args.backend, warmup=args.warmup,
                          repeats=args.repeats)
    print(f"app {args.app!r}: {len(workloads)} workload(s), "
          f"intrinsics {args.intrinsics}, target {args.target}, "
          f"measure={'on (' + args.backend + ')' if args.measure else 'off'}")

    report = codesign(
        workloads, intrinsics=args.intrinsics.split(","),
        constraints=Constraints(power_w=args.power_w),
        target=args.target, n_trials=args.trials, n_init=args.init,
        seed=args.seed, sw_budget=args.sw_budget, measure=args.measure,
        measure_backend=args.backend, measure_top_k=args.top_k,
        measure_opts=opts, db_path=args.db if args.measure else None,
        app=args.app, checkpoint_dir=args.checkpoint_dir,
        resume_from=args.resume, device=DEVICE_OF[args.backend])

    if report.solution is None:
        print("no feasible solution under the constraints")
        return 1
    print(f"solution: {report.solution.describe()}")
    for intr, s in (report.measured or {}).items():
        mixed = " [MIXED: total contains analytical stand-ins]" \
            if s.get("best_has_fallbacks") else ""
        quarantined = s.get("quarantined", 0)
        qnote = f", {quarantined} quarantined skipped" if quarantined else ""
        illegal = s.get("illegal", 0)
        inote = f", {illegal} statically illegal skipped" if illegal else ""
        print(f"  {intr}: measured {s['measured']} kernel points over "
              f"{s['candidates']} candidates ({s['fallbacks']} analytical "
              f"fallbacks{qnote}{inote}), best total "
              f"{s['best_measured_total_s'] * 1e3:.3f} ms{mixed}")
    if report.calibration is not None:
        for op, corr in report.calibration.corrections.items():
            print(f"  calibration[{op}]: {corr.kind} "
                  f"from {corr.n_samples} samples")
    if report.db_path is not None:
        print(f"tuning db -> {report.db_path}")

    if args.solutions is not None:
        from repro_torch.core import solution as S
        S.save(args.app, report.solution, args.solutions)
        print(f"solution registry -> {args.solutions}")

    if args.smoke and not (report.calibration
                           and report.calibration.corrections):
        print("SMOKE FAIL: no calibrated model was produced", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
