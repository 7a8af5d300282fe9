#!/usr/bin/env python3
"""On-card smoke of ``repro_torch``, the PyTorch/CUDA port of HASCO, on one
NVIDIA H100 (Hopper, sm_90a).

    python3 chip_smoke.py

Run it from the root of a checkout on a machine with one CUDA device and the
CUDA toolkit; it needs no network.  Phases, each printing its own lines:

  1. the card's name and power limit (``nvidia-smi``), torch and CUDA
     versions; TF32 off for PyTorch's float32 products and convolutions;
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (timed);
  3. each kernel against its plain PyTorch version on the card, at the main
     path's shapes and at ragged shapes with odd blocks, float32 and
     bfloat16, with the tolerances of ``tests/test_kernels.py``; ``dot``
     must give the same bits twice;
  4. the main path: ``python -m repro_torch.tuner ... --measure --backend
     cuda`` for two applications at the paper's sizes into a fresh tuning
     DB, with every kernel's launch count read from that run alone; then a
     tuned ``ops.matmul`` resolves its blocks from the DB;
  5. each kernel timed at the main path's shape and committed blocks beside
     its bound, its plain version and the PyTorch library call.

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises and the script
exits non-zero without that line, as it does where there is no CUDA device
or no checkout around it.
"""
from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
DB_PATH = ROOT / "artifacts" / "chip_smoke" / "torch_tuning_db.json"

# The paper's workload sets at the sizes a user co-designs for (none cut):
# Table I's largest GEMM, a ResNet-50 3x3 layer (K=C=256, 14x14), a
# 4096x4096 GEMV and a 2^24-element DOT.
APPS = [
    ["--app", "gemm_conv", "--intrinsics", "GEMM",
     "--workload", "gemm:1024,1024,1024", "--workload", "conv:256,256,14,14,3,3"],
    ["--app", "gemv_dot", "--intrinsics", "DOT",
     "--workload", "gemv:4096,4096", "--workload", "dot:16777216"],
]
TUNER_FLAGS = ["--measure", "--backend", "cuda", "--trials", "6", "--init", "3",
               "--db", str(DB_PATH)]

# H100 SXM data sheet: 3.35 TB/s HBM3, 67 TFLOP/s float32 without tensor
# cores (every kernel here runs float32 FMA); the PCIe part: 2.0 TB/s, 51.
CARD_RATES = {"sxm": (3.35e12, 67e12), "pcie": (2.0e12, 51e12)}

# (rtol, atol) of tests/test_kernels.py:30-60.  Not widened: the sums here
# are longer (K up to 2^24) but each output's magnitude grows with them, so
# the relative term covers the longer float32 sums.
TOL = {"gemm": {"float32": (1e-5, 1e-4), "bfloat16": (5e-2, 5e-1)},
       "gemv": {"float32": (1e-5, 1e-4), "bfloat16": (5e-2, 5e-1)},
       "dot": {"float32": (1e-5, 1e-3), "bfloat16": (5e-2, 5e-1)},
       "conv2d": {"float32": (1e-4, 2e-3), "bfloat16": (5e-2, 5e-1)}}

KERNEL_META = {
    "gemm": ("src/repro_torch/csrc/gemm.cu", "src/repro/kernels/gemm.py:50"),
    "gemv": ("src/repro_torch/csrc/gemv.cu", "src/repro/kernels/gemv.py:48"),
    "dot": ("src/repro_torch/csrc/dotprod.cu", "src/repro/kernels/dotprod.py:45"),
    "conv2d": ("src/repro_torch/csrc/conv2d.cu",
               "src/repro/kernels/conv2d.py:47"),
}


class SmokeFailure(AssertionError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(title: str) -> None:
    print(f"\n== {title}", flush=True)


def main() -> int:
    require((SRC / "repro_torch" / "csrc").is_dir(),
            f"no checkout around {__file__}: src/repro_torch is missing")
    sys.path.insert(0, str(SRC))
    import torch
    require(torch.cuda.is_available(), "no CUDA device: this smoke runs on the "
            "card only")

    phase("1. card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {name}, "
          f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rates = CARD_RATES["pcie" if "PCIe" in name else "sxm"]

    phase("2. build")
    from repro_torch.kernels import cuda_lib
    _, info = cuda_lib.build()
    cuda_lib.library()
    print(f"built {cuda_lib.SOURCES} in {info['seconds']:.1f} s "
          f"(0.0 = reused)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    phase("3. kernels against their plain versions")
    check_kernels(torch)

    phase("4. main path: measured co-design on the card")
    launches, db = run_main_path(torch)

    phase("5. timings at the main path's shapes and blocks")
    rows = time_kernels(torch, db, launches, rates)
    for r in rows:
        print(f"  {r['name']:7s} {r['ms']:.4f} ms (blocks {r['blocks']}; "
              f"default blocks {r['ms_default_blocks']:.4f} ms)  bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}  plain "
              f"{r['plain_ms']:.4f} ms  library {r['library_ms']:.4f} ms  "
              f"launches {r['launches']}  max_abs_err {r['max_abs_err']:.3g}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def _rand(torch, gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def _close(torch, got, want, rtol, atol) -> float:
    got, want = got.float(), want.float()
    require(got.shape == want.shape, f"shape {tuple(got.shape)} != "
            f"{tuple(want.shape)}")
    require(bool(torch.isfinite(got).all()), "non-finite output")
    err = float((got - want).abs().max())
    ok = bool(((got - want).abs() <= atol + rtol * want.abs()).all())
    require(ok, f"max abs err {err:.3g} beyond rtol {rtol} atol {atol}")
    return err


def check_kernels(torch) -> None:
    from repro_torch.kernels import conv2d, dot, gemm, gemv, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {
        # name: [(shape args, blocks)]; the first is the main path's shape
        "gemm": [((1024, 1024, 1024), dict(bm=256, bn=256, bk=512)),
                 ((1024, 1024, 1024), dict(bm=64, bn=64, bk=1024)),
                 ((17, 129, 65), dict(bm=17, bn=96, bk=17)),
                 ((96, 72, 80), dict(bm=2048, bn=2048, bk=2048)),
                 ((1000, 300, 777), dict(bm=96, bn=17, bk=512))],
        "gemv": [((4096, 4096), dict(bm=512, bk=512)),
                 ((33, 257), dict(bm=17, bk=96)),
                 ((100, 9000), dict(bm=2048, bk=4096)),
                 ((4096, 4096), dict(bm=96, bk=17))],
        "dot": [((1 << 24,), dict(bk=2048)),
                ((1000,), dict(bk=17)),
                ((5000,), dict(bk=100000)),
                ((1 << 24,), dict(bk=96))],
        "conv2d": [((256, 256, 16, 16, 3), dict(bk=128)),
                   ((24, 16, 18, 20, 3), dict(bk=17)),
                   ((8, 4, 9, 9, 1), dict(bk=96)),
                   ((16, 3, 40, 33, 7), dict(bk=5)),
                   ((300, 64, 23, 19, 3), dict(bk=512))],
    }
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).removeprefix("torch.")
        for op, runs in cases.items():
            rtol, atol = TOL[op][dt]
            for shape, blk in runs:
                if op == "gemm":
                    m, n, k = shape
                    a, b = (_rand(torch, gen, m, k, dtype=dtype),
                            _rand(torch, gen, k, n, dtype=dtype))
                    got, want = gemm(a, b, **blk), ref.gemm_ref(a, b)
                elif op == "gemv":
                    m, k = shape
                    a, x = (_rand(torch, gen, m, k, dtype=dtype),
                            _rand(torch, gen, k, dtype=dtype))
                    got, want = gemv(a, x, **blk), ref.gemv_ref(a, x)
                elif op == "dot":
                    a, b = (_rand(torch, gen, *shape, dtype=dtype),
                            _rand(torch, gen, *shape, dtype=dtype))
                    got, want = dot(a, b, **blk), ref.dot_ref(a, b)
                    require(got.shape == (1, 1) and got.dtype == torch.float32,
                            "dot must return (1, 1) float32")
                    require(torch.equal(got, dot(a, b, **blk)),
                            "dot gave different bits on a second run")
                else:
                    kk, c, h, w, r = shape
                    a, wt = (_rand(torch, gen, c, h, w, dtype=dtype),
                             _rand(torch, gen, kk, c, r, r, dtype=dtype))
                    got, want = conv2d(a, wt, **blk), ref.conv2d_ref(a, wt)
                torch.cuda.synchronize()
                require(got.dtype == want.dtype, f"{op} dtype {got.dtype}")
                err = _close(torch, got, want, rtol, atol)
                print(f"  {op:7s} {dt:8s} {str(shape):22s} {blk}: max abs "
                      f"err {err:.3g} (rtol {rtol}, atol {atol}) ok")


def run_main_path(torch):
    from repro_torch.kernels import KERNELS
    from repro_torch.tuner.__main__ import main as tuner_main
    from repro_torch.tuner.db import TuningDB

    if DB_PATH.parent.exists():
        shutil.rmtree(DB_PATH.parent)
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    for app in APPS:
        print("$ python -m repro_torch.tuner " + " ".join(app + TUNER_FLAGS),
              flush=True)
        rc = tuner_main(app + TUNER_FLAGS)
        require(rc == 0, f"tuner exited {rc}")
    launches = {k.__name__: k.launches for k in KERNELS}
    print(f"main path took {time.perf_counter() - t0:.1f} s; launches "
          f"{launches}")
    for name, n in launches.items():
        require(n > 0, f"{name} kernel was not launched by the main path")

    db = TuningDB.load(DB_PATH)
    ops_cuda = {r.op for r in db.records.values() if r.backend == "cuda"}
    require(ops_cuda == {"gemm", "gemv", "dot", "conv2d"},
            f"tuning DB has cuda records for {sorted(ops_cuda)} only")
    require(bool(db.calibration.corrections), "no calibration was fitted")
    for f in db.failures:
        # only the lowering's structural rejection may stand: a kernel that
        # failed to build, launch or time carries a kernel point (its key)
        require(f.get("error_type") == "ValueError" and not f.get("key"),
                f"a measurement failed: {f}")
    print(f"tuning DB: {len(db.records)} cuda records, calibration "
          f"{sorted(db.calibration.corrections)}, {len(db.failures)} "
          f"structural lowering rejections")

    from repro_torch.kernels import ops, ref
    ops.reset_dispatch()
    ops.set_tuning_db(DB_PATH)
    gen = torch.Generator(device="cuda").manual_seed(1)
    a = _rand(torch, gen, 1024, 1024, dtype=torch.float32)
    b = _rand(torch, gen, 1024, 1024, dtype=torch.float32)
    blocks = ops.resolve_blocks("gemm", (1024, 1024, 1024), a.dtype, "cuda",
                                bm=None, bn=None, bk=None)
    rec = db.best_config("gemm", (1024, 1024, 1024), "float32", "cuda")
    require(blocks == rec, f"dispatch resolved {blocks}, the DB holds {rec}")
    err = _close(torch, ops.matmul(a, b, implementation="cuda"),
                 ref.gemm_ref(a, b), *TOL["gemm"]["float32"])
    print(f"tuned ops.matmul 1024^3 with the DB's blocks {blocks}: max abs "
          f"err {err:.3g} ok")
    return launches, db


def _time_ms(torch, fn, budget_ms: float = 100.0) -> float:
    """Mean time of back-to-back calls by CUDA events, after a warm-up call
    that also sizes the run to about ``budget_ms`` (3 to 50 calls)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = max(3, min(50, int(budget_ms / max(start.elapsed_time(end),
                                               1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_kernels(torch, db, launches, rates) -> list[dict]:
    import torch.nn.functional as F

    from repro_torch.kernels import conv2d, dot, gemm, gemv, ops, ref

    bw, peak = rates
    gen = torch.Generator(device="cuda").manual_seed(2)
    f32 = torch.float32
    r = lambda *s: _rand(torch, gen, *s, dtype=f32)
    a, b = r(1024, 1024), r(1024, 1024)
    ga, gx = r(4096, 4096), r(4096)
    da, db_ = r(1 << 24), r(1 << 24)
    ca, cw = r(256, 16, 16), r(256, 256, 3, 3)
    specs = [
        # name, kernel, plain, library, op shape key, inputs, output, flops
        ("gemm", gemm, ref.gemm_ref, torch.matmul, (1024, 1024, 1024),
         (a, b), 1024 * 1024, 2 * 1024 ** 3),
        ("gemv", gemv, ref.gemv_ref, torch.mv, (4096, 4096), (ga, gx), 4096,
         2 * 4096 * 4096),
        ("dot", dot, ref.dot_ref, torch.dot, (1 << 24,), (da, db_), 1,
         2 * (1 << 24)),
        ("conv2d", conv2d, ref.conv2d_ref,
         lambda x, w: F.conv2d(x[None], w)[0], (256, 256, 14, 14, 3, 3),
         (ca, cw), 256 * 14 * 14, 2 * 256 * 256 * 9 * 14 * 14),
    ]
    rows = []
    for name, kern, plain, lib, shape, ins, out_elems, flops in specs:
        blocks = db.best_config(name, shape, "float32", "cuda")
        default = ops.DEFAULT_BLOCKS[name]
        err = _close(torch, kern(*ins, **blocks), plain(*ins),
                     *TOL[name]["float32"])
        nbytes = sum(t.numel() * t.element_size() for t in ins) + out_elems * 4
        t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": KERNEL_META[name][0],
            "replaces": KERNEL_META[name][1], "launches": launches[name],
            "max_abs_err": err,
            "ms": _time_ms(torch, lambda: kern(*ins, **blocks)),
            "plain_ms": _time_ms(torch, lambda: plain(*ins)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": _time_ms(torch, lambda: lib(*ins)),
            "blocks": blocks, "dtype": "float32",
            "ms_default_blocks": _time_ms(torch, lambda: kern(*ins, **default)),
        })
    require(all(math.isfinite(r_["ms"]) for r_ in rows), "a timing failed")
    return rows


if __name__ == "__main__":
    sys.exit(main())
