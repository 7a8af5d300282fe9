#!/usr/bin/env python3
"""On-card smoke of ``repro_torch``, the PyTorch/CUDA port of HASCO, on one
NVIDIA H100 (Hopper, sm_90a).

    python3 chip_smoke.py

Run it from the root of a checkout on a machine with one CUDA device and the
CUDA toolkit; it needs no network.  Phases, each printing its own lines:

  1. the card's name and power limit (``nvidia-smi``), torch and CUDA
     versions; TF32 off for PyTorch's float32 products and convolutions;
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (timed); no
     flash tensor-core (D 80, 128), GEMM/conv tile, mamba2 or rwkv6 kernel
     (nor their shared state pass) spills;
  3. each kernel against its plain PyTorch version on the card, at the main
     path's shapes and at ragged shapes with odd blocks, float32 and
     bfloat16, with the tolerances of ``tests/test_kernels.py``; ``dot``,
     ``gemv``, ``gemm`` and ``conv2d`` must give the same bits twice
     (``gemv`` also at the block that once gave one CTA, and at K not a
     multiple of 8; ``gemm`` and ``conv2d`` at every legal CTA tile, with
     the reduction split, at unaligned operands and at R != S), each gemm
     and conv2d case printing its plan (tile, splits, CTAs); ``dot`` gives
     the same bits at bk 96, 2048 and 131072 at 2^24, on aligned views and
     on views off a 16-byte boundary by equal and by different offsets;
  4. the main path: ``python -m repro_torch.tuner ... --measure --backend
     cuda`` for two applications at the paper's sizes into a fresh tuning
     DB, with every kernel's launch count read from that run alone; the
     distinct measured times of the gemm and conv2d candidates with their
     plans, and whether gemm_conv's commit moved from the one made while a
     CTA owned one whole block; then a tuned ``ops.matmul`` resolves its
     blocks from the DB;
  5. each kernel timed at the main path's shape and committed blocks beside
     its bound, its plain version and the PyTorch library call, called
     back to back from Python and replayed from a CUDA graph (device time
     without the host's launch cost), with the host time a call; gemv also
     in bfloat16; gemm and conv2d with their plans, and timed at one block
     of every legal tile class; dot with its plan (CTAs, span);
  6. the flash attention kernel against its plain version on the card,
     float32 and bfloat16, at the forward's shape and at ragged ones (Sq <
     Skv and Sq > Skv, head dims 80/128/256, GQA, soft-cap, window, strided
     views), printing the route each case took: every bfloat16 case that
     the route rule admits must take the tensor-core route, and a
     misaligned view the SIMT route;
  7. the transformer slice's full-sequence forward: qwen3-8b at full width
     and depth (random weights from a seeded generator, bfloat16) over
     1 x 4096 tokens through ``make_prefill_step``, with the kernel's
     launches counted from that run alone (one per layer, every one on the
     tensor-core route), against the same
     forward on the plain versions (``impl=kernels.plain``); beside it the
     plain forward with other chunk sizes (the model's own sensitivity to
     summation order), and a forward in which every kernel call is checked
     against its plain version on the very same inputs;
  8. serving: ``serve_requests`` on the dense ``ServeEngine`` with the same
     model (4 slots, max_seq 2048, 8 requests of 128-1024 prompt tokens, 16
     new tokens each); every request must end OK, and each request's
     prefill logits (what the engine's first token came from) must agree
     with the kernel forward's at the last prompt position;
  9. the flash kernel timed at qwen3-8b's and zamba2-2.7b's forward shapes
     beside its bound, its plain version, ``scaled_dot_product_attention``
     and its own SIMT route on the same inputs;
 10. the rwkv6 and mamba2 kernels against their plain versions on the
     card, float32 and bfloat16, with and without a state: the forwards'
     shapes, ragged T (1, a chunk -1 and +1, 1000), Dk != Dv and N != P, b/c
     as stride-0 views, strong and weak decay (the carried state dominant),
     and streaming (two chained half calls equal one whole call); mamba2
     with b/c as stride-0 views (the Gram made once a chunk for every head)
     gives the same bits as with b/c copied per head; each rwkv6 case also
     prints the kernel's and the plain version's max error against the
     plain version run in float64, and in bfloat16 each one's share of
     outputs rounded otherwise than the float64 result rounded once, beside
     the plain version's own share at chunk 16 against 32 (read, no limit);
 11. rwkv6-3b's full-sequence forward at full width and depth over 1 x 4096
     tokens (one rwkv6 launch per layer, counted from that run alone), with
     phase 7's comparisons, the kernel forward against the plain forward at
     the kernel's own chunk of 16 (read, no limit), and the same two
     forwards on the weights cast to float32;
 12. rwkv6-3b served as in phase 8: every prefill launches the kernel once
     per layer, each request's prefill logits agree with the kernel
     forward's, and one prompt prefilled in two halves (the state carried
     through ``decode_step``) agrees with it prefilled whole;
 13. zamba2-2.7b's forward as in phase 11 (one mamba2 launch per Mamba
     layer, one flash_attention launch per shared-block call, on the
     tensor-core route);
 14. zamba2-2.7b served as in phase 12;
 15. rwkv6 and mamba2 timed at the forwards' shapes beside their bounds and
     plain versions (no single PyTorch call computes either), back to back
     and replayed from a CUDA graph; each with its plan, its device time
     by kernel (torch.profiler: span states, state passing, outputs), and
     the bytes of its span states with the floor they would set at the HBM
     rate (derived, not measured).

Each model is freed before the next one is drawn.

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
from functools import partial
from pathlib import Path
from types import SimpleNamespace

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
# dense bfloat16 tensor-core peak (data sheet, no sparsity): the least time
# for bfloat16 work, whatever unit a kernel uses
BF16_PEAK = {"sxm": 989e12, "pcie": 756e12}

# (rtol, atol) of tests/test_kernels.py:30-60.  Not widened: the sums here
# are longer (K up to 2^24) but each output's magnitude grows with them, so
# the relative term covers the longer float32 sums.
TOL = {"gemm": {"float32": (1e-5, 1e-4), "bfloat16": (5e-2, 5e-1)},
       "gemv": {"float32": (1e-5, 1e-4), "bfloat16": (5e-2, 5e-1)},
       "dot": {"float32": (1e-5, 1e-3), "bfloat16": (5e-2, 5e-1)},
       "conv2d": {"float32": (1e-4, 2e-3), "bfloat16": (5e-2, 5e-1)}}

# every CTA tile the gemm and conv2d kernels are compiled for
# (kernels/gemm.py TILE_SIDES x TILE_SIDES x STAGE_DEPTHS; conv2d's
# TILE_CHANNELS)
GEMM_TILES = [(tm, tn, tk) for tm in (32, 64) for tn in (32, 64)
              for tk in (8, 16, 32)]
CONV_TILES = (32, 64, 128)
# the blocks the measured flow committed for gemm_conv while a CTA owned one
# whole block (its phase 4 on the H100): the commit this run is compared with
EARLIER_COMMIT = {"gemm": {"bm": 256, "bn": 256, "bk": 128},
                  "conv2d": {"bk": 64}}

KERNEL_META = {
    "gemm": ("src/repro_torch/csrc/gemm.cu", "src/repro/kernels/gemm.py:50"),
    "gemv": ("src/repro_torch/csrc/gemv.cu", "src/repro/kernels/gemv.py:48"),
    "dot": ("src/repro_torch/csrc/dotprod.cu", "src/repro/kernels/dotprod.py:45"),
    "conv2d": ("src/repro_torch/csrc/conv2d.cu",
               "src/repro/kernels/conv2d.py:47"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:108"),
}

# flash attention (rtol, atol): float32 is tests/test_kernels.py:78's (the
# SIMT route, float32 FMA).  bfloat16 takes the tensor-core route: its
# products of bfloat16 values are exact in float32 and P is rounded to two
# bfloat16 terms (P_hi + P_lo, ~16 bits), so it is as close to float32 as
# the plain version is; both round the output once, so they may differ by
# one bfloat16 ulp, at most 2^-7 of the value: rtol 1e-2 covers it, and
# atol only has to cover outputs near 0 (P in one bfloat16 term would move
# near-cancelling outputs past it).
FLASH_TOL = {"float32": (1e-3, 1e-3), "bfloat16": (1e-2, 1e-3)}
# q is drawn with this std and k, v with 1, so the scaled scores have std 3
# whatever D is: each row's softmax puts most of its weight on a few keys
# and the outputs are O(1), so a dropped or misweighted key tile moves them
# by far more than the tolerance (near-uniform scores would average v to
# ~1/sqrt(Skv) and hide such a fault under atol)
FLASH_Q_STD = 3.0

# the model slices: qwen3-8b, rwkv6-3b and zamba2-2.7b over 4096 tokens;
# serving 8 requests each
ARCHS = ("qwen3-8b", "rwkv6-3b", "zamba2-2.7b")
FWD_TOKENS = 4096
SERVE = dict(slots=4, max_seq=2048, n=8, prompt=(128, 1024), max_new=16)
# Correctness limits per model, each set just below its first reading on an
# H100 SXM at 700 W (PERF.md section 2 states both):
#   forward: the kernel forward against the plain-version forward, both
#     bfloat16: least cosine over positions and the share of positions
#     whose argmax agrees (bfloat16 logits tie often, so not 1);
#   forward_f32: the same two forwards on the weights cast to float32,
#     least cosine.  The random-weight recurrent models amplify a one-ulp
#     bfloat16 difference in a layer's output across their depth (a chunk
#     of 16 against one of 32 in the plain version alone moves a reduced
#     32-layer rwkv6 to cosine 0.989 on the CPU), so their bfloat16 reading
#     is low and the float32 one carries the check;
#   prefill: each served request's prefill logits against the kernel
#     forward's at its last prompt position, least cosine;
#   halves: a recurrent prompt prefilled in two halves (the state carried
#     through decode_step) against prefilled whole, cosine.
LIMITS = {
    "qwen3-8b": dict(forward=(0.999, 0.9), prefill=0.999),
    "rwkv6-3b": dict(forward=(0.45, 0.6), forward_f32=0.98, prefill=0.999,
                     halves=0.98),
    "zamba2-2.7b": dict(forward=(0.99, 0.85), forward_f32=0.99999,
                        prefill=0.998, halves=0.998),
}

# rwkv6 / mamba2 (rtol, atol) against their plain chunked versions:
# float32 1e-4 (the same float32 math summed in other orders and chunks);
# bfloat16 outputs one bf16 ulp (both round a float32 result once), with
# atol for outputs near 0; the float32 final states at 1e-4 in both
LIN_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-3)}
STATE_TOL = (1e-4, 1e-4)
LIN_META = {
    "rwkv6": ("src/repro_torch/csrc/rwkv6.cu", "src/repro/kernels/rwkv6.py:95"),
    "mamba2": ("src/repro_torch/csrc/mamba2.cu",
               "src/repro/kernels/mamba2.py:85"),
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
    report = _ptxas_report(info["log"])
    for line in report:
        print("  " + line)
    # the tensor-core flash kernel at the models' head dims 80 and 128
    # keeps everything in registers
    for d in (80, 128):
        line = next((ln for ln in report
                     if ln.startswith(f"flash_tc_kernel<{d},")), None)
        require(line is not None or not info["log"],
                f"no ptxas report for flash_tc_kernel<{d}>")
        require(line is None or line.endswith(" 0 bytes spilled"),
                f"the D {d} tensor-core kernel spills: {line}")

    # the gemm and conv2d tiles: no spills at any tile
    tiles = [ln for ln in report if ln.startswith(("tile_mm_kernel",
                                                   "split_sum_kernel"))]
    require(bool(tiles) or not info["log"], "no ptxas report for the tiles")
    for line in tiles:
        require(line.endswith(" 0 bytes spilled"), f"a tile spills: {line}")
    # the chunk-parallel mamba2 and rwkv6 kernels and their shared state
    # pass: no spills in any pass or route
    for prefix in ("mamba2_", "rwkv6_", "state_pass_"):
        lines = [ln for ln in report if ln.startswith(prefix)]
        require(bool(lines) or not info["log"],
                f"no ptxas report for {prefix}*")
        for line in lines:
            require(line.endswith(" 0 bytes spilled"),
                    f"a {prefix}* kernel spills: {line}")

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
              f"launches {r['launches']}  max_abs_err {r['max_abs_err']:.3g}"
              f"; replayed from a CUDA graph: {r['ms_graph']:.4f} ms, library "
              f"{r['library_ms_graph']:.4f} ms; host time a call "
              f"{r['host_ms']:.4f} ms, library {r['library_host_ms']:.4f} ms")
    for r in rows:
        if "tiles" not in r:
            continue
        print(f"  {r['name']} plan at the committed blocks {r['plan']}, at "
              f"the default blocks {r['plan_default_blocks']}; replayed from a "
              f"CUDA graph at the default blocks "
              f"{r['ms_graph_default_blocks']:.4f} ms; max abs err against "
              f"float64 {r['max_abs_err_f64']:.3g} (plain "
              f"{r['plain_max_abs_err_f64']:.3g})")
        for t in r["tiles"]:
            print(f"    tile {t['tile']} ({t['splits']} splits, {t['ctas']} "
                  f"CTAs; blocks {t['blocks']}): {t['ms']:.4f} ms, replayed "
                  f"{t['ms_graph']:.4f} ms")
    dot_row = next(r for r in rows if r["name"] == "dot")
    print(f"  dot plan at the committed blocks {dot_row['plan']}, at the "
          f"default blocks {dot_row['plan_default_blocks']}; replayed from a "
          f"CUDA graph at the default blocks "
          f"{dot_row['ms_graph_default_blocks']:.4f} ms")
    gemv_row = next(r for r in rows if r["name"] == "gemv")
    print(f"  gemv    bfloat16 replayed from a CUDA graph: "
          f"{gemv_row['bf16_ms_graph']:.4f} ms, torch.mv "
          f"{gemv_row['bf16_library_ms_graph']:.4f} ms")

    phase("6. flash attention against its plain version")
    check_flash(torch)

    bf16_peak = BF16_PEAK["pcie" if "PCIe" in name else "sxm"]
    fwd_launches, attn_launches = {}, {}
    for first, arch in zip((7, 11, 13), ARCHS):
        if arch == "rwkv6-3b":
            phase("10. rwkv6 and mamba2 against their plain versions")
            check_recurrences(torch)
        phase(f"{first}. full-sequence forward: {arch} at full width and "
              f"depth")
        model = run_forward(torch, arch)
        fwd_launches.update({k: v for k, v in model["launches"].items()
                             if v})
        phase(f"{first + 1}. serving: the dense ServeEngine on {arch}")
        run_serving(torch, model)
        attn_launches[arch] = model["launches"]["flash_attention"]
        if arch == "qwen3-8b":
            phase("9. flash attention timed at the forwards' shapes")
            flash_rows = {}
            for name_, shape in FLASH_SHAPES.items():
                row = time_flash(torch, shape, attn_launches.get(name_),
                                 rates, bf16_peak)
                print(f"  flash_attention at {name_}'s shape {row['shape']}:"
                      f" {row['ms']:.4f} ms (tensor-core route; SIMT route "
                      f"{row['simt_ms']:.4f} ms)  bound {row['bound_ms']:.4f}"
                      f" ms by {row['bound_by']}  plain {row['plain_ms']:.4f}"
                      f" ms  SDPA {row['library_ms']:.4f} ms  max_abs_err "
                      f"{row['max_abs_err']:.3g}")
                flash_rows[name_] = row
            # one row for the kernel: qwen3-8b's shape, zamba2-2.7b's
            # within it (its launches filled in by phase 13)
            row = flash_rows["qwen3-8b"]
            row["zamba2_shape"] = {
                k_: flash_rows["zamba2-2.7b"][k_] for k_ in (
                    "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "simt_ms", "shape")}
            rows.append(row)
        del model
        torch.cuda.empty_cache()

    phase("15. rwkv6 and mamba2 timed at the forwards' shapes")
    rec_rows, span_floor = time_recurrences(torch, fwd_launches, rates,
                                            bf16_peak)
    for row in rec_rows:
        print(f"  {row['name']} {row['ms']:.4f} ms (replayed from a CUDA "
              f"graph {row['ms_graph']:.4f} ms)  bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']}  plain "
              f"{row['plain_ms']:.4f} ms  library none ({row['library']})  "
              f"launches {row['launches']}  max_abs_err "
              f"{row['max_abs_err']:.3g}")
        # derived, not measured: the span states' traffic at the HBM rate,
        # though they fit in L2 at this shape
        floor = span_floor[row["name"]]
        print(f"  {row['name']} plan {row['plan']}: span states "
              f"{floor['intermediate_bytes'] / 1e6:.1f} MB of traffic, a "
              f"derived floor of {floor['floor_ms']:.4f} ms at the HBM rate")
        passes = row["passes_ms"] or "not measured (no device time)"
        print(f"    device time a call by kernel (torch.profiler): {passes}")
        rows.append(row)
    flash_row = next(r_ for r_ in rows if r_["name"] == "flash_attention")
    flash_row["zamba2_shape"]["launches"] = attn_launches["zamba2-2.7b"]
    require(len(rows) == 7, f"{len(rows)} kernel rows, not 7")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def _ptxas_report(log: str) -> list[str]:
    """One line per compiled kernel from nvcc's ``-Xptxas -v`` log: its
    name with its template arguments (``flash_tc_kernel<128, 0>``, float
    as f32 and bfloat16 as bf16), registers and spilled bytes."""
    import re
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            # the name is <length><identifier> in the mangling: take the
            # last identifier ending in "kernel" whose length prefix fits it
            # (an anonymous namespace's tag, a hash of the source's path,
            # comes first and can happen to fit one too)
            base = max(((i, ident) for i in range(len(mangled))
                        for d in [re.match(r"\d+", mangled[i:])] if d
                        for ident in [mangled[i + d.end():
                                              i + d.end() + int(d.group())]]
                        if ident.endswith("kernel")
                        and re.fullmatch(r"[A-Za-z_]\w*", ident)),
                       default=(0, mangled))[1]
            args = re.findall(
                r"Li(\d+)E|Lb([01])E|(13__nv_bfloat16)|(?<=I)(f)(?=[EL])",
                mangled)
            args = [a or b or ("bf16" if c else "f32" if d else "")
                    for a, b, c, d in args]
            name = base + (
                f"<{', '.join(args)}>" if args else "")
            # the shared GEMM/CONV2D tile: which kernel's B stager it runs
            for stager, op in (("DenseB", "gemm"), ("ConvB", "conv2d")):
                if stager in mangled:
                    name += f" ({op})"
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill and name:
            stores = spill.group(1)
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            out.append(f"{name}: {regs.group(1)} registers, {stores} bytes "
                       f"spilled")
            name = None
    return out


def _rand(torch, gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device=gen.device).to(dtype)


def _close(torch, got, want, rtol, atol) -> float:
    got, want = got.float(), want.float()
    require(got.shape == want.shape, f"shape {tuple(got.shape)} != "
            f"{tuple(want.shape)}")
    require(bool(torch.isfinite(got).all()), "non-finite output")
    err = float((got - want).abs().max())
    ok = bool(((got - want).abs() <= atol + rtol * want.abs()).all())
    require(ok, f"max abs err {err:.3g} beyond rtol {rtol} atol {atol}")
    return err


def _plan(op, shape, blk, dtype):
    """The geometry a gemm or conv2d call of ``shape`` (as phase 3 and 5
    write it) and blocks ``blk`` runs on this card, else None."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.conv2d import plan as conv_plan
    from repro_torch.kernels.gemm import plan as gemm_plan
    n_sm, size = cuda_lib.sm_count(0), dtype.itemsize
    if op == "gemm":
        m, n, k = shape[:3]
        return gemm_plan(m, n, k, size, n_sm, blk["bm"], blk["bn"], blk["bk"])
    if op == "conv2d":
        kk, c, h, w, r, s = shape
        return conv_plan(kk, c, h - r + 1, w - s + 1, r, s, size, n_sm,
                         blk["bk"])
    return None


def _plan_note(op, shape, blk, dtype) -> str:
    p = _plan(op, shape, blk, dtype)
    return "" if p is None else (f" -> tile {p.tile}, {p.splits} splits, "
                                 f"{p.ctas} CTAs")


def check_kernels(torch) -> None:
    from repro_torch.kernels import conv2d, dot, gemm, gemv, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {
        # name: [(shape args, blocks)]; the first is the main path's shape
        # gemm (M, N, K) or (M, N, K, offset): A and B as views `offset`
        # elements into one buffer, so neither starts 16-byte aligned
        "gemm": [((1024, 1024, 1024), dict(bm=256, bn=256, bk=512)),
                 ((1024, 1024, 1024), dict(bm=64, bn=64, bk=1024)),
                 ((17, 129, 65), dict(bm=17, bn=96, bk=17)),
                 ((96, 72, 80), dict(bm=2048, bn=2048, bk=2048)),
                 ((1000, 300, 777), dict(bm=96, bn=17, bk=512)),
                 ((64, 64, 20000), dict(bm=64, bn=64, bk=32)),   # split K
                 ((300, 200, 1024, 3), dict(bm=64, bn=64, bk=32)),
                 ((130, 257, 65, 1), dict(bm=64, bn=32, bk=16))]
        # one case for each legal tile, ragged against it, K split
        + [((200, 130, 1000), dict(bm=tm, bn=tn, bk=tk)) for tm, tn, tk in
           GEMM_TILES],
        "gemv": [((4096, 4096), dict(bm=512, bk=512)),
                 ((4096, 4096), dict(bm=4096, bk=4096)),   # once one CTA
                 ((33, 257), dict(bm=17, bk=96)),
                 ((100, 9000), dict(bm=2048, bk=4096)),    # split K
                 ((4096, 4096), dict(bm=96, bk=17)),
                 ((1000, 4099), dict(bm=512, bk=512))],    # rows unaligned
        "dot": [((1 << 24,), dict(bk=2048)),
                ((1000,), dict(bk=17)),
                ((5000,), dict(bk=100000)),
                ((1 << 24,), dict(bk=96))],
        # conv2d (K, C, H, W, R, S)
        "conv2d": [((256, 256, 16, 16, 3, 3), dict(bk=128)),
                   ((256, 256, 16, 16, 3, 3), dict(bk=64)),
                   ((24, 16, 18, 20, 3, 3), dict(bk=17)),
                   ((8, 4, 9, 9, 1, 1), dict(bk=96)),
                   ((16, 3, 40, 33, 7, 7), dict(bk=5)),
                   ((300, 64, 23, 19, 3, 3), dict(bk=512)),
                   ((24, 16, 11, 13, 3, 2), dict(bk=17)),        # R != S
                   ((40, 17, 9, 20, 1, 4), dict(bk=96))]
        + [((130, 20, 18, 17, 3, 3), dict(bk=tm)) for tm in CONV_TILES],
    }
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).removeprefix("torch.")
        for op, runs in cases.items():
            rtol, atol = TOL[op][dt]
            for shape, blk in runs:
                if op == "gemm":
                    m, n, k, off = (*shape, 0)[:4]
                    buf = _rand(torch, gen, m * k + k * n + off, dtype=dtype)
                    a = buf[off:off + m * k].view(m, k)
                    b = buf[off + m * k:].view(k, n)
                    got, want = gemm(a, b, **blk), ref.gemm_ref(a, b)
                    require(torch.equal(got, gemm(a, b, **blk)),
                            "gemm gave different bits on a second run")
                elif op == "gemv":
                    m, k = shape
                    a, x = (_rand(torch, gen, m, k, dtype=dtype),
                            _rand(torch, gen, k, dtype=dtype))
                    got, want = gemv(a, x, **blk), ref.gemv_ref(a, x)
                    require(torch.equal(got, gemv(a, x, **blk)),
                            "gemv gave different bits on a second run")
                elif op == "dot":
                    a, b = (_rand(torch, gen, *shape, dtype=dtype),
                            _rand(torch, gen, *shape, dtype=dtype))
                    got, want = dot(a, b, **blk), ref.dot_ref(a, b)
                    require(got.shape == (1, 1) and got.dtype == torch.float32,
                            "dot must return (1, 1) float32")
                    require(torch.equal(got, dot(a, b, **blk)),
                            "dot gave different bits on a second run")
                else:
                    kk, c, h, w, r, s_ = shape
                    a, wt = (_rand(torch, gen, c, h, w, dtype=dtype),
                             _rand(torch, gen, kk, c, r, s_, dtype=dtype))
                    got, want = conv2d(a, wt, **blk), ref.conv2d_ref(a, wt)
                    require(torch.equal(got, conv2d(a, wt, **blk)),
                            "conv2d gave different bits on a second run")
                torch.cuda.synchronize()
                require(got.dtype == want.dtype, f"{op} dtype {got.dtype}")
                err = _close(torch, got, want, rtol, atol)
                print(f"  {op:7s} {dt:8s} {str(shape):22s} {blk}"
                      f"{_plan_note(op, shape, blk, dtype)}: max abs err "
                      f"{err:.3g} (rtol {rtol}, atol {atol}) ok")
        # dot: the plan ignores bk, so every block gives the same bits; views
        # that start off a 16-byte boundary, by equal and by different offsets
        rtol, atol = TOL["dot"][dt]
        k = 1 << 24
        buf = _rand(torch, gen, 2 * k + 16, dtype=dtype)
        for oa, ob in ((0, 0), (3, 3), (1, 2)):
            a, b = buf[oa:oa + k], buf[k + 8 + ob:2 * k + 8 + ob]
            got = [dot(a, b, bk=bk) for bk in (96, 2048, 131072)]
            require(all(torch.equal(g, got[0]) for g in got[1:]),
                    f"dot bits differ across bk at offsets {(oa, ob)}")
            err = _close(torch, got[0], ref.dot_ref(a, b), rtol, atol)
            print(f"  dot     {dt:8s} 2^24 at element offsets {(oa, ob)}: the "
                  f"same bits at bk 96, 2048, 131072; max abs err {err:.3g} ok")


def run_main_path(torch):
    from repro_torch.kernels import INTRINSICS, KERNELS
    from repro_torch.tuner.__main__ import main as tuner_main
    from repro_torch.tuner.db import TuningDB

    from repro_torch.tuner import measure

    if DB_PATH.parent.exists():
        shutil.rmtree(DB_PATH.parent)
    # every candidate's measurement, as the co-design flow takes it
    measured, measure_one = [], measure.measure_one

    def spy(*args, **kwargs):
        res = measure_one(*args, **kwargs)
        measured.append(res)
        return res

    measure.measure_one = spy
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    try:
        for app in APPS:
            print("$ python -m repro_torch.tuner " + " ".join(
                app + TUNER_FLAGS), flush=True)
            rc = tuner_main(app + TUNER_FLAGS)
            require(rc == 0, f"tuner exited {rc}")
    finally:
        measure.measure_one = measure_one
    launches = {k.__name__: k.launches for k in INTRINSICS}
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
    _print_candidates(torch, measured, db)

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


def _print_candidates(torch, measured, db) -> None:
    """The distinct measured times of the gemm and conv2d candidates, each
    with its plan, and whether gemm_conv's commit moved from the one made
    while a CTA owned one whole block."""
    for op in ("gemm", "conv2d"):
        times = {}
        for r in measured:
            if r.ok and r.point.op == op:
                times.setdefault(r.point.blocks, r.latency_s)
        print(f"  {op} candidates: {len(times)} distinct blocks, "
              f"{len(set(times.values()))} distinct measured times")
        for blocks, t in sorted(times.items(), key=lambda kv: kv[1]):
            pt = next(r.point for r in measured if r.ok
                      and r.point.blocks == blocks and r.point.op == op)
            p = _plan(op, _shape_of(op, pt.shape), dict(blocks),
                      torch.float32)
            print(f"    {dict(blocks)} -> tile {p.tile}, {p.splits} splits, "
                  f"{p.ctas} CTAs: {t * 1e3:.4f} ms")
    committed = {op: db.best_config(op, shape, "float32", "cuda") for op, shape
                 in (("gemm", (1024, 1024, 1024)),
                     ("conv2d", (256, 256, 14, 14, 3, 3)))}
    hw = db.apps.get("gemm_conv", {}).get("hw", {})
    moved = "unchanged from" if committed == EARLIER_COMMIT else "changed from"
    print(f"  gemm_conv committed pe {hw.get('pe_rows')}x{hw.get('pe_cols')}"
          f"x{hw.get('pe_depth')}, blocks {committed}; {moved} the earlier "
          f"design's {EARLIER_COMMIT}")


def _shape_of(op, key):
    """A tuning-DB shape key as phase 3 writes the shape: conv2d's (K, C,
    X, Y, R, S) as (K, C, H, W, R, S)."""
    if op == "conv2d":
        k, c, x, y, r, s = key
        return (k, c, x + r - 1, y + s - 1, r, s)
    return key


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


def _time_graph_ms(torch, fn, calls: int = 20) -> float:
    """Device time a call: ``calls`` calls captured in one CUDA graph and
    replayed, so the host's cost of each launch (the Python wrapper,
    ctypes) drops out.  A call that takes less device time than its host
    launch reads as the host time under ``_time_ms``; here it reads as its
    own."""
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                       # warm-up on the side stream before capture
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return _time_ms(torch, graph.replay) / calls


def _host_ms(torch, fn, calls: int = 50) -> float:
    """Host time a call: ``calls`` calls enqueued without waiting for the
    device (the wrapper's checks, allocation and launch)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e3


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
            "ms_graph": _time_graph_ms(torch, lambda: kern(*ins, **blocks)),
            "ms_graph_default_blocks": _time_graph_ms(
                torch, lambda: kern(*ins, **default)),
            "library_ms_graph": _time_graph_ms(torch, lambda: lib(*ins)),
            "host_ms": _host_ms(torch, lambda: kern(*ins, **blocks)),
            "library_host_ms": _host_ms(torch, lambda: lib(*ins)),
        })
    # gemm and conv2d: the plan at the committed and the default block, and
    # the time at one block of each legal tile class (the spread the
    # measured flow can see)
    for r_ in rows:
        name = r_["name"]
        if name not in ("gemm", "conv2d"):
            continue
        kern, ins = (gemm, (a, b)) if name == "gemm" else (conv2d, (ca, cw))
        shape = (1024, 1024, 1024) if name == "gemm" else \
            (256, 256, 16, 16, 3, 3)
        for key, blk in (("plan", r_["blocks"]),
                         ("plan_default_blocks", ops.DEFAULT_BLOCKS[name])):
            p = _plan(name, shape, blk, f32)
            r_[key] = {"tile": p.tile, "splits": p.splits, "ctas": p.ctas}
        # the kernel's and the plain version's distance from a float64
        # result: a split re-associates the float32 sums
        exact = (a.double() @ b.double() if name == "gemm" else
                 F.conv2d(ca[None].double(), cw.double())[0])
        plain = ref.gemm_ref if name == "gemm" else ref.conv2d_ref
        r_["max_abs_err_f64"] = float(
            (kern(*ins, **r_["blocks"]).double() - exact).abs().max())
        r_["plain_max_abs_err_f64"] = float(
            (plain(*ins).double() - exact).abs().max())
        r_["tiles"] = []
        for blk in ([dict(bm=tm, bn=tn, bk=tk) for tm, tn, tk in GEMM_TILES]
                    if name == "gemm" else
                    [dict(bk=tm) for tm in CONV_TILES]):
            p = _plan(name, shape, blk, f32)
            _close(torch, kern(*ins, **blk), ref.gemm_ref(*ins) if name ==
                   "gemm" else ref.conv2d_ref(*ins), *TOL[name]["float32"])
            r_["tiles"].append({
                "blocks": blk, "tile": p.tile, "splits": p.splits,
                "ctas": p.ctas,
                "ms": _time_ms(torch, lambda: kern(*ins, **blk)),
                "ms_graph": _time_graph_ms(torch, lambda: kern(*ins, **blk))})
    # gemv in bfloat16 (half the bytes), replayed from a graph
    gb, gxb = ga.bfloat16(), gx.bfloat16()
    _close(torch, gemv(gb, gxb), ref.gemv_ref(gb, gxb), *TOL["gemv"]["bfloat16"])
    gemv_row = next(r_ for r_ in rows if r_["name"] == "gemv")
    gemv_row["bf16_ms_graph"] = _time_graph_ms(torch, lambda: gemv(gb, gxb))
    gemv_row["bf16_library_ms_graph"] = _time_graph_ms(
        torch, lambda: torch.mv(gb, gxb))
    # dot: the geometry at the committed and the default bk (the same)
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.dotprod import plan as dot_plan
    dot_row = next(r_ for r_ in rows if r_["name"] == "dot")
    for key, blk in (("plan", dot_row["blocks"]),
                     ("plan_default_blocks", ops.DEFAULT_BLOCKS["dot"])):
        p = dot_plan(1 << 24, 4, cuda_lib.sm_count(0), blk["bk"])
        dot_row[key] = {"block": p.block, "ctas": p.ctas, "span": p.span}
    require(all(math.isfinite(r_["ms"]) for r_ in rows), "a timing failed")
    return rows


# -- the model slices: transformer, rwkv6, zamba2 -----------------------------

def _flash_route(torch, fn):
    """-> (fn's result, the one route its flash_attention launch took)."""
    from repro_torch.kernels import flash_attention
    before = dict(flash_attention.route_launches)
    out = fn()
    torch.cuda.synchronize()
    took = [r for r, n in flash_attention.route_launches.items()
            if n != before[r]]
    require(len(took) == 1 and flash_attention.route_launches[took[0]]
            == before[took[0]] + 1, f"one call launched {took}")
    return out, took[0]


def check_flash(torch) -> None:
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import route
    from repro_torch.kernels.xla_attention import attention as plain

    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [
        # (B, Sq, Skv, H, Hkv, D, options); the first is the forward's shape
        (1, FWD_TOKENS, FWD_TOKENS, 32, 8, 128, {}),
        (2, 40, 56, 4, 2, 32, {}),
        (2, 40, 56, 4, 2, 32, dict(softcap=20.0)),
        (2, 40, 56, 4, 2, 32, dict(window=8)),
        (2, 40, 56, 4, 2, 32, dict(causal=False)),
        (2, 40, 56, 4, 2, 32, dict(softcap=30.0, window=16)),
        (1, 300, 300, 16, 16, 80, dict(causal=False)),           # hubert
        (1, 1000, 1000, 16, 4, 80, {}),                           # zamba2
        (2, 200, 333, 8, 4, 256, dict(softcap=50.0, window=64)),  # gemma2
        (1, 600, 600, 8, 2, 256, {}),
        (3, 1, 777, 32, 8, 128, {}),                              # one query
        (1, 130, 1000, 8, 1, 128, dict(window=100)),
        (1, 70, 30, 4, 2, 64, {}),            # Sq > Skv: rows with no key
    ]
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).removeprefix("torch.")
        rtol, atol = FLASH_TOL[dt]
        for b, sq, skv, h, hkv, d, kw in cases:
            q = (_rand(torch, gen, b, sq, h, d, dtype=torch.float32)
                 * FLASH_Q_STD).to(dtype)
            k = _rand(torch, gen, b, skv, hkv, d, dtype=dtype)
            v = _rand(torch, gen, b, skv, hkv, d, dtype=dtype)
            got, took = _flash_route(
                torch, lambda: flash_attention(q, k, v, **kw))
            want_route = "tc" if dtype == torch.bfloat16 else "simt"
            require(took == want_route == route(q, k, v),
                    f"a {dt} call of D {d} took the {took} route")
            require(got.dtype == dtype, f"flash dtype {got.dtype}")
            err = _close(torch, got, plain(q, k, v, **kw), rtol, atol)
            if kw.get("causal", True) and sq > skv:
                require(bool((got[:, :sq - skv] == 0).all()),
                        "a row with no visible key is not zero")
            print(f"  flash {dt:8s} {took:4s} B{b} Sq{sq} Skv{skv} H{h}/{hkv} "
                  f"D{d} {kw}: max abs err {err:.3g} (rtol {rtol}, atol "
                  f"{atol}) ok")
        # q, k and v as strided views of one packed projection: read in
        # place through their strides
        packed = _rand(torch, gen, 2, 96, 8 + 2 * 2, 64, dtype=dtype)
        packed[:, :, :8] *= FLASH_Q_STD
        q, k, v = packed[:, :, :8], packed[:, :, 8:10], packed[:, :, 10:]
        require(not q.is_contiguous(), "the view case lost its strides")
        got, took = _flash_route(
            torch, lambda: flash_attention(q, k, v, window=24))
        require(took == ("tc" if dtype == torch.bfloat16 else "simt"),
                f"strided {dt} views took the {took} route")
        err = _close(torch, got, plain(q, k, v, window=24), rtol, atol)
        print(f"  flash {dt:8s} {took:4s} strided views of a packed qkv: max "
              f"abs err {err:.3g} ok")
        # a head stride of 68 elements: rows not 16-byte aligned, so the
        # SIMT route, on the same semantics
        packed = _rand(torch, gen, 2, 96, 8 + 2 * 2, 68, dtype=dtype)
        packed[:, :, :8] *= FLASH_Q_STD
        q, k, v = (packed[:, :, :8, :64], packed[:, :, 8:10, :64],
                   packed[:, :, 10:, :64])
        got, took = _flash_route(torch, lambda: flash_attention(q, k, v))
        require(took == "simt", f"a misaligned view took the {took} route")
        err = _close(torch, got, plain(q, k, v), rtol, atol)
        print(f"  flash {dt:8s} {took:4s} views with a head stride of 68: max "
              f"abs err {err:.3g} ok")


def _compare_logits(torch, got, want) -> dict:
    """Kernel-path logits against plain-path logits (..., V): max abs
    error, the least cosine similarity over positions (and where it falls),
    and the share of positions whose argmax agrees."""
    import torch.nn.functional as F
    got, want = got.float(), want.float()
    require(got.shape == want.shape, f"logits {tuple(got.shape)} != "
            f"{tuple(want.shape)}")
    require(bool(torch.isfinite(got).all()), "non-finite logits")
    cos = F.cosine_similarity(got, want, dim=-1).flatten()
    return {"max_abs_err": float((got - want).abs().max()),
            "max_abs_logit": float(want.abs().max()),
            "min_cosine": float(cos.min()),
            "worst_position": int(cos.argmin()),
            "argmax_agree": float((got.argmax(-1) == want.argmax(-1))
                                  .float().mean())}


def _launches(cfg, run: str) -> dict:
    """The launches of every kernel that one full-sequence forward
    (``run='forward'``) or one serving prefill (``'prefill'``) of ``cfg``
    must make: the recurrences once per layer in both; attention once per
    layer (per shared-block call) in the forward only, since a prefill's
    attention runs the decode path's plain einsums."""
    from repro_torch.kernels import KERNELS
    want = {k.__name__: 0 for k in KERNELS}
    if cfg.family == "rwkv6":
        want["rwkv6"] = cfg.n_layers
    elif cfg.family == "zamba2":
        want["mamba2"] = cfg.n_layers
        if run == "forward":
            want["flash_attention"] = cfg.n_layers // cfg.attn_every
    elif run == "forward":
        want["flash_attention"] = cfg.n_layers
    return want


def _read_launches(reset: bool = False) -> dict:
    from repro_torch.kernels import KERNELS, flash_attention
    if reset:
        for k in KERNELS:
            k.launches = 0
        flash_attention.route_launches = dict.fromkeys(
            flash_attention.route_launches, 0)
    return {k.__name__: k.launches for k in KERNELS}


class _CheckedOps:
    """A model ``impl`` whose every op launches its kernel and runs its
    plain version on the same inputs, raises if the two disagree beyond
    the op's tolerance, and passes the kernel's result on.  ``worst``
    maps each op to (calls, largest max abs error).  Its launches are
    comparisons, outside every counted run."""

    def __init__(self, torch):
        self.torch, self.worst, self.flips = torch, {}, {}

    def _both(self, name, tol, args, kwargs):
        from repro_torch.kernels import ops, plain
        got = getattr(ops, name)(*args, implementation="cuda", **kwargs)
        want = getattr(plain, name)(*args, **kwargs)
        pairs = [(got, want, tol)] if name == "attention" else \
            [(got[0], want[0], tol), (got[1], want[1], STATE_TOL)]
        errs = []
        for g, w, t in pairs:
            # atol scales with the call's largest value: the model's own
            # activations are not O(1)
            rtol, atol = t[str(g.dtype).removeprefix("torch.")] \
                if isinstance(t, dict) else t
            scale = max(1.0, float(w.float().abs().max()))
            errs.append(_close(self.torch, g, w, rtol, atol * scale))
        n, worst = self.worst.get(name, (0, 0.0))
        self.worst[name] = (n + 1, max(worst, errs[0]))
        if name != "attention":
            # the share of outputs rounded otherwise than the plain version
            # rounds them: what the model's depth amplifies
            self.flips[name] = max(self.flips.get(name, 0.0), float(
                (got[0] != want[0]).float().mean()))
        return got

    def attention(self, *args, **kwargs):
        return self._both("attention", FLASH_TOL, args, kwargs)

    def rwkv6(self, *args, **kwargs):
        return self._both("rwkv6", LIN_TOL, args, kwargs)

    def mamba2(self, *args, **kwargs):
        return self._both("mamba2", LIN_TOL, args, kwargs)


def run_forward(torch, arch: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, plain
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import family_module
    from repro_torch.models.tree import leaves, tree_map

    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = family_module(cfg).init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    print(f"{arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B parameters in {cfg.dtype}, drawn on the "
          f"card in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated)")
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (1, FWD_TOKENS), generator=gen,
                           device="cuda")
    step = make_prefill_step(cfg, impl="cuda")
    with torch.no_grad():
        step(params, {"tokens": tokens[:, :256]})       # warm-up
        torch.cuda.synchronize()
        _read_launches(reset=True)
        t0 = time.perf_counter()
        logits = step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        t_kernel = time.perf_counter() - t0
        launches = _read_launches()
        routes = dict(flash_attention.route_launches)
        require(logits.shape == (1, FWD_TOKENS, cfg.vocab),
                f"logits shape {tuple(logits.shape)}")
        require(launches == _launches(cfg, "forward"),
                f"one forward launched {launches}, not "
                f"{_launches(cfg, 'forward')}")
        require(routes["tc"] == launches["flash_attention"]
                and routes["simt"] == 0,
                f"the bfloat16 forward's attention took the routes {routes}")
        # the same forward on the plain versions on the card, for
        # comparison only
        plain_step = make_prefill_step(cfg, impl=plain)
        t0 = time.perf_counter()
        plain_logits = plain_step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        # the model's own sensitivity: the plain forward again with other
        # chunks (summation orders), no kernel involved
        control = make_prefill_step(cfg, impl=SimpleNamespace(
            attention=partial(plain.attention, chunk=128),
            rwkv6=partial(plain.rwkv6, chunk=16),
            mamba2=partial(plain.mamba2, chunk=64)))(
                params, {"tokens": tokens})
    lim = LIMITS[arch]
    print(f"forward 1x{FWD_TOKENS}: {t_kernel:.3f} s with the kernels, "
          f"{t_plain:.3f} s with the plain versions; launches {launches}, "
          f"flash_attention routes {routes}")
    for what, got, want, limit in (
            ("kernel forward vs the plain forward", logits, plain_logits,
             lim["forward"]),
            ("plain forward with other chunks vs the plain forward",
             control, plain_logits, None),
            # the recurrences' control runs the kernels' own chunks (16 for
            # rwkv6, 64 for mamba2): read only, no limit
            ("kernel forward vs the plain forward with other chunks",
             logits, control, None)):
        cmp = _compare_logits(torch, got, want)
        print(f"{what}: max abs err {cmp['max_abs_err']:.4g} (max |logit| "
              f"{cmp['max_abs_logit']:.4g}), min cosine "
              f"{cmp['min_cosine']:.6f} (at position "
              f"{cmp['worst_position']}), argmax agrees at "
              f"{cmp['argmax_agree']:.4f} of {FWD_TOKENS} positions")
        if limit is not None:
            require(cmp["min_cosine"] >= limit[0],
                    "kernel forward drifts from the plain")
            require(cmp["argmax_agree"] >= limit[1],
                    "kernel forward's argmax disagrees")
    del logits, plain_logits, control
    # every kernel call of the forward against its plain version on the
    # very inputs the model gave it: the check that depth cannot blur
    checked = _CheckedOps(torch)
    with torch.no_grad():
        make_prefill_step(cfg, impl=checked)(params, {"tokens": tokens})
    for name, (n, err) in sorted(checked.worst.items()):
        print(f"  {name}: {n} calls on the model's own inputs, each within "
              f"its bfloat16 tolerance of the plain version (max abs err "
              f"{err:.3g}" + (f"; at most {checked.flips[name]:.3g} of a call's "
                              f"outputs rounded otherwise" if name in
                              checked.flips else "") + ")")
    if "forward_f32" in lim:
        p32 = tree_map(lambda t: t.float(), params)
        with torch.no_grad():
            got = step(p32, {"tokens": tokens})
            want = plain_step(p32, {"tokens": tokens})
        cmp = _compare_logits(torch, got, want)
        print(f"float32 weights: kernel vs plain forward: max abs err "
              f"{cmp['max_abs_err']:.4g} (max |logit| "
              f"{cmp['max_abs_logit']:.4g}), min cosine "
              f"{cmp['min_cosine']:.7f}, argmax agrees at "
              f"{cmp['argmax_agree']:.4f}")
        require(cmp["min_cosine"] >= lim["forward_f32"],
                "float32 kernel forward drifts from the plain")
        del p32, got, want
    return {"arch": arch, "cfg": cfg, "params": params, "step": step,
            "launches": launches, "forward_s": t_kernel,
            "forward_plain_s": t_plain}


def run_serving(torch, model) -> None:
    import numpy as np

    from repro_torch import obs
    from repro_torch.launch.serve import Request, serve_requests
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import family_module

    cfg, params = model["cfg"], model["params"]
    rng = np.random.default_rng(0)
    lo, hi = SERVE["prompt"]
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(lo, hi + 1)))
               for _ in range(SERVE["n"])]
    reqs = [Request(i, p, SERVE["max_new"]) for i, p in enumerate(prompts)]
    _read_launches(reset=True)
    st = obs.enable()          # the engine's spans: where the time goes
    t0 = time.perf_counter()
    done, stats = serve_requests(cfg, params, reqs, slots=SERVE["slots"],
                                 max_seq=SERVE["max_seq"], impl="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    obs.disable()
    launches = _read_launches()
    spans = {}
    for ev in st.tracer.events():
        if ev[0] == "X":
            n, sec = spans.get(ev[1], (0, 0.0))
            spans[ev[1]] = (n + 1, sec + ev[3] / 1e6)
    require([r.status for r in done] == ["OK"] * SERVE["n"],
            f"statuses {stats['status_counts']}")
    require(all(len(r.out) == SERVE["max_new"] for r in done),
            "a request ended short of max_new")
    pre, dec = spans["serve.prefill"], spans["serve.decode_step"]
    want = {k: n * pre[0] for k, n in _launches(cfg, "prefill").items()}
    require(launches == want, f"serving launched {launches}, not {want} "
            f"({pre[0]} prefills; decode steps launch no kernel)")
    ttft = stats["ttft_s"]
    print(f"{SERVE['n']} requests (prompts {[len(p) for p in prompts]}), "
          f"{stats['generated']} tokens in {dt:.3f} s: "
          f"{stats['generated'] / dt:.2f} tokens/s, "
          f"{stats['prefill_tokens'] / dt:.1f} prompt tokens/s, "
          f"{stats['decode_steps']} decode steps; TTFT p50 "
          f"{ttft['p50']:.3f} s, p95 {ttft['p95']:.3f} s, max "
          f"{max(r.queue_latency for r in done):.3f} s; launches {launches}")
    print(f"host spans: {pre[0]} prefills {pre[1]:.3f} s, {dec[0]} decode "
          f"steps {dec[1]:.3f} s ({dec[1] / dec[0] * 1e3:.1f} ms each), the "
          f"rest {dt - pre[1] - dec[1]:.3f} s (waits for the device at each "
          f"token read, bookkeeping)")
    slot_prefill = make_prefill_step(cfg, impl="cuda",
                                     cache_len=SERVE["max_seq"])
    worst = 1.0
    with torch.no_grad():
        for r in done:
            toks = torch.as_tensor(r.prompt[None], dtype=torch.int64,
                                   device="cuda")
            lp, _ = slot_prefill(params, toks)
            require(int(torch.argmax(lp[0, -1])) == r.out[0],
                    f"request {r.rid}: the engine's first token is not the "
                    f"argmax of its prefill logits")
            lf = model["step"](params, {"tokens": toks})
            cmp = _compare_logits(torch, lp[0, -1], lf[0, -1])
            worst = min(worst, cmp["min_cosine"])
            print(f"  req {r.rid}: prompt {len(r.prompt)}, prefill vs kernel "
                  f"forward at the last position: max abs err "
                  f"{cmp['max_abs_err']:.4g} (max |logit| "
                  f"{cmp['max_abs_logit']:.4g}), cosine "
                  f"{cmp['min_cosine']:.6f}, same argmax "
                  f"{bool(cmp['argmax_agree'])}")
        lim = LIMITS[model["arch"]]
        require(worst >= lim["prefill"], "the engine's prefill drifts from "
                "the kernel forward")
        if cfg.family in ("rwkv6", "zamba2"):
            # streaming: the first half's state, carried through the cache
            # by decode_step, seeds the second half
            mod = family_module(cfg)
            toks = torch.as_tensor(done[0].prompt[None], dtype=torch.int64,
                                   device="cuda")
            half = toks.shape[1] // 2
            cache = mod.init_cache(cfg, 1, SERVE["max_seq"], device="cuda")
            _, cache = mod.decode_step(params, cfg, cache, toks[:, :half],
                                       [0], impl="cuda")
            lh, _ = mod.decode_step(params, cfg, cache, toks[:, half:],
                                    [half], impl="cuda")
            lw, _ = slot_prefill(params, toks)
            cmp = _compare_logits(torch, lh[0, -1], lw[0, -1])
            print(f"  req 0 prefilled in halves of {half} and "
                  f"{toks.shape[1] - half} vs whole: max abs err "
                  f"{cmp['max_abs_err']:.4g}, cosine {cmp['min_cosine']:.6f},"
                  f" same argmax {bool(cmp['argmax_agree'])}")
            require(cmp["min_cosine"] >= lim["halves"]
                    and cmp["argmax_agree"] == 1.0,
                    "prefilling in two halves drifts from prefilling whole")


# the forwards' attention shapes (B, S, H, Hkv, D), causal, bfloat16
FLASH_SHAPES = {"qwen3-8b": (1, FWD_TOKENS, 32, 8, 128),
                "zamba2-2.7b": (1, FWD_TOKENS, 32, 32, 80)}


def time_flash(torch, shape, launches, rates, bf16_peak) -> dict:
    """The kernel at one forward's shape beside its bound, its plain
    version, SDPA and its own SIMT route on the same values (q read
    through a view whose head stride, D + 4, the route rule refuses)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import route
    from repro_torch.kernels.xla_attention import attention as plain

    bw, _ = rates
    b, s, h, hkv, d = shape
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf = torch.bfloat16
    q = (_rand(torch, gen, b, s, h, d, dtype=torch.float32)
         * FLASH_Q_STD).to(bf)
    k = _rand(torch, gen, b, s, hkv, d, dtype=bf)
    v = _rand(torch, gen, b, s, hkv, d, dtype=bf)
    q_simt = torch.empty((b, s, h, d + 4), dtype=bf, device="cuda")[..., :d]
    q_simt.copy_(q)
    require(route(q, k, v) == "tc" and route(q_simt, k, v) == "simt",
            "the timed inputs do not take the routes they are meant to")
    want = plain(q, k, v)
    err = _close(torch, flash_attention(q, k, v), want,
                 *FLASH_TOL["bfloat16"])
    _close(torch, flash_attention(q_simt, k, v), want, *FLASH_TOL["bfloat16"])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True)
    print(f"  SDPA (the library figure, not on the path) vs the plain "
          f"version: max abs err "
          f"{float((lib().transpose(1, 2).float() - want.float()).abs().max()):.3g}")
    flops = 4 * b * h * s * s * d / 2                # causal: half the square
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())   # q, k, v, o
    t_bytes, t_ops = nbytes / bw * 1e3, flops / bf16_peak * 1e3
    return {
        "name": "flash_attention", "route": "cuda",
        "source": KERNEL_META["flash_attention"][0],
        "replaces": KERNEL_META["flash_attention"][1], "launches": launches,
        "max_abs_err": err,
        "ms": _time_ms(torch, lambda: flash_attention(q, k, v)),
        "plain_ms": _time_ms(torch, lambda: plain(q, k, v)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": _time_ms(torch, lib), "dtype": "bfloat16",
        "kernel_route": "tc",
        "simt_ms": _time_ms(torch, lambda: flash_attention(q_simt, k, v)),
        "shape": {"B": b, "Sq": s, "Skv": s, "H": h, "Hkv": hkv, "D": d,
                  "causal": True},
    }


# -- the recurrences: rwkv6 and mamba2 ---------------------------------------

def _rwkv6_inputs(torch, gen, b, t, h, dk, dv, decay, state, dtype):
    """r, k scaled by Dk^-0.5 and v, u of unit scale, so outputs are O(1);
    weak decay (w = -exp(N(-6, 0.5)), a ~400-token memory) makes the state
    carried across chunks dominate, strong decay (-exp(N(0, 0.5))) the
    pairwise and diagonal terms, and wide decay spans the model's whole
    range (-exp(clip(N(-1, 2), -8, 6)): from -3e-4 to -403 a token)."""
    f = lambda *shape: _rand(torch, gen, *shape, dtype=torch.float32)  # noqa
    r, k = f(b, t, h, dk) * dk ** -0.5, f(b, t, h, dk) * dk ** -0.5
    v, u = f(b, t, h, dv), f(h, dk) * 0.5
    if decay == "wide":
        w = -torch.exp(torch.clamp(-1.0 + 2.0 * f(b, t, h, dk), -8.0, 6.0))
    else:
        w = -torch.exp((-6.0 if decay == "weak" else 0.0)
                       + 0.5 * f(b, t, h, dk))
    s0 = f(b, h, dk, dv) * dk ** -0.5 if state else None
    return (*(x.to(dtype) for x in (r, k, v, w, u)), s0)


def _mamba2_inputs(torch, gen, b, t, h, p, n, decay, state, shared, dtype):
    """b, c scaled by N^-0.5 (one group as stride-0 views over the heads
    when ``shared``, as zamba2 passes them); weak decay a ~ -1e-3."""
    f = lambda *shape: _rand(torch, gen, *shape, dtype=torch.float32)  # noqa
    x = f(b, t, h, p)
    a = (-1e-3 * torch.exp(0.1 * f(b, t, h)) if decay == "weak"
         else -torch.exp(0.5 * f(b, t, h)))
    hb = 1 if shared else h
    bb, cc = ((f(b, t, hb, n) * n ** -0.5).to(dtype).expand(b, t, h, n)
              for _ in range(2))
    s0 = f(b, h, n, p) * n ** -0.5 if state else None
    return x.to(dtype), a.to(dtype), bb, cc, s0


def _check_recurrence(torch, kernel, plain, ins, dt) -> tuple:
    out, st = kernel(*ins)
    torch.cuda.synchronize()
    want_out, want_st = plain(*ins)
    require(out.dtype == ins[0].dtype and st.dtype == torch.float32,
            f"{kernel.__name__} dtypes {out.dtype}, {st.dtype}")
    require(float(want_out.float().abs().max()) > 0.2,
            "outputs vanish: the case tests nothing")
    err = _close(torch, out, want_out, *LIN_TOL[dt])
    _close(torch, st, want_st, *STATE_TOL)
    # bfloat16: the share of outputs whose rounding differs from the plain
    # version's, what a deep model amplifies (float32 outputs all differ in
    # their last bits)
    flips = (float((out != want_out).float().mean())
             if out.dtype == torch.bfloat16 else None)
    return err, flips, out, want_out


def _order_flips(torch, ins) -> float:
    """The share of mamba2 outputs whose rounding the plain version's own
    summation order moves: its chunk of 64 against its default 128."""
    from repro_torch.kernels import xla_linear
    return float((xla_linear.mamba2(*ins, chunk=64)[0]
                  != xla_linear.mamba2(*ins)[0]).float().mean())


def _f64_readings(torch, ins, out, want_out) -> str:
    """rwkv6 judged by error, not by rounding order: the kernel's and the
    plain version's max abs error against the plain version run in float64
    on the same inputs; in bfloat16 also each one's share of outputs that
    differ from the float64 result rounded once, and the plain version's own
    flip share at the kernel's chunk of 16 against its default 32.  Read
    only, no limit."""
    from repro_torch.kernels import xla_linear
    ref = xla_linear.rwkv6(*(None if z is None else z.double()
                             for z in ins))[0]
    err_k, err_p = (float((z.double() - ref).abs().max())
                    for z in (out, want_out))
    line = (f"against float64: kernel max abs err {err_k:.3g}, plain "
            f"{err_p:.3g}")
    if out.dtype == torch.bfloat16:
        once = ref.to(out.dtype)
        fk, fp = (float((z != once).float().mean()) for z in (out, want_out))
        order = float((xla_linear.rwkv6(*ins, chunk=16)[0] != want_out)
                      .float().mean())
        line += (f"; rounded otherwise than float64 rounded once: kernel "
                 f"{fk:.3g}, plain {fp:.3g}; the plain version at chunk 16 "
                 f"against itself at 32: {order:.3g}")
    return line


def check_recurrences(torch) -> None:
    from repro_torch.kernels import cuda_lib, mamba2, rwkv6, xla_linear
    from repro_torch.kernels.mamba2 import plan as mamba2_plan

    gen = torch.Generator(device="cuda").manual_seed(6)
    rwkv6_cases = [
        # (B, T, H, Dk, Dv, decay, state); the first two are the forward's
        (1, FWD_TOKENS, 40, 64, 64, "weak", False),
        (1, FWD_TOKENS, 40, 64, 64, "strong", True),
        (1, FWD_TOKENS, 40, 64, 64, "wide", True),
        (2, 1, 3, 64, 64, "strong", True),
        (2, 15, 2, 32, 48, "weak", False),
        (1, 17, 2, 64, 64, "weak", True),
        (1, 1000, 4, 64, 64, "weak", True),
        (2, 100, 3, 16, 40, "strong", False),
        (1, 70, 2, 128, 16, "weak", True),
    ]
    mamba2_cases = [
        # (B, T, H, P, N, decay, state, b/c stride 0 over H)
        (1, FWD_TOKENS, 80, 64, 64, "weak", False, True),
        (1, FWD_TOKENS, 80, 64, 64, "strong", True, True),
        (2, 1, 3, 64, 64, "strong", True, False),
        (2, 63, 2, 64, 64, "weak", False, True),
        (1, 65, 2, 32, 16, "strong", True, False),
        (1, 1000, 4, 64, 64, "weak", True, True),
        (2, 100, 3, 48, 24, "strong", False, False),
        (1, 70, 2, 16, 128, "weak", True, True),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).removeprefix("torch.")
        for case in rwkv6_cases:
            ins = _rwkv6_inputs(torch, gen, *case, dtype)
            err, flips, out, want = _check_recurrence(
                torch, rwkv6, xla_linear.rwkv6, ins, dt)
            print(f"  rwkv6  {dt:8s} B{case[0]} T{case[1]} H{case[2]} "
                  f"Dk{case[3]} Dv{case[4]} {case[5]} decay, state "
                  f"{case[6]}: max abs err {err:.3g}" + (
                      "" if flips is None else
                      f", outputs rounded otherwise {flips:.3g}") + " ok; "
                  + _f64_readings(torch, ins, out, want))
        for case in mamba2_cases:
            ins = _mamba2_inputs(torch, gen, *case, dtype)
            require(not case[7] or ins[2].stride(2) == 0, "b lost stride 0")
            err, flips, _, _ = _check_recurrence(
                torch, mamba2, xla_linear.mamba2, ins, dt)
            if case[7]:
                # the Gram made once a chunk for every head (stride 0) gives
                # the bits of each head's own Gram (b and c copied per head),
                # where both take one span plan (all these cases on an H100)
                sms = cuda_lib.sm_count(0)
                require(len({mamba2_plan(*case[:5], dtype == torch.bfloat16,
                                         sh, sms).spans
                             for sh in (True, False)}) == 1,
                        f"mamba2 span plans differ at {case}")
                got = mamba2(*ins)
                own = mamba2(ins[0], ins[1], ins[2].contiguous(),
                             ins[3].contiguous(), ins[4])
                require(all(torch.equal(g_, o_) for g_, o_ in zip(got, own)),
                        f"mamba2 shared Gram bits differ at {case}")
            print(f"  mamba2 {dt:8s} B{case[0]} T{case[1]} H{case[2]} "
                  f"P{case[3]} N{case[4]} {case[5]} decay, state {case[6]},"
                  f" b/c shared {case[7]}"
                  + (" (same bits as per-head b/c)" if case[7] else "")
                  + f": max abs err {err:.3g}" + (
                      "" if flips is None else
                      f", outputs rounded otherwise {flips:.3g} (the plain "
                      f"version at chunk 64 against itself at 128: "
                      f"{_order_flips(torch, ins):.3g})") + " ok")
    # streaming: two chained half calls equal one whole call
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).removeprefix("torch.")
        r, k, v, w, u, _ = _rwkv6_inputs(torch, gen, 1, 1000, 4, 64, 64,
                                         "weak", False, dtype)
        o, s = rwkv6(r, k, v, w, u)
        o1, s1 = rwkv6(r[:, :377], k[:, :377], v[:, :377], w[:, :377], u)
        o2, s2 = rwkv6(r[:, 377:], k[:, 377:], v[:, 377:], w[:, 377:], u, s1)
        e1 = _close(torch, torch.cat([o1, o2], 1), o, *LIN_TOL[dt])
        _close(torch, s2, s, *STATE_TOL)
        x, a, b, c, _ = _mamba2_inputs(torch, gen, 1, 1000, 4, 64, 64,
                                       "weak", False, True, dtype)
        y, h = mamba2(x, a, b, c)
        y1, h1 = mamba2(x[:, :377], a[:, :377], b[:, :377], c[:, :377])
        y2, h2 = mamba2(x[:, 377:], a[:, 377:], b[:, 377:], c[:, 377:], h1)
        e2 = _close(torch, torch.cat([y1, y2], 1), y, *LIN_TOL[dt])
        _close(torch, h2, h, *STATE_TOL)
        print(f"  {dt:8s} T 1000 in halves of 377 and 623 vs whole: rwkv6 "
              f"max abs err {e1:.3g}, mamba2 {e2:.3g} ok")


def time_recurrences(torch, launches, rates, bf16_peak) -> tuple:
    """Both kernels at the forwards' shapes in bfloat16.  Bytes: each input
    read once (b and c at their stored size: one group shared over the
    heads), the output and the float32 final state written once.
    Operations of the chunked algorithm per token and head: rwkv6 4 Dk Dv
    (state read and update) + 3 L Dk (pairwise scores) + L Dv (scores x
    v), L = 16; mamba2 4 N P + L N + L P (the Gram and its product, half of
    each L x L block), L = 64.  Also returns mamba2's span-state traffic
    and the floor it would set at the HBM rate (derived, not measured)."""
    from repro_torch.kernels import mamba2, rwkv6, xla_linear

    bw, _ = rates
    gen = torch.Generator(device="cuda").manual_seed(7)
    bf = torch.bfloat16
    b, t = 1, FWD_TOKENS
    h, dk = 40, 64
    r, k, v, w, u, _ = _rwkv6_inputs(torch, gen, b, t, h, dk, dk, "weak",
                                     False, bf)
    h2, p, n = 80, 64, 64
    x, a, bb, cc, _ = _mamba2_inputs(torch, gen, b, t, h2, p, n, "weak",
                                     False, True, bf)
    nbytes = lambda *ts: sum(z.untyped_storage().nbytes() for z in ts)  # noqa
    specs = [
        ("rwkv6", rwkv6, xla_linear.rwkv6, (r, k, v, w, u),
         nbytes(r, k, v, w, u) + r.numel() * 2 + b * h * dk * dk * 4,
         b * h * t * (4 * dk * dk + 3 * 16 * dk + 16 * dk),
         {"B": b, "T": t, "H": h, "Dk": dk, "Dv": dk}),
        ("mamba2", mamba2, xla_linear.mamba2, (x, a, bb, cc),
         nbytes(x, a, bb, cc) + x.numel() * 2 + b * h2 * n * p * 4,
         b * h2 * t * (4 * n * p + 64 * n + 64 * p),
         {"B": b, "T": t, "H": h2, "P": p, "N": n, "bc_head_stride": 0}),
    ]
    rows = []
    for name, kern, plain, ins, nb, flops, shape in specs:
        err = _close(torch, kern(*ins)[0], plain(*ins)[0], *LIN_TOL["bfloat16"])
        t_bytes, t_ops = nb / bw * 1e3, flops / bf16_peak * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": LIN_META[name][0],
            "replaces": LIN_META[name][1], "launches": launches[name],
            "max_abs_err": err,
            "ms": _time_ms(torch, lambda: kern(*ins)),
            "ms_graph": _time_graph_ms(torch, lambda: kern(*ins), calls=5),
            "plain_ms": _time_ms(torch, lambda: plain(*ins)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "library": "no single PyTorch call computes it",
            "dtype": "bfloat16", "shape": shape,
        })
    # the span states of both: written by pass 1, read and written by pass
    # 2, read by pass 3; their floor counts that traffic at the HBM rate
    # (they stay in the 50 MB L2 where they fit)
    import re

    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.mamba2 import plan as mamba2_plan
    from repro_torch.kernels.rwkv6 import plan as rwkv6_plan
    sms = cuda_lib.sm_count(0)
    plans = {"rwkv6": rwkv6_plan(b, t, h, dk, dk, True, sms),
             "mamba2": mamba2_plan(b, t, h2, p, n, True, True, sms)}
    span_floor = {}
    for row, (name, kern, _, ins, *_) in zip(rows, specs):
        p_ = plans[name]
        row["plan"] = p_._asdict()
        span_floor[name] = {
            "intermediate_bytes": 4 * p_.state_bytes,
            "floor_ms": row["bound_ms"] + 4 * p_.state_bytes / bw * 1e3}
        # where the time goes: device time of each pass's kernel over 5
        # calls, by torch.profiler (empty where the profiler sees no device)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                kern(*ins)
            torch.cuda.synchronize()
        row["passes_ms"] = {
            m.group(1): e.device_time_total / 5 / 1e3
            for e in prof.key_averages() if e.device_time_total > 0
            for m in [re.search(r"((?:mamba2|rwkv6|state_pass)\w*kernel"
                                r"(?:<[^>]*>)?)\(", e.key)] if m}
    require(all(math.isfinite(r_["ms"]) for r_ in rows), "a timing failed")
    return rows, span_floor


if __name__ == "__main__":
    sys.exit(main())
