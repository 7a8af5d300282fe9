#!/usr/bin/env python3
"""On-card smoke of ``repro_torch``, the PyTorch/CUDA port of HASCO, on one
NVIDIA H100 (Hopper, sm_90a).

    python3 chip_smoke.py

Run it from the root of a checkout on a machine with one CUDA device and the
CUDA toolkit; it needs no network.  Phases, each printing its own lines:

  1. the card's name and power limit (``nvidia-smi``), torch and CUDA
     versions; TF32 off for PyTorch's float32 products and convolutions;
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (timed); no
     flash tensor-core (D 80, 128), GEMM/conv tile, mamba2, rwkv6 or
     bank_mm kernel (nor the recurrences' shared state pass) spills;
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
     ``bank_mm``, the DQN bank's product (port-only), at each of the
     bank's calls (transposed views and a broadcast row of ones too) gives
     a slot the same bits in a 16-, a 4- and a 1-slot call, and twice;
  4. the main path: ``python -m repro_torch.tuner ... --measure --backend
     cuda`` for two applications at the paper's sizes into a fresh tuning
     DB, with every kernel's launch count read from that run alone (the
     DQN bank's ``bank_mm`` too, and its commonest call signature); the
     distinct measured times of the gemm and conv2d candidates with their
     plans, and whether gemm_conv's commit moved from the one made while a
     CTA owned one whole block; then a tuned ``ops.matmul`` resolves its
     blocks from the DB;
  5. each kernel timed at the main path's shape and committed blocks beside
     its bound, its plain version and the PyTorch library call, called
     back to back from Python and replayed from a CUDA graph (device time
     without the host's launch cost), with the host time a call; gemv also
     in bfloat16; gemm and conv2d with their plans, and timed at one block
     of every legal tile class; dot with its plan (CTAs, span); bank_mm at
     phase 4's commonest call;
  6. the flash attention kernel against its plain version on the card,
     float32 and bfloat16, at the forward's shape and at ragged ones (Sq <
     Skv and Sq > Skv, head dims 80/128/256, GQA, soft-cap, window, strided
     views; zamba2-7b's 1 x 4096 tokens, 32 heads of 224 at the scale
     112^-0.5), printing the route each case took: every bfloat16 case that
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
     shapes, mamba2 at phase 17's prefill chunks (T 64 and 61 at zamba2's
     80 heads, a state carried in), ragged T (1, a chunk -1 and +1, 1000),
     Dk != Dv and N != P, b/c
     as stride-0 views, strong and weak decay (the carried state dominant),
     and streaming (two chained half calls equal one whole call); mamba2
     with b/c as stride-0 views (the Gram made once a chunk for every head)
     gives the same bits as with b/c copied per head; mamba2 with b/c in two
     groups at zamba2-7b's shape (B1 T4096 H112 P64 N64 G2), in one launch,
     gives the same bits as with each group copied to its heads; each rwkv6 case also
     prints the kernel's and the plain version's max error against the
     plain version run in float64, and in bfloat16 each one's share of
     outputs rounded otherwise than the float64 result rounded once, beside
     the plain version's own share at chunk 16 against 32 (read, no limit);
 11. rwkv6-3b's full-sequence forward at full width and depth over 1 x 4096
     tokens (one rwkv6 launch and one launch of each of the block's six
     glue kernels per layer, counted from that run alone), with phase 7's
     comparisons (every glue call held to its plain version too: the
     elementwise kernels' bits, the norms' within GLUE_TOL), the kernel
     forward against the plain forward at the kernel's own chunk of 16
     (read, no limit), and the same two forwards on the weights cast to
     float32;
 12. rwkv6-3b served as in phase 8: every prefill launches the rwkv6
     kernel once per layer and every prefill and decode step each glue
     kernel once per layer, each request's prefill logits agree with the
     kernel forward's, and one prompt prefilled in two halves (the state
     carried through ``decode_step``) agrees with it prefilled whole;
 13. zamba2-2.7b's forward as in phase 11 (one mamba2 launch and one
     launch of each of the Mamba layer's three glue kernels per Mamba
     layer, one flash_attention launch per shared-block call, on the
     tensor-core route; every glue call held to its plain version); then
     zamba2-7b's at its published widths, its launches alone (81 mamba2
     with b/c in two groups and 81 of each glue kernel, 13 flash_attention
     at D 224, on the tensor-core route);
 14. zamba2-2.7b served as in phase 12;
 15. rwkv6 and mamba2 timed at the forwards' shapes beside their bounds and
     plain versions (no single PyTorch call computes either), back to back
     and replayed from a CUDA graph; each with its plan, its device time
     by kernel (torch.profiler: span states, state passing, outputs), and
     the bytes of its span states with the floor they would set at the HBM
     rate (derived, not measured); then the rwkv6 block's six glue kernels
     at rwkv6-3b's forward shapes, inputs cycled through buffers larger
     than the L2, beside their byte bounds, their plain versions and their
     wrappers' host time a call; and the Zamba2 Mamba layer's three glue
     kernels alike at zamba2-7b's forward shapes, with their launches in
     one zamba2-7b forward (phase 13) and ptxas's spilled bytes, and the
     input norm beside ``F.rms_norm``;
 16. the README's two commands on the port: ``python -m
     repro_torch.launch.serve --arch qwen3-8b --smoke --tuned-app gemm_conv
     --tuning-db <phase 4's DB>`` must print the blocks phase 4 committed
     and serve; ``examples/quickstart_torch.py`` runs the gemm kernel with
     the co-designed blocks within TOL["gemm"] of its plain version;
 17. zamba2-2.7b served by the PagedServeEngine at full width and depth
     (phase 8's requests; pages of 16 rows, prefill chunks of 64 tokens),
     traced: every request ends OK, the mamba2 launches of that run alone
     are the Mamba layers times the prefill chunks of more than one token
     and each glue kernel's the Mamba layers times every chunk and decode
     step, each request's first token is the argmax of its own prefill re-run
     batch-1 in the engine's chunks, every kernel call of that re-run
     within its tolerance of the plain version on the same inputs, whose
     logits agree with the kernel forward's at LIMITS' ``chunks`` (each
     request's reading printed beside the plain versions'), and
     ``python -m repro_torch.obs`` validates the run's telemetry export;
     then again with the kv sanitizer on every tick and a pool small
     enough to preempt: at least one preemption, and every request's
     tokens equal the first run's (the no-recompute swap guarantee);
 18. one MoE layer at granite-moe-3b-a800m's widths in float32 with
     capacity factor 1.0 (tokens dropped) on the card against the same
     layer on the CPU: the same routing (expert, slot, keep) and outputs
     within MOE_TOL; then granite-moe-3b-a800m served paged as phase 17's
     first run, each first token held to its batch-1 chunked prefill.
     Phases 17 and 18 print tokens/s, TTFT p50/p95, decode-step ms,
     prefill chunks and preemptions for each run;
 19. training and resume: (a) the attention ``torch.autograd.Function``'s
     dq, dk, dv against autograd through the same forward loop, at
     zamba2-2.7b's shared block (1024 tokens, H 32, D 80) and qwen3-8b's
     GQA (H 32/8, D 128) with soft-cap, window, and Sq < Skv with Skv not
     a multiple of the chunk, float32 (within ``VJP_TOL`` of each
     gradient's largest value) and bfloat16 (no further from the float32
     loop than ``VJP_BF16_FACTOR`` times the bfloat16 loop), each with its
     peak memory beside the loop's; (b) step 0 of ``make_train_step`` on
     the card against the CPU for reduced zamba2-2.7b and qwen3-8b in
     float32 (loss, every grad leaf, the updated params); (c) zamba2-2.7b
     at full width and depth (bfloat16, seeded random weights) taking 8
     AdamW steps (peak lr 3e-4, warmup 5, cosine over 8) over
     ``SyntheticLM`` batches of 1 x 1024 tokens through
     ``Prefetcher``: finite losses, the loss falling, no attention or
     recurrence kernel launched (training runs the plain versions), peak
     memory under ``TRAIN_PEAK_LIMIT``, with each step's ms and tokens/s;
     (d) ``python -m repro_torch.launch.train`` on the card: failure
     injection at step 6, then a rerun that resumes from step 4 and
     reaches step 11, and granite-moe with ``--grad-compression``; (e) the
     measured co-design flow (``--intrinsics GEMM,DOT``, gemm 1024^3,
     phase 4's depth) checkpointed per intrinsic, its newest payload
     deleted, then resumed: the resumed run launches exactly the DOT
     round's kernels (the tuner lowers a workload by its shape, so the DOT
     round also runs ``gemm``), keeps the GEMM round's measured summary,
     explores the same points in both rounds as the first run, and
     commits one of its round's measured candidates (which one is host
     timing where candidates share a kernel geometry; printed beside the
     first run's).  (b) also requires the same ``value_and_grad`` twice on
     the card to give the same bits in every leaf, and (d) the crashed and
     resumed runs (plain and ``--grad-compression``) to end on the
     uninterrupted runs' step-11 checkpoint bytes;
 20. distributed on the one card: (a) a one-rank NCCL mesh (data=1,
     model=1) serving phase 17's zamba2-2.7b requests on the
     ``PagedServeEngine(mesh=...)``, bit for bit the tokens without a mesh;
     (b) two ranks sharing the card (``chip_smoke.py --phase20-rank``,
     gloo: NCCL refuses two ranks on one device) at data=1, model=2:
     qwen3-8b's forward over phase 7's 1 x 4096 tokens through
     ``make_prefill_step(mesh=...)`` (H 16 / KV 4 a rank, 36
     ``flash_attention`` launches a rank on the tensor-core route, each
     call checked against its plain version, logits against phase 7's by
     cosine), and zamba2-2.7b in float32, whole, on the paged engine (40
     SSD heads a rank) serving the first 2 of phase 17's 8 requests, token
     for token the single-device engine's on the same 2, its ``mamba2``
     launches counted and each call checked; (c) a reduced zamba2-2.7b
     data-parallel ZeRO-1 step, each rank taking half the global batch,
     against one process on the whole batch; (d) that state checkpointed
     from the two ranks and restored onto (a)'s mesh as DTensors, every
     leaf equal.  Tokens/s and the collectives' calls and seconds are
     printed beside the mesh-less runs: two ranks on one card measure the
     plumbing, not the speed of tensor parallelism;
 21. analysis and the dry run (the CPU parts in subprocesses, with the
     card hidden, while (b) runs): (a) ``python -m repro_torch.analysis``
     over every config and mesh and the golden schedule must exit 0, and
     every arch's specs must turn into placements on a fake 16x16 mesh;
     (b) two positive controls (a scalar read, a blocking upload) must be
     reported by the card at their line and named by the audit; then the
     serving hot paths of zamba2-2.7b and qwen3-8b at phases 8 and
     17's sizes (dense decode, paged decode, a 1024-token prefill, the slot
     write) each run once on the card under
     ``torch.cuda.set_sync_debug_mode("warn")``: every sync the card
     reports must be a ``trace/host-sync`` finding of ``audit_program`` on
     the same program at the same shapes, with the launches of that run
     (zamba2's prefill one ``mamba2`` a Mamba layer, qwen3's none); then
     ``audit_hot_paths`` on the card for their reduced configs, where a
     serving program may have no sync the card reports and the watch
     misses, and the train step no sync at all;
     (c) ``python -m repro_torch.launch.dryrun`` on qwen3-8b x train_4k
     (16x16, in the FSDP layout and in ZeRO-1's: FSDP's argument bytes a
     rank must lie below ZeRO-1's), zamba2-2.7b x decode_32k (16x16 and
     2x16x16) and rwkv6-3b x long_500k (16x16), then the roofline of
     their records; (d) the dry run
     on one device for phase 19 (c)'s training config, whose argument bytes
     must equal phase 19's params, moments, step and batch to the byte
     (its predicted peak printed beside phase 19's), and for phase 7's
     forward, its FLOP count beside ``model_flops`` and its compute bound
     beside phase 7's seconds;
 22. FSDP training: zamba2-2.7b at full width, its depth cut to
     ``FSDP_TRAIN``'s 3 of 9 layer groups, float32, one AdamW step on 2 x
     512 tokens: (a) in one process; (b) on two ranks sharing the card
     (``chip_smoke.py --phase22-rank``, gloo), one row a rank, with the
     params and moments each rank's shard by the specs (each layer
     gathered where it runs): loss and grad norm within ``FSDP_TOL`` of
     (a)'s; then the same step with ZeRO-1's layout, each rank printing
     its param and moment bytes, peak memory, step time and collectives
     for both; (c) (b)'s FSDP checkpoint restored onto a one-rank mesh,
     every leaf bit for bit (b)'s whole params.
 23. the experiment scripts (``repro_torch.bench``) on the card: (a)
     ``kernel_micro``'s four kernels (gemm 512^3 f32, flash_attention b1
     s1024 h8/2 d64 bf16 on the tensor-core route, rwkv6 and mamba2 at b1
     s512 h8 f32) each checked against its plain version at this smoke's
     tolerances, then timed by CUDA events and by graph replay beside its
     bound, their launches counted from that run alone; then three
     processes at once: (b) on the card in a process of its own
     (``chip_smoke.py --phase23-figs``), first the DQN bank: slot i of a
     16-seed bank, of a 4-seed bank and of the 1-seed bank of seed i, and
     a standalone DQN, bit for bit equal after 12 ragged rounds at the
     DSE's widths, and a bank's graph-replayed rounds bit for bit its
     eager ones, each required; then fig7, fig11, the Q-learning
     ablation, fig10 (3 seeds), Table III, bench_sw_dse and
     bench_calibration at the reference's settings, each ``main()`` with
     its rows printed: every number finite, every script allocating on the
     card, bench_sw_dse's engines in parity with the same
     ``codesign(q=4)`` solution, bench_calibration's gemm launches
     counted; (c) here, bench_serve (uniform and the 10:1 mix), bench_obs
     and bench_serve_tp's ``model=1`` (a one-rank NCCL group) at full
     width, qwen3-8b in float32: outputs identical across engines and
     traced/untraced runs, no lifecycle defect, a valid telemetry schema,
     ``model=1`` bit for bit; (d) on the CPU with the card hidden
     (``chip_smoke.py --phase23-cpu``): bench_serve_tp's 8-way scenario (8
     gloo ranks) and its TP-aware codesign, then bench_acquisition
     (hypervolume parity required); last, bench_batched_eval alone, then
     bench_sw_dse's round loop alone in a process on the card
     (``chip_smoke.py --phase23-sw-dse``: both engines' seconds, parity
     required).  A correctness gate that fails ends the smoke; each speed
     gate prints ``gate <name> pass|MISS <reading>`` and a miss is a
     reading.
Each model is freed before the next one is drawn.

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises and the script
exits non-zero without that line, as it does where there is no CUDA device
or no checkout around it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
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

# the card's HBM rate and peak FLOP/s (float32 without tensor cores: every
# intrinsic kernel here runs float32 FMA; bfloat16 on tensor cores, the
# least time for bfloat16 work whatever unit a kernel uses) come from the
# data sheet's numbers in repro_torch.launch.roofline.CARDS, which the
# roofline uses too

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
    # port-only: no TPU kernel; the reference's bank runs XLA's dot here
    "bank_mm": ("src/repro_torch/csrc/bank_mm.cu",
                "src/repro/core/qlearning.py:182"),
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
#     through decode_step) against prefilled whole, cosine;
#   chunks: the paged engine's prefill re-run batch-1 in its chunks of 64
#     (up to 15 pieces) against the kernel forward at the last position,
#     least cosine over the requests; bfloat16, so it reads the model's own
#     sensitivity to where the prompt is cut: per request the plain
#     versions cut alike read 0.990120-0.998573 against the plain forward,
#     the kernels 0.989042-0.998707, both least at one request (the smoke
#     prints both each run); in float32 both read 0.9999999, so the float32
#     reading is held at forward_f32.  The kernels on that path are held
#     per call, each against its plain version on the same inputs.
LIMITS = {
    "qwen3-8b": dict(forward=(0.999, 0.9), prefill=0.999),
    "rwkv6-3b": dict(forward=(0.45, 0.6), forward_f32=0.98, prefill=0.999,
                     halves=0.98),
    "zamba2-2.7b": dict(forward=(0.99, 0.85), forward_f32=0.99999,
                        prefill=0.998, halves=0.998, chunks=0.985),
}

# rwkv6 / mamba2 (rtol, atol) against their plain chunked versions:
# float32 1e-4 (the same float32 math summed in other orders and chunks);
# bfloat16 outputs one bf16 ulp (both round a float32 result once), with
# atol for outputs near 0; the float32 final states at 1e-4 in both
LIN_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-3)}
STATE_TOL = (1e-4, 1e-4)
# the rwkv6 block's glue kernels against their plain versions: the
# elementwise ones (decay, relu^2, channel gate) to the bit; the norms (the
# two prologues, the head norm) differ only by their float32 sums' order,
# so their normed values are held within one bfloat16 ulp (1e-5 in
# float32) and everything after the norm to the plain version's bits on
# the kernel's own normed values (_check_glue)
GLUE_TOL = {"float32": (1e-5, 1e-5), "bfloat16": LIN_TOL["bfloat16"]}
# the paged engine (phases 17, 18): page and prefill-chunk sizes, and the
# page-pressure run's pool.  The dense-equivalent pool is 512 pages (4
# slots x 2048 rows / 16); at half of it (256) these eight requests' rows
# fit at every step and nothing is preempted, at 200 pages one request is
# (the same lengths served on the CPU by a reduced model)
PAGED = dict(page_size=16, prefill_chunk=64)
PRESSURE_PAGES = 200
# one MoE layer on the card against the CPU, float32 (rtol, atol x the
# largest output): both sum the d 1536 and f 512 products in other orders,
# ~sqrt(K) float32 ulps apart
MOE_TOL = (1e-4, 1e-5)
# phase 19: the attention VJP's cases (B, Sq, Skv, H, Hkv, D, soft-cap,
# window), causal: zamba2-2.7b's shared block and qwen3-8b's GQA at 1024
# tokens, gemma2's soft-cap of 50, a window, and Sq < Skv with Skv not a
# multiple of the 256-key chunk
VJP_CASES = {
    "zamba2 shared block": (1, 1024, 1024, 32, 32, 80, 0.0, 0),
    "qwen3 GQA": (1, 1024, 1024, 32, 8, 128, 0.0, 0),
    "soft-cap 50": (1, 1024, 1024, 32, 8, 128, 50.0, 0),
    "window 384": (1, 1024, 1024, 32, 8, 128, 0.0, 384),
    "Sq 200 < Skv 1000": (1, 200, 1000, 32, 8, 128, 0.0, 0),
}
# float32: each of dq, dk, dv within VJP_TOL of its largest |value| of
# autograd through the same forward loop (the same float32 math summed in
# other orders).  bfloat16: autograd through the loop in float32 on the same
# values is the yardstick, and the Function may be no further from it than
# autograd through the loop in bfloat16 is, times VJP_BF16_FACTOR (both
# round the gradients to bfloat16 once)
VJP_TOL = 1e-4
VJP_BF16_FACTOR = 2.0
# step 0 of make_train_step on the card against the CPU, reduced configs in
# float32: the loss's relative difference; each grad and updated-param leaf
# against its largest |value|
TRAIN_CPU_TOL = dict(loss=1e-5, grad=1e-4)
# the full-width training run: 8 AdamW steps of zamba2-2.7b over 1 x 1024
# tokens.  Peak lr 3e-4: Adam moves every weight by about lr a step, and at
# the trainer's default of 3e-3 (15% of the 0.02 init scale a step) the
# full-width model's loss rose from step 2 and reached 27.0 at step 6 (an
# H100 run: 10.92 at step 0, 11.16 at step 7), where the reduced configs
# learn at 3e-3
TRAIN_FULL = dict(arch="zamba2-2.7b", steps=8, seq_len=1024, batch=1,
                  peak_lr=3e-4, warmup=5)
TRAIN_PEAK_LIMIT = 75e9
# the measured co-design resume: two intrinsics, two payloads
RESUME_APP = ["--app", "resume", "--intrinsics", "GEMM,DOT", "--workload",
              "gemm:1024,1024,1024"]
RESUME_DB = ROOT / "artifacts" / "chip_smoke" / "resume_tuning_db.json"

# phase 20: phase 7's qwen3-8b logits, kept for the two-rank forward
QWEN_LOGITS = ROOT / "artifacts" / "chip_smoke" / "qwen3_logits.pt"
DIST_DIR = ROOT / "artifacts" / "chip_smoke" / "dist"
# the two-rank (model=2) qwen3-8b forward against phase 7's single-device
# kernel forward, bfloat16: least cosine over positions, just below the
# first reading (PERF.md section 2)
TP_FWD_COSINE = 0.9995
# (c) the two-rank data-parallel step against one process on the whole
# batch, reduced zamba2-2.7b in float32: the loss's relative difference,
# each grad leaf and each ZeRO-1 moment leaf against its largest |value|
# (the same float32 math, summed in two halves: TRAIN_CPU_TOL's rounding
# class); the updated params within half an update (lr / 2) of one
# process's, since Adam scales each element's grad to about one update
# and an element whose grad is at its rounding noise moves by up to that
DP_TOL = dict(loss=1e-5, grad=1e-4, param_updates=0.5)
DP_TRAIN = dict(arch="zamba2-2.7b", seq=64, batch=4, lr=1e-2)
# (b)'s zamba2-2.7b served at model=2, whole and in float32: the first
# TP_ZAMBA_REQUESTS of phase 17's requests (two gloo ranks on one card serve
# at a few tokens/s, so the requests' prefill chunks set the phase's time)
TP_ZAMBA_REQUESTS = 2
# phase 22: zamba2-2.7b at full width, its depth cut to FSDP_TRAIN's layer
# groups (of the config's 9; a group is 6 Mamba-2 layers and a shared-block
# call), float32, one AdamW step on a global batch of 2 x 512 tokens: one
# process (a) against FSDP on two ranks sharing the card (b), one row a
# rank; then ZeRO-1 on the same ranks for the bytes beside FSDP's
FSDP_TRAIN = dict(arch="zamba2-2.7b", groups=3, seq=512, batch=2, lr=1e-4)
FSDP_DIR = ROOT / "artifacts" / "chip_smoke" / "fsdp"
# (b) against (a): the loss within 1e-6 and the grad norm within 1e-5 of
# one process's, relative.  float32, so that this bar holds: the two ranks
# compute the same float32 math row by row and sum it over the ranks in
# another order (rounding at 1e-7 a term); in bfloat16 a product over one
# row rounds otherwise than over two, which the step carries to the loss
FSDP_TOL = dict(loss=1e-6, grad_norm=1e-5)
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
    if sys.argv[1:2] == ["--phase20-rank"]:
        return phase20_rank()
    if sys.argv[1:2] == ["--phase21-cell"]:
        return phase21_cell(sys.argv[2:])
    if sys.argv[1:2] == ["--phase21-placements"]:
        return phase21_placements()
    if sys.argv[1:2] == ["--phase22-rank"]:
        return phase22_rank()
    if sys.argv[1:2] == ["--phase23-cpu"]:
        return phase23_cpu()
    if sys.argv[1:2] == ["--phase23-figs"]:
        return phase23_figs()
    if sys.argv[1:2] == ["--phase23-sw-dse"]:
        return phase23_sw_dse()
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
    from repro_torch.launch.roofline import card_rates
    card = card_rates(name)
    rates = (card["hbm"], card["f32"])

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
    for prefix in ("mamba2_", "rwkv6_", "state_pass_", "bank_mm_"):
        lines = [ln for ln in report if ln.startswith(prefix)]
        require(bool(lines) or not info["log"],
                f"no ptxas report for {prefix}*")
        for line in lines:
            require(line.endswith(" 0 bytes spilled"),
                    f"a {prefix}* kernel spills: {line}")

    phase("3. kernels against their plain versions")
    check_kernels(torch)
    check_bank_mm(torch)

    phase("4. main path: measured co-design on the card")
    launches, db, bank_sig = run_main_path(torch)

    phase("5. timings at the main path's shapes and blocks")
    rows = time_kernels(torch, db, launches, rates)
    rows.append(time_bank_mm(torch, launches["bank_mm"], bank_sig, rates))
    for r in rows[:-1]:
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

    bf16_peak = card["bf16"]
    fwd_launches, attn_launches, fwd_seconds = {}, {}, {}
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
        fwd_seconds[arch] = model["forward_s"]
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
    # the published Zamba2 form: B/C in two groups, two shared blocks
    z7 = count_forward(torch, "zamba2-7b")
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
    # the Mamba layer's glue rows count zamba2-7b's forward (the cell's)
    glue_launches = {**fwd_launches, **{k: v for k, v in z7.items()
                                        if k.startswith("mamba2_")}}
    for row in time_glue(torch, glue_launches, rates, report):
        print(f"  {row['name']:17s} {row['ms']:.4f} ms (replayed from a CUDA "
              f"graph {row['ms_graph']:.4f} ms, {100 * row['bound_share']:.1f}"
              f"% of its bound)  bound {row['bound_ms']:.4f} ms by bytes "
              f"({row['bytes'] / 1e6:.1f} MB)  plain {row['plain_ms']:.4f} ms"
              + (f"  library {row['library_ms']:.4f} ms"
                 if row["library_ms"] is not None else "")
              + f"  host {row['host_ms']:.4f} ms a call  launches "
              f"{row['launches']}  max_abs_err vs plain "
              f"{row['max_abs_err']:.3g}  spilled {row['spilled_bytes']} "
              f"bytes")
        rows.append(row)
    phase("16. the README's two commands on the port, and the quickstart")
    run_two_commands(torch)

    phase("17. paged serving: the PagedServeEngine on zamba2-2.7b")
    paged = run_paged(torch, "zamba2-2.7b", pressure=True)
    mamba_row = next(r_ for r_ in rows if r_["name"] == "mamba2")
    mamba_row["paged_launches"] = paged["launches"]["mamba2"]
    torch.cuda.empty_cache()

    phase("18. MoE: one layer on the card against the CPU, then "
          "granite-moe-3b-a800m served paged")
    check_moe(torch)
    run_paged(torch, "granite-moe-3b-a800m")
    torch.cuda.empty_cache()

    phase("19. training and resume: the attention VJP, a train step card vs "
          "CPU, zamba2-2.7b at full width, the train CLI, co-design resume")
    train = run_training(torch)
    torch.cuda.empty_cache()

    phase("20. distributed on the one card: a one-rank mesh, two ranks "
          "(tensor-parallel serving and forward, data-parallel training), "
          "elastic restore")
    flash_row = next(r_ for r_ in rows if r_["name"] == "flash_attention")
    tp = run_distributed(torch, paged, fwd_seconds)
    flash_row["tp2_launches_per_rank"] = tp["flash_attention"]
    mamba_row["tp2_paged_launches_per_rank"] = tp["mamba2"]

    phase("21. analysis: the lint CLI and placements on a fake 16x16 mesh, "
          "the hot-path audit on the card, the dry run on the production "
          "meshes and held against phases 7 and 19")
    audit = run_analysis(torch, fwd_seconds, train, bf16_peak)
    mamba_row["audit_prefill_launches"] = audit["zamba2-2.7b"]["prefill"]

    phase("22. FSDP training: zamba2-2.7b at full width, one process "
          "against two ranks sharing the card, ZeRO-1's bytes beside, and "
          "the checkpoint restored onto one rank")
    run_fsdp(torch)

    phase("23. the experiment scripts on the card: kernel_micro, the "
          "figures and Table III, the DSE and calibration benchmarks, the "
          "serving gates at full width")
    run_bench(torch, rows)

    flash_row["zamba2_shape"]["launches"] = attn_launches["zamba2-2.7b"]
    require(len(rows) == 17, f"{len(rows)} kernel rows, not 17")
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


# the DQN bank's products (phase 3): (a, b, bias, relu) shapes as
# ``repro_torch.core.qlearning`` calls ``bank_mm`` at the DSE's widths (28
# features, 64 hidden, 26 moves), a minibatch of 32 and a frontier of 6;
# "aT" / "bT" take a transposed view, "ones" a broadcast row of ones (the
# row sum of the bias gradients and the loss)
BANK_MM_CASES = (
    ("layer 1", (32, 28), (28, 64), True, True, ""),
    ("hidden", (32, 64), (64, 64), True, True, ""),
    ("output", (32, 64), (64, 26), True, False, ""),
    ("select", (6, 64), (64, 26), True, False, ""),
    ("weight grad", (64, 32), (32, 64), False, False, "aT"),
    ("input grad", (32, 26), (26, 64), False, False, "bT"),
    ("row sum", (1, 32), (32, 64), False, False, "ones"),
)
BANK_MM_SLOTS = (1, 4, 16)


def _bank_mm_inputs(torch, gen, n, a_shape, b_shape, bias, view):
    """One BANK_MM_CASES case at ``n`` slots: (a, b, bias or None)."""
    (m, k), (_, p) = a_shape, b_shape
    r = lambda *sh: _rand(torch, gen, *sh, dtype=torch.float32)  # noqa: E731
    if view == "aT":
        a = r(n, k, m).transpose(1, 2)
    elif view == "ones":
        a = torch.ones((), device="cuda").expand(n, m, k)
    else:
        a = r(n, m, k)
    b = r(n, p, k).transpose(1, 2) if view == "bT" else r(n, k, p)
    return a, b, (r(n, p) if bias else None)


def check_bank_mm(torch) -> None:
    """The DQN bank's product against its plain version (``torch.bmm`` /
    ``baddbmm`` on the card, TF32 off) at the bank's shapes, and its
    contract: slot i of a 16-slot call has the bits of the same slot in a
    4-slot and a 1-slot call, and a second run gives the same bits."""
    from repro_torch.kernels.bank_mm import bank_mm, bank_mm_plain

    gen = torch.Generator(device="cuda").manual_seed(5)
    rtol, atol = TOL["gemm"]["float32"]
    for name, a_shape, b_shape, bias, relu, view in BANK_MM_CASES:
        a, b, c = _bank_mm_inputs(torch, gen, max(BANK_MM_SLOTS), a_shape,
                                  b_shape, bias, view)
        got = bank_mm(a, b, c, relu)
        require(torch.equal(got, bank_mm(a, b, c, relu)),
                f"bank_mm {name}: other bits on a second run")
        for n in BANK_MM_SLOTS[:-1]:
            part = bank_mm(a[:n], b[:n], None if c is None else c[:n], relu)
            require(torch.equal(part, got[:n]),
                    f"bank_mm {name}: a slot's bits change with the slots "
                    f"in the call ({n} against {len(got)})")
        torch.cuda.synchronize()
        err = _close(torch, got, bank_mm_plain(a, b, c, relu), rtol, atol)
        print(f"  bank_mm {name:11s} a {tuple(a.shape)} b {tuple(b.shape)}"
              f"{' ' + view if view else ''}, bias {bias}, relu {relu}: the "
              f"same bits at {BANK_MM_SLOTS} slots; max abs err {err:.3g} "
              f"(rtol {rtol}, atol {atol}) ok")


def time_bank_mm(torch, launches: int, sig: tuple, rates) -> dict:
    """The kernels line's bank_mm row, at the main path's commonest call
    ``sig`` = (a shape, b shape, bias, relu), contiguous inputs."""
    from repro_torch.kernels.bank_mm import bank_mm, bank_mm_plain

    (n, m, k), (_, _, p), bias, relu = sig
    gen = torch.Generator(device="cuda").manual_seed(6)
    a, b, c = _bank_mm_inputs(torch, gen, n, (m, k), (k, p), bias, "")
    bw, peak = rates
    nbytes = 4 * (a.numel() + b.numel() + n * m * p
                  + (0 if c is None else c.numel()))
    flops = 2 * n * m * k * p
    t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
    lib = (lambda: torch.baddbmm(c[:, None], a, b)) if bias else \
        (lambda: torch.bmm(a, b))
    row = {
        "name": "bank_mm", "route": "cuda",
        "source": KERNEL_META["bank_mm"][0],
        "replaces": KERNEL_META["bank_mm"][1], "launches": launches,
        "max_abs_err": _close(torch, bank_mm(a, b, c, relu),
                              bank_mm_plain(a, b, c, relu),
                              *TOL["gemm"]["float32"]),
        "ms": _time_ms(torch, lambda: bank_mm(a, b, c, relu)),
        "plain_ms": _time_ms(torch, lambda: bank_mm_plain(a, b, c, relu)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        # one PyTorch call computes it only without the ReLU
        "library_ms": None if relu else _time_ms(torch, lib),
        "library_ms_without_relu": _time_ms(torch, lib),
        "ms_graph": _time_graph_ms(torch, lambda: bank_mm(a, b, c, relu)),
        "library_ms_graph": _time_graph_ms(torch, lib),
        "shape": {"a": [n, m, k], "b": [n, k, p], "bias": bias,
                  "relu": relu}, "dtype": "float32"}
    require(math.isfinite(row["ms"]), "a bank_mm timing failed")
    print(f"  bank_mm a {tuple(a.shape)} b {tuple(b.shape)} bias {bias} relu "
          f"{relu} (the main path's commonest call): {row['ms']:.4f} ms by "
          f"events, replayed {row['ms_graph']:.4f} ms; bound "
          f"{row['bound_ms']:.6f} ms by {row['bound_by']}; plain "
          f"{row['plain_ms']:.4f} ms; torch.{'baddbmm' if bias else 'bmm'}"
          f"{' without the ReLU' if relu else ''} "
          f"{row['library_ms_without_relu']:.4f} ms, replayed "
          f"{row['library_ms_graph']:.4f} ms; launches {launches}; max abs "
          f"err {row['max_abs_err']:.3g}")
    return row


def run_main_path(torch):
    from collections import Counter

    from repro_torch.core import qlearning
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
    # the DQN bank's products on the main path, by call signature: phase 5
    # times the commonest
    bank_calls, bank_mm = Counter(), qlearning.bank_mm

    def bank_spy(a, b, bias=None, relu=False):
        bank_calls[(tuple(a.shape), tuple(b.shape), bias is not None,
                    relu)] += 1
        return bank_mm(a, b, bias, relu)

    qlearning.bank_mm = bank_spy
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
        qlearning.bank_mm = bank_mm
    launches = {k.__name__: k.launches for k in (*INTRINSICS, bank_mm)}
    print(f"main path took {time.perf_counter() - t0:.1f} s; launches "
          f"{launches} (bank_mm's eager launches and those of each train "
          f"graph's replays; a capture launches nothing)")
    for name, n in launches.items():
        require(n > 0, f"{name} kernel was not launched by the main path")
    sig, n = bank_calls.most_common(1)[0]
    print(f"  bank_mm's commonest call: a {sig[0]} @ b {sig[1]}, bias "
          f"{sig[2]}, relu {sig[3]}, {n} of {sum(bank_calls.values())} calls "
          f"through the wrapper in {len(bank_calls)} signatures (a graph's "
          f"replays make no call)")

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
    return launches, db, sig


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
        # zamba2-7b's shared attention: heads of 224, scale (224 / 2)^-0.5
        (1, FWD_TOKENS, FWD_TOKENS, 32, 32, 224, dict(scale=112 ** -0.5)),
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
    (``run='forward'``), one serving prefill (``'prefill'``) or one decode
    step (``'decode'``) of ``cfg`` must make: the recurrences once per
    layer in the forward and a prefill; rwkv6's six glue kernels and
    zamba2's three once per layer in all three; attention once per layer
    (per shared-block call)
    in the forward only, since a prefill's attention runs the decode path's
    plain einsums."""
    from repro_torch.kernels import GLUE, KERNELS, MAMBA2_GLUE
    want = {k.__name__: 0 for k in KERNELS}
    glue = {"rwkv6": GLUE, "zamba2": MAMBA2_GLUE}.get(cfg.family, ())
    want.update({k.__name__: cfg.n_layers for k in glue})
    if run == "decode":
        return want
    if cfg.family == "rwkv6":
        want["rwkv6"] = cfg.n_layers
    elif cfg.family == "zamba2":
        want["mamba2"] = cfg.n_layers
        if run == "forward":      # one call a hybrid layer (a group's)
            want["flash_attention"] = (len(cfg.hybrid_layer_ids)
                                       or cfg.n_layers // cfg.attn_every)
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

    def _glue(self, name, args):
        from repro_torch.kernels import ops
        got = getattr(ops, name)(*args, implementation="cuda")
        err, flips = _check_glue(self.torch, name, args, got)
        n, worst = self.worst.get(name, (0, 0.0))
        self.worst[name] = (n + 1, max(worst, err))
        self.flips[name] = max(self.flips.get(name, 0.0), flips)
        return got

    def mamba2_norm_in(self, *args):
        return self._glue("mamba2_norm_in", args)

    def mamba2_conv_in(self, *args):
        return self._glue("mamba2_conv_in", args)

    def mamba2_gate_out(self, *args):
        return self._glue("mamba2_gate_out", args)

    def rwkv6_time_in(self, *args):
        return self._glue("rwkv6_time_in", args)

    def rwkv6_decay(self, *args):
        return self._glue("rwkv6_decay", args)

    def rwkv6_head_out(self, *args):
        return self._glue("rwkv6_head_out", args)

    def rwkv6_channel_in(self, *args):
        return self._glue("rwkv6_channel_in", args)

    def rwkv6_relu2(self, *args):
        return self._glue("rwkv6_relu2", args)

    def rwkv6_channel_out(self, *args):
        return self._glue("rwkv6_channel_out", args)


def _check_glue(torch, name, args, got) -> tuple[float, float]:
    """One call of a glue kernel (rwkv6's, zamba2's Mamba layer's) against
    its plain version on the same inputs (GLUE_TOL's rule): the elementwise
    kernels' outputs must be the plain version's bits; an rwkv6 norm
    kernel's normed values (its mixes at mu = 0, its head output at a gate
    of exactly 1: silu(1.28125) rounds to 1 in bfloat16) within GLUE_TOL of
    the plain norm, and its outputs the plain version's bits on those
    normed values; a Mamba layer's norm each row's plain bits but for its
    normalizer (``glue_common.one_inv_a_row``).  Returns the largest abs
    difference from the plain version's outputs and the share of the first
    output rounded otherwise (read, no limit)."""
    import torch.nn.functional as F

    from repro_torch.kernels import glue_common
    from repro_torch.kernels import mamba2_glue as M
    from repro_torch.kernels import plain
    from repro_torch.kernels import rwkv6_glue as G
    want = getattr(plain, name)(*args)
    outs = (got,) if torch.is_tensor(got) else tuple(got)
    wants = (want,) if torch.is_tensor(want) else tuple(want)
    require(len(outs) == len(wants) and all(
        g.dtype == w.dtype and g.shape == w.shape
        for g, w in zip(outs, wants)), f"{name}: outputs unlike the plain's")
    dt = str(outs[0].dtype).removeprefix("torch.")
    if name in ("rwkv6_time_in", "rwkv6_channel_in"):
        time_in = name == "rwkv6_time_in"
        *head, mu, prev = args
        mu = mu.to(head[0].dtype)
        normed = getattr(G, name)(*head, torch.zeros_like(mu), prev)[
            0 if time_in else 1]
        require(time_in or torch.equal(outs[0], wants[0]),
                f"{name}: x + att differs from the plain version's bits")
        _close(torch, normed,
               glue_common.rms_norm(head[0] if time_in else wants[0],
                                    head[-1]), *GLUE_TOL[dt])
        xp = G._shift(normed, prev)
        mixes = outs[:-1] if time_in else outs[1:-1]
        require(all(torch.equal(m, normed + (xp - normed) * mu[i])
                    for i, m in enumerate(mixes))
                and torch.equal(outs[-1], normed[:, -1]),
                f"{name}: the mixes or the carry differ from the plain "
                f"version's bits on the kernel's normed rows")
    elif name == "rwkv6_head_out" and dt == "bfloat16":
        o, ln_x, g_pre = args
        normed = G.rwkv6_head_out(o, ln_x, torch.full_like(g_pre, 1.28125))
        _close(torch, normed,
               glue_common.rms_norm(o, ln_x).reshape(normed.shape),
               *GLUE_TOL[dt])
        require(torch.equal(got, normed * F.silu(g_pre)), f"{name}: the "
                f"gate differs from the plain version's bits")
    elif name == "rwkv6_head_out":
        _close(torch, got, want, *GLUE_TOL[dt])
    elif name in ("mamba2_norm_in", "mamba2_gate_out"):
        if name == "mamba2_norm_in":
            x, t, w, eps = args
            pre, groups = (x if t is None else x + t), 1
        else:
            y, xs, z, d_skip, w, groups, eps = args
            pre = M._gated(y, xs, z, d_skip)
        require(glue_common.one_inv_a_row(got, pre, w, eps, groups),
                f"{name}: a row is not the plain version's values times one "
                f"normalizer near the plain norm's")
    else:
        require(all(torch.equal(g, w) for g, w in zip(outs, wants)),
                f"{name} differs from its plain version's bits")
    return (max(float((g.float() - w.float()).abs().max())
                for g, w in zip(outs, wants)),
            float((outs[0] != wants[0]).float().mean()))


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
        if arch == "qwen3-8b":     # phase 20 (b) holds its TP forward to it
            torch.save(logits.cpu(), QWEN_LOGITS)
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
        control = make_prefill_step(cfg, impl=SimpleNamespace(**{
            **{k: getattr(plain, k) for k in plain.__all__},
            "attention": partial(plain.attention, chunk=128),
            "rwkv6": partial(plain.rwkv6, chunk=16),
            "mamba2": partial(plain.mamba2, chunk=64)}))(
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


def count_forward(torch, arch: str) -> dict:
    """One full-sequence forward of ``arch`` at full width and depth over 1
    x FWD_TOKENS tokens on the kernels: the launches of that forward alone
    are :func:`_launches`' (zamba2-7b: one grouped mamba2 a layer, one
    flash_attention a hybrid layer, on the tensor-core route), the logits
    finite.  The cell ``zamba2-7b.prefill-4k`` holds its outputs to the
    reference."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import family_module

    cfg = get_config(arch)
    params = family_module(cfg).init(cfg, seed=0, device="cuda")
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
        seconds = time.perf_counter() - t0
    launches = _read_launches()
    routes = dict(flash_attention.route_launches)
    want = _launches(cfg, "forward")
    require(launches == want,
            f"one {arch} forward launched {launches}, not {want}")
    require(routes["tc"] == launches["flash_attention"]
            and routes["simt"] == 0,
            f"the bfloat16 forward's attention took the routes {routes}")
    require(logits.shape == (1, FWD_TOKENS, cfg.vocab)
            and bool(torch.isfinite(logits).all()),
            f"{arch} logits {tuple(logits.shape)}, or not finite")
    print(f"{arch}: forward 1x{FWD_TOKENS} in {seconds:.3f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }, flash_attention "
          f"routes {routes}")
    del params, logits
    return launches


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
    per_decode = _launches(cfg, "decode")
    want = {k: n * pre[0] + per_decode[k] * dec[0]
            for k, n in _launches(cfg, "prefill").items()}
    require(launches == want, f"serving launched {launches}, not {want} "
            f"({pre[0]} prefills, {dec[0]} decode steps, each step "
            f"launching {per_decode})")
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


# -- the README's two commands, the quickstart ------------------------------

def run_two_commands(torch) -> None:
    import numpy as np

    from repro_torch.kernels import ops

    ops.reset_dispatch()
    committed = ops.configure(app="gemm_conv", db_path=DB_PATH)
    ops.reset_dispatch()
    require(bool(committed), f"{DB_PATH} holds no gemm_conv app")
    env = {**os.environ, "PYTHONPATH": str(SRC)}

    def run(cmd):
        print("$ " + " ".join(cmd[1:]), flush=True)
        res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=600)
        for line in res.stdout.splitlines()[-4:]:
            print("  " + line)
        require(res.returncode == 0, f"exited {res.returncode}: "
                f"{res.stderr[-2000:]}")
        return res.stdout

    out = run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
               "qwen3-8b", "--smoke", "--tuned-app", "gemm_conv",
               "--tuning-db", str(DB_PATH)])
    line = f"tuned kernel blocks installed: gemm={committed['gemm']}"
    require(line in out.splitlines(), f"serve did not print {line!r}")
    require("status: OK=6" in out, "the tuned serve did not end OK")
    print(f"  serve installed phase 4's blocks: {committed}")

    out = run([sys.executable, "examples/quickstart_torch.py"])
    m = re.search(r"max abs err vs the plain version (\S+)$", out, re.M)
    require(m is not None, "the quickstart printed no error")
    err = float(m.group(1))
    # the quickstart's operands (seeds 0 and 1): its tolerance at the
    # largest output
    a = np.random.default_rng(0).standard_normal((128, 96))
    b = np.random.default_rng(1).standard_normal((96, 64))
    rtol, atol = TOL["gemm"]["float32"]
    limit = atol + rtol * float(np.abs(a @ b).max())
    require(err <= limit, f"the quickstart's gemm err {err} > {limit}")
    print(f"  quickstart gemm max abs err {err:.3g} within {limit:.3g}")


# -- paged serving and MoE ----------------------------------------------------

def run_paged(torch, arch: str, pressure: bool = False) -> dict[str, int]:
    """Phase 17 (zamba2-2.7b: the ample run, then with ``pressure`` the
    page-pressure run) or phase 18's serving (granite-moe-3b-a800m: the
    ample run); returns the ample run's kernel launches."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.kernels import plain
    from repro_torch.launch.serve import Request, serve_requests
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import family_module
    from repro_torch.models.tree import leaves, tree_map

    cfg = get_config(arch)
    mod = family_module(cfg)
    t0 = time.perf_counter()
    params = mod.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    print(f"{arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B parameters in {cfg.dtype}, drawn on the "
          f"card in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated)")
    rng = np.random.default_rng(0)
    lo, hi = SERVE["prompt"]
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(lo, hi + 1)))
               for _ in range(SERVE["n"])]
    chunk = PAGED["prefill_chunk"]
    dense_pages = SERVE["slots"] * -(-SERVE["max_seq"] // PAGED["page_size"])
    telemetry = DB_PATH.parent / f"telemetry_{arch}.json"

    def serve(n_pages, sanitize):
        reqs = [Request(i, p, SERVE["max_new"]) for i, p in
                enumerate(prompts)]
        _read_launches(reset=True)
        st = obs.enable()
        t0 = time.perf_counter()
        done, stats = serve_requests(
            cfg, params, reqs, slots=SERVE["slots"],
            max_seq=SERVE["max_seq"], impl="cuda", paged=True,
            n_pages=n_pages, sanitize=sanitize, **PAGED)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = _read_launches()
        spans = {}
        for ev in st.tracer.events():
            if ev[0] == "X":
                n, sec = spans.get(ev[1], (0, 0.0))
                spans[ev[1]] = (n + 1, sec + ev[3] / 1e6)
        chunks = int(st.metrics.counter("serve.prefill_chunks").value)
        if not sanitize:
            obs.export_telemetry(telemetry)
        obs.disable()
        require([r.status for r in done] == ["OK"] * SERVE["n"],
                f"statuses {stats['status_counts']}")
        require(all(len(r.out) == SERVE["max_new"] for r in done),
                "a request ended short of max_new")
        pre, dec = spans["serve.prefill_chunk"], spans["serve.decode_step"]
        require(pre[0] == chunks, f"{pre[0]} chunk spans, {chunks} counted")
        ttft = stats["ttft_s"]
        print(f"pool {n_pages or dense_pages} pages of "
              f"{PAGED['page_size']} rows{', sanitized' if sanitize else ''}"
              f": {SERVE['n']} requests, {stats['generated']} tokens in "
              f"{dt:.3f} s: {stats['generated'] / dt:.2f} tokens/s; TTFT "
              f"p50 {ttft['p50']:.3f} s, p95 {ttft['p95']:.3f} s; "
              f"{stats['decode_steps']} decode steps, "
              f"{dec[1] / dec[0] * 1e3:.1f} ms each; {chunks} prefill "
              f"chunks, {pre[1] / pre[0] * 1e3:.1f} ms each; "
              f"{stats['preemptions']} preemptions; launches {launches}")
        return ({r.rid: list(r.out) for r in done}, stats, launches, chunks,
                dec[0])

    out, stats, launches, chunks, steps = serve(None, False)
    # no preemption in the ample pool: each prompt is prefilled once, in
    # ceil(n / chunk) chunks; a chunk of one token takes the decode step's
    # one-token path, which launches no recurrence kernel; the glue kernels
    # (zamba2's) run once a layer in every chunk and decode step
    sizes = [min(chunk, len(p) - s) for p in prompts
             for s in range(0, len(p), chunk)]
    require(stats["preemptions"] == 0, "the ample pool preempted")
    require(chunks == len(sizes), f"{chunks} chunks, not {len(sizes)}")
    multi = sum(n > 1 for n in sizes)
    per_step = _launches(cfg, "decode")
    # the kernel calls of the prompts' chunks alone (the checked re-run's)
    calls = {k: n * multi if not per_step[k] else n * len(sizes)
             for k, n in _launches(cfg, "prefill").items()}
    want = {k: n + per_step[k] * steps for k, n in calls.items()}
    require(launches == want, f"paged serving launched {launches}, not "
            f"{want} ({multi} chunks of more than one token, {len(sizes)} "
            f"in all, {steps} decode steps)")
    res = subprocess.run([sys.executable, "-m", "repro_torch.obs",
                          str(telemetry)], cwd=ROOT, capture_output=True,
                         text=True, env={**os.environ,
                                         "PYTHONPATH": str(SRC)})
    print("  " + (res.stdout.strip() or res.stderr.strip()))
    require(res.returncode == 0, "the telemetry export does not validate")
    doc = json.loads(telemetry.read_text())
    names = {ev["name"] for ev in doc["trace"]["events"]}
    require({"serve.prefill_chunk", "serve.decode_step"} <= names
            and "serve.prefill_chunks" in doc["metrics"]["counters"]
            and "serve.decode_batch" in doc["metrics"]["histograms"],
            "the export lacks the reference's span or metric names")

    # each first token against its own prefill, re-run batch-1 in the
    # engine's chunks, every kernel call of it held against its plain
    # version on the same inputs; and (zamba2) those logits against the
    # forward's, the kernels' beside the plain versions', and in float32
    lim = LIMITS.get(arch, {})

    def chunked(prm, p, impl):
        cache = mod.init_prefill_cache(cfg, 1, len(p), device="cuda",
                                       dtype=prm["embed"]["table"].dtype)
        for s in range(0, len(p), chunk):
            toks = torch.as_tensor(p[None, s:s + chunk], dtype=torch.int64,
                                   device="cuda")
            lp, cache = mod.decode_step(prm, cfg, cache, toks, [s],
                                        impl=impl)
        return lp[0, -1]

    def vs_forward(prm, impl):
        """Least cosine and argmax agreements of the chunked prefill
        against the full-sequence forward, both on ``impl``."""
        fwd = make_prefill_step(cfg, impl=impl)
        cos, agree = [], 0
        for p in prompts:
            lf = fwd(prm, {"tokens": torch.as_tensor(
                p[None], dtype=torch.int64, device="cuda")})
            cmp = _compare_logits(torch, chunked(prm, p, impl), lf[0, -1])
            cos.append(cmp["min_cosine"])
            agree += int(cmp["argmax_agree"])
        return cos, agree

    checked = _CheckedOps(torch)
    with torch.no_grad():
        for rid, p in enumerate(prompts):
            require(int(torch.argmax(chunked(params, p, checked)))
                    == out[rid][0], f"request {rid}: the engine's first "
                    f"token is not the argmax of its chunked prefill")
        print("  every first token is the argmax of its batch-1 chunked "
              "prefill")
        calls = {k: n for k, n in calls.items() if n}
        require({k: n for k, (n, _) in checked.worst.items()} == calls,
                f"the chunked prefill made {checked.worst}, not {calls} "
                f"checked kernel calls")
        for name, (n, err) in sorted(checked.worst.items()):
            print(f"  {name}: {n} calls on the prefill chunks' own inputs "
                  f"(state carried in), each within its {cfg.dtype} "
                  f"tolerance of the plain version (max abs err {err:.3g}; "
                  f"at most {checked.flips[name]:.3g} of a call's outputs "
                  f"rounded otherwise)")
        if "chunks" in lim:
            kcos, kagree = vs_forward(params, "cuda")
            pcos, pagree = vs_forward(params, plain)
            p32 = tree_map(lambda t: t.float(), params)
            fcos, fagree = vs_forward(p32, "cuda")
            del p32
            print(f"  chunked prefill vs the forward at the last position, "
                  f"cosine per request (same argmax): kernels "
                  f"{' '.join(f'{c:.6f}' for c in kcos)} ({kagree} of "
                  f"{len(prompts)}); the plain versions alike "
                  f"{' '.join(f'{c:.6f}' for c in pcos)} ({pagree}); "
                  f"float32 weights, kernels "
                  f"{' '.join(f'{c:.7f}' for c in fcos)} ({fagree})")
            kcos, fcos = min(kcos), min(fcos)
            require(kcos >= lim["chunks"], "the chunked prefill drifts from "
                    "the kernel forward")
            require(fcos >= lim["forward_f32"], "the float32 chunked "
                    "prefill drifts from the kernel forward")
    if pressure:
        # the page-pressure run: same tokens, through swap-out/swap-in
        tight, tstats, *_ = serve(PRESSURE_PAGES, True)
        require(tstats["preemptions"] >= 1,
                f"{PRESSURE_PAGES} pages never preempted")
        require(tight == out, "preemption changed a request's tokens")
        print(f"  the page-pressure run's tokens equal the ample run's "
              f"({tstats['preemptions']} preemptions, sanitizer on)")
    del params
    return {"launches": launches, "tokens": out,
            "chunks_multi": multi}


def check_moe(torch) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                              capacity_factor=1.0, dtype="float32")
    gen = torch.Generator().manual_seed(5)
    cpu = L.moe_init(gen, cfg, 1, torch.float32, "cpu")
    card = {k: v.cuda() for k, v in cpu.items()}
    rtol, atol = MOE_TOL
    for shape in ((1, 64), (4, 1), (1, 1024)):
        x = torch.randn(*shape, cfg.d_model, generator=gen)
        s = shape[1]
        cap = max(8, math.ceil(s * cfg.top_k / cfg.n_experts
                               * cfg.capacity_factor))
        route = [L._dispatch_group(
            xx, xx @ p["router"] + p["router_mask"], cfg.top_k, cap)[1:4]
            for xx, p in ((x, cpu), (x.cuda(), card))]
        for name, a, b in zip(("expert", "slot", "keep"), *route):
            require(torch.equal(a, b.cpu()), f"MoE {shape}: the card's "
                    f"{name} differs from the CPU's")
        with torch.no_grad():
            want = L.moe(cpu, cfg, x)
            got = L.moe(card, cfg, x.cuda()).cpu()
        scale = float(want.abs().max())
        err = _close(torch, got, want, rtol, atol * scale)
        dropped = int((route[0][2] == 0).sum())
        print(f"  moe (B, S) {shape}, d {cfg.d_model}, {cfg.n_experts} "
              f"experts, top-{cfg.top_k}, capacity {cap}: {dropped} of "
              f"{shape[0] * s * cfg.top_k} (token, expert) pairs dropped, "
              f"the same routing on both; max abs err {err:.3g} (max "
              f"|out| {scale:.3g}) within rtol {rtol}, atol {atol} x max")


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
    when ``shared``); weak decay a ~ -1e-3."""
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
        # the paged engine's prefill chunks of zamba2-2.7b (phase 17): 64
        # tokens and a tail, the state carried in from the last chunk
        (1, 64, 80, 64, 64, "weak", True, True),
        (1, 61, 80, 64, 64, "strong", True, True),
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
    # zamba2-7b's Mamba layers: b/c (B, T, G, N), head h reading group h //
    # (H / G), in one launch (each chunk's Gram once a group, two heads of
    # one group a pass-3 CTA), against the plain version, and the bits of
    # each head's group copied to it (both take one span plan on an H100)
    gen = torch.Generator(device="cuda").manual_seed(8)
    grouped = [
        # (B, T, H, P, N, groups, decay, state)
        (1, FWD_TOKENS, 112, 64, 64, 2, "weak", False),
        (1, FWD_TOKENS, 112, 64, 64, 2, "strong", True),
        # zamba2-2.7b's one group, as its Mamba layers pass it
        (1, FWD_TOKENS, 80, 64, 64, 1, "weak", False),
    ]
    sms = cuda_lib.sm_count(0)
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).removeprefix("torch.")
        bf16 = dtype == torch.bfloat16
        for b_, t, h, p, n, g, decay, state in grouped:
            x, a, _, _, s0 = _mamba2_inputs(torch, gen, b_, t, h, p, n, decay,
                                            state, True, dtype)
            bb, cc = ((_rand(torch, gen, b_, t, g, n, dtype=torch.float32)
                       * n ** -0.5).to(dtype) for _ in range(2))
            ins = (x, a, bb, cc, s0)
            before = mamba2.launches
            err, flips, _, _ = _check_recurrence(
                torch, mamba2, xla_linear.mamba2, ins, dt)
            require(mamba2.launches == before + 1,
                    "a grouped mamba2 call took more than one launch")
            require(mamba2_plan(b_, t, h, p, n, bf16, True, sms, g).spans
                    == mamba2_plan(b_, t, h, p, n, bf16, False, sms, h).spans,
                    f"mamba2 span plans differ at H{h} G{g}")
            got = mamba2(*ins)
            own = mamba2(x, a, bb.repeat_interleave(h // g, dim=2),
                         cc.repeat_interleave(h // g, dim=2), s0)
            require(all(torch.equal(g_, o_) for g_, o_ in zip(got, own)),
                    f"mamba2 grouped bits differ from per-head b/c at H{h} "
                    f"G{g} {dt}")
            print(f"  mamba2 {dt:8s} B{b_} T{t} H{h} P{p} N{n} b/c in {g} "
                  f"groups, {decay} decay, state {state} (one launch; same "
                  f"bits as per-head b/c): max abs err {err:.3g}" + (
                      "" if flips is None else
                      f", outputs rounded otherwise {flips:.3g}") + " ok")


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


def time_glue(torch, launches, rates, report) -> list[dict]:
    """The glue kernels at their cells' forward shapes, each checked against
    its plain version, timed back to back and replayed from a CUDA graph,
    its plain version timed, and its wrapper's host time a call: rwkv6's
    six at rwkv6-3b's (1 x 4096 tokens, D 2560, 40 heads of 64, channel mix
    8960), the Mamba layer's three at zamba2-7b's (1 x 4096 tokens, d 3584,
    112 heads of 64, two B/C groups of 64; the norm without a hybrid call's
    t, as 68 of its 81 layers run it), bfloat16; that norm is also timed
    as ``F.rms_norm``, the one library call that computes it.  Each call
    takes the next
    of enough input sets to exceed the 50 MB L2, so inputs come from HBM as
    in the forward.  Bytes: each input read once, each output written once
    (the weights' rows too).  ``report`` is phase 2's ptxas report: each
    row gives its kernel's spilled bytes."""
    import torch.nn.functional as F

    from repro_torch.kernels import mamba2_glue as M
    from repro_torch.kernels import plain
    from repro_torch.kernels import rwkv6_glue as G

    bw, _ = rates
    # the library's own call for a glue op, where one computes it
    library = {"mamba2_norm_in": lambda x, t, ln, eps: F.rms_norm(
        x, (x.shape[-1],), ln, eps)}
    gen = torch.Generator(device="cuda").manual_seed(11)
    bf = torch.bfloat16
    b, t, d, h, dh, f = 1, FWD_TOKENS, 2560, 40, 64, 8960

    def rnd(*shape, scale=1.0, shift=0.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                + shift).to(dtype)

    def sets(make, nbytes):
        """Input sets of ``nbytes`` each, enough to exceed the L2 twice."""
        return [make() for _ in range(max(2, -(-100_000_000 // nbytes)))]
    act = b * t * d * 2
    ln = rnd(d, scale=0.1, shift=1.0)
    # zamba2-7b's Mamba layer: in_proj's output [z | x | B | C | dt]
    zd, zh, gn = 3584, 112, 2 * 64
    hp, c = zh * 64, zh * 64 + 2 * gn
    zw = hp + c + zh
    zln, znorm = rnd(zd, scale=0.1, shift=1.0), rnd(hp, scale=0.1, shift=1.0)
    conv_w, conv_b = rnd(M.CONV_K, c, scale=0.3), rnd(c, scale=0.1)
    dt_bias = rnd(zh, scale=0.5, dtype=torch.float32)
    a_log = rnd(zh, scale=0.5, shift=1.0, dtype=torch.float32)
    d_skip = rnd(zh, scale=0.5, shift=1.0, dtype=torch.float32)
    zact = b * t * hp * 2
    specs = [
        # name, inputs maker, bytes read and written
        ("rwkv6_time_in", lambda: (rnd(b, t, d, scale=3.0), ln,
                                   rnd(5, d, scale=0.2, shift=0.5), None),
         act + 10 * d * 2 + 5 * act + b * d * 2),
        ("rwkv6_decay", lambda: (rnd(d, shift=-1.0), rnd(b, t, d), bf),
         d * 2 + 2 * act),
        ("rwkv6_head_out", lambda: (rnd(b, t, h, dh), rnd(h, dh, scale=0.1,
                                                          shift=1.0),
                                    rnd(b, t, h * dh, scale=2.0)),
         3 * act + h * dh * 2),
        ("rwkv6_channel_in", lambda: (rnd(b, t, d, scale=3.0), rnd(b, t, d),
                                      ln, rnd(2, d, scale=0.2, shift=0.5),
                                      None),
         2 * act + 6 * d * 2 + 3 * act + b * d * 2),
        ("rwkv6_relu2", lambda: (rnd(b, t, f, scale=3.0),), 2 * b * t * f * 2),
        ("rwkv6_channel_out", lambda: (rnd(b, t, d), rnd(b, t, d, scale=4.0),
                                       rnd(b, t, d)), 4 * act),
        ("mamba2_norm_in", lambda: (rnd(b, t, zd, scale=3.0), None, zln,
                                    1e-5), 2 * b * t * zd * 2 + zd * 2),
        ("mamba2_conv_in", lambda: (rnd(b, t, zw, scale=2.0), conv_w, conv_b,
                                    dt_bias, a_log, None, bf, 2),
         # x | B | C and dt read; xs, x_scaled, B, C, the decay and the
         # tail written
         b * t * (c + zh) * 2 + 5 * c * 2 + 2 * zh * 4
         + b * t * (2 * hp + 2 * gn + zh) * 2 + b * 3 * c * 2),
        ("mamba2_gate_out", lambda: (rnd(b, t, zh, 64), rnd(b, t, zh, 64),
                                     rnd(b, t, zw, scale=2.0)[..., :hp],
                                     d_skip, znorm, 2, 1e-5),
         4 * zact + hp * 2 + zh * 4),
    ]
    rows = []
    for name, make, nbytes in specs:
        ins = sets(make, nbytes)
        mod = M if name.startswith("mamba2_") else G
        kern, ref = getattr(mod, name), getattr(plain, name)
        err, _ = _check_glue(torch, name, ins[0], kern(*ins[0]))
        turn = iter(range(1 << 30))

        def call(fn):
            return lambda: fn(*ins[next(turn) % len(ins)])
        bound = nbytes / bw * 1e3
        spilled = [int(ln_.rsplit(", ", 1)[1].split()[0]) for ln_ in report
                   if ln_.startswith(name + "_kernel")]
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/csrc/{mod.__name__.rsplit('.')[-1]}"
                         f".cu",
               "replaces": "none (XLA fuses the expressions, "
                           + ("src/repro/models/zamba2.py)" if mod is M else
                              "src/repro/models/rwkv6.py:95-122)"),
               "launches": launches.get(name), "max_abs_err": err,
               "ms": _time_ms(torch, call(kern)),
               "ms_graph": _time_graph_ms(torch, call(kern),
                                          calls=2 * len(ins)),
               "plain_ms": _time_ms(torch, call(ref)),
               "host_ms": _host_ms(torch, call(kern)),
               "bound_ms": bound, "bound_by": "bytes",
               "library_ms": (_time_ms(torch, call(library[name]))
                              if name in library else None),
               "library": ("torch.nn.functional.rms_norm" if name in library
                           else "no single PyTorch call computes it"),
               "dtype": "bfloat16", "bytes": nbytes,
               "spilled_bytes": max(spilled) if spilled else None}
        row["bound_share"] = bound / row["ms_graph"]
        rows.append(row)
        del ins
    require(all(math.isfinite(r_["ms"]) for r_ in rows), "a timing failed")
    return rows


# -- training and resume (phase 19) -------------------------------------------

def _vjp_case(torch, shape, dtype):
    """One attention VJP case: the Function's (dq, dk, dv) on ``dtype``
    inputs, autograd through the same forward loop on those inputs, and
    autograd through the loop in float32 on the same values (the
    yardstick); with each run's peak memory above the inputs."""
    from repro_torch.kernels import xla_attention as XA

    b, sq, skv, h, hkv, d, cap, win = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    ins = [(_rand(torch, gen, b, sq, h, d, dtype=torch.float32)
            * FLASH_Q_STD).to(dtype),
           _rand(torch, gen, b, skv, hkv, d, dtype=dtype),
           _rand(torch, gen, b, skv, hkv, d, dtype=dtype),
           _rand(torch, gen, b, sq, h, d, dtype=dtype)]
    sc = d ** -0.5

    def run(fn, xs):
        q, k, v, do = [x.detach().requires_grad_(i < 3)
                       for i, x in enumerate(xs)]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads = torch.autograd.grad(fn(q, k, v), (q, k, v), do)
        return grads, torch.cuda.max_memory_allocated() - base

    function = lambda q, k, v: XA.attention(q, k, v, softcap=cap,
                                            window=win)
    loop = lambda q, k, v: XA._forward(q, k, v, True, cap, win, sc,
                                       XA.DEFAULT_CHUNK)[0].to(q.dtype)
    got, peak_fn = run(function, ins)
    same, peak_loop = run(loop, ins)
    f32, _ = run(loop, [x.float() for x in ins])
    return got, same, f32, peak_fn, peak_loop


def check_attention_vjp(torch) -> None:
    """Phase 19 (a): the attention Function's gradients on the card."""
    for name, shape in VJP_CASES.items():
        for dt in (torch.float32, torch.bfloat16):
            got, same, f32, peak_fn, peak_loop = _vjp_case(torch, shape, dt)
            readings = []
            for g_name, g, s_, w in zip(("dq", "dk", "dv"), got, same, f32):
                scale = float(w.abs().max())
                require(bool(torch.isfinite(g).all()),
                        f"attention VJP {name}: non-finite {g_name}")
                err = float((g.float() - w).abs().max()) / scale
                if dt == torch.float32:
                    err_same = float((g - s_).abs().max()) / scale
                    require(err_same <= VJP_TOL, f"attention VJP {name} "
                            f"float32: {g_name} {err_same:.3g} of its max "
                            f"from autograd through the loop > {VJP_TOL}")
                    readings.append(f"{g_name} {err_same:.3g}")
                else:
                    err_loop = float((s_.float() - w).abs().max()) / scale
                    require(err <= VJP_BF16_FACTOR * err_loop,
                            f"attention VJP {name} bfloat16: {g_name} "
                            f"{err:.3g} of its max from the float32 loop, "
                            f"> {VJP_BF16_FACTOR} x the bfloat16 loop's "
                            f"{err_loop:.3g}")
                    readings.append(f"{g_name} {err:.3g} (loop "
                                    f"{err_loop:.3g})")
            what = ("vs autograd through the loop" if dt == torch.float32
                    else "vs the float32 loop (the bfloat16 loop's own)")
            print(f"  attention VJP {name} {tuple(shape)} "
                  f"{str(dt).removeprefix('torch.')}: max err / max |grad| "
                  f"{what}: {', '.join(readings)}; peak memory "
                  f"{peak_fn / 1e6:.1f} MB (autograd through the loop "
                  f"{peak_loop / 1e6:.1f} MB)")
            del got, same, f32
    torch.cuda.empty_cache()


def check_train_step_vs_cpu(torch) -> None:
    """Phase 19 (b): step 0 of make_train_step on the card and on the CPU,
    reduced configs in float32, the same seeded params and batch."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import (make_loss_fn, make_train_step,
                                          value_and_grad)
    from repro_torch.launch.train import to_device
    from repro_torch.models import family_module, params_from_numpy, reduced
    from repro_torch.models.tree import leaves, tree_map
    from repro_torch.optim import AdamW, cosine_schedule

    for arch in ("zamba2-2.7b", "qwen3-8b"):
        cfg = reduced(get_config(arch), dtype="float32")
        host = tree_map(lambda t: t.numpy(),
                        family_module(cfg).init(cfg, seed=0, device="cpu"))
        batch = SyntheticLM(cfg.vocab, 64, 2, seed=0).batch(0)
        runs = {}
        for dev in ("cuda", "cpu"):
            params = params_from_numpy(host, device=dev)
            b = to_device(batch, dev, torch.float32)
            loss, grads = value_and_grad(make_loss_fn(cfg), params, b)
            if dev == "cuda":
                # the same call again: the same bits in every leaf (the
                # embedding's backward sums repeated ids in a fixed order)
                loss2, grads2 = value_and_grad(make_loss_fn(cfg), params, b)
                moved = [i for i, (a, b_) in enumerate(
                    zip(leaves(grads), leaves(grads2)))
                    if not torch.equal(a, b_)]
                require(torch.equal(loss, loss2) and not moved,
                        f"{arch}: value_and_grad twice on the card moved "
                        f"the loss or grad leaves {moved}")
                print(f"  {cfg.name}: value_and_grad twice on the card: the "
                      f"same bits in the loss and all "
                      f"{len(list(leaves(grads)))} grad leaves")
            opt = AdamW(lr=cosine_schedule(3e-3, warmup=5, total=8))
            params, _, m = make_train_step(cfg, opt)(params, opt.init(params),
                                                     b)
            runs[dev] = (float(loss), float(m["loss"]),
                         [g.cpu() for g in leaves(grads)],
                         [p.cpu() for p in leaves(params)])
        (l_card, m_card, g_card, p_card), (l_cpu, m_cpu, g_cpu, p_cpu) = \
            runs["cuda"], runs["cpu"]
        rel = abs(l_card - l_cpu) / abs(l_cpu)
        require(rel <= TRAIN_CPU_TOL["loss"] and m_card == l_card,
                f"{arch} step-0 loss card {l_card} vs CPU {l_cpu}")
        worst = {}
        for what, card, cpu in (("grad", g_card, g_cpu),
                                ("param", p_card, p_cpu)):
            errs = [float((a - b_).abs().max())
                    / max(float(b_.abs().max()), 1e-30)
                    for a, b_ in zip(card, cpu)]
            worst[what] = max(errs)
            require(worst[what] <= TRAIN_CPU_TOL["grad"],
                    f"{arch}: a {what} leaf {worst[what]:.3g} of its max "
                    f"from the CPU's > {TRAIN_CPU_TOL['grad']}")
        print(f"  {cfg.name} float32 step 0, card vs CPU: loss {l_card:.6f}"
              f" vs {l_cpu:.6f} (rel {rel:.3g}); worst leaf / its max: grads"
              f" {worst['grad']:.3g}, updated params {worst['param']:.3g} "
              f"({len(g_card)} leaves)")


def run_full_width_training(torch) -> dict:
    """Phase 19 (c): zamba2-2.7b at full width and depth takes AdamW steps
    over SyntheticLM batches through Prefetcher, with the trainer's own
    pieces and no checkpoint."""
    from repro_torch.configs import get_config
    from repro_torch.data import Prefetcher, SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import to_device
    from repro_torch.models import family_module
    from repro_torch.models.tree import leaves
    from repro_torch.optim import AdamW, cosine_schedule

    t = TRAIN_FULL
    cfg = get_config(t["arch"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = family_module(cfg).init(cfg, seed=0, device="cuda")
    opt = AdamW(lr=cosine_schedule(t["peak_lr"], warmup=t["warmup"],
                                   total=t["steps"]))
    state = opt.init(params)
    nbytes = lambda tree: sum(x.numel() * x.element_size()
                              for x in leaves(tree))
    n_params = sum(x.numel() for x in leaves(params))
    # the grads take the params' bytes: the whole state is params twice
    state_bytes = {"params": nbytes(params), "grads": nbytes(params),
                   "m": nbytes(state.m), "v": nbytes(state.v)}
    print(f"  {cfg.name}: {cfg.n_layers} Mamba-2 layers, d {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B parameters ({cfg.dtype} with float32 "
          f"leaves); state " + ", ".join(
              f"{k} {v / 1e9:.2f} GB" for k, v in state_bytes.items())
          + f": {sum(state_bytes.values()) / 1e9:.2f} GB")
    data = SyntheticLM(cfg.vocab, t["seq_len"], t["batch"], seed=0)
    fetch = Prefetcher(data.batch)
    step_fn = make_train_step(cfg, opt)
    _read_launches(reset=True)
    losses, norms, times = [], [], []
    for step in range(t["steps"]):
        got_step, host = fetch.get()
        require(got_step == step, f"prefetcher gave step {got_step}")
        batch = to_device(host, "cuda", getattr(torch, cfg.dtype))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        losses.append(loss)
        norms.append(gnorm)
        times.append(dt)
        tokens = t["seq_len"] * t["batch"]
        print(f"  step {step}  loss {loss:.4f}  grad norm {gnorm:.4f}  "
              f"{dt * 1e3:.1f} ms  {tokens / dt:.0f} tokens/s", flush=True)
    launches = {k: v for k, v in _read_launches().items()
                if k in ("flash_attention", "rwkv6", "mamba2")}
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak memory {peak / 1e9:.2f} GB (limit "
          f"{TRAIN_PEAK_LIMIT / 1e9:.0f}); kernel launches {launches}"
          f"; steps 1-{t['steps'] - 1} median "
          f"{sorted(times[1:])[len(times[1:]) // 2] * 1e3:.1f} ms")
    for name in ("flash_attention", "rwkv6", "mamba2"):
        require(launches[name] == 0, f"training launched {name}")
    require(all(math.isfinite(x) for x in losses + norms),
            f"non-finite loss or grad norm: {losses}, {norms}")
    require(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    require(peak < TRAIN_PEAK_LIMIT, f"peak memory {peak / 1e9:.2f} GB")
    # phase 21 (d) holds the dry run's argument bytes to these
    step_bytes, batch_bytes = nbytes(state.step), nbytes(batch)
    del params, state, m
    torch.cuda.empty_cache()
    return {"losses": losses, "ms": [x * 1e3 for x in times], "peak": peak,
            "state_bytes": state_bytes, "step_bytes": step_bytes,
            "batch_bytes": batch_bytes}


def _ckpt_bytes(ckdir: Path, step: int) -> dict[str, bytes]:
    """{leaf key: its .npy bytes} of the checkpoint at ``step``."""
    d = ckdir / f"step-{step:012d}"
    manifest = json.loads((d / "manifest.json").read_text())["leaves"]
    return {k: (d / e["file"]).read_bytes() for k, e in manifest.items()}


def run_train_cli(torch) -> None:
    """Phase 19 (d): the train CLI on the card (reduced configs): failure
    injection then resume from step 4, ending on the uninterrupted run's
    checkpoint bits with and without grad compression; and grad
    compression on granite-moe."""
    ck = ROOT / "artifacts" / "chip_smoke" / "train_ckpt"
    if ck.exists():
        shutil.rmtree(ck)
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    common = ["--arch", "qwen3-8b", "--smoke", "--steps", "12",
              "--checkpoint-every", "4", "--checkpoint-dir", str(ck)]

    def start(args):
        cmd = [sys.executable, "-m", "repro_torch.launch.train", *args]
        print("$ " + " ".join(cmd[1:]), flush=True)
        return subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE)

    def finish(proc):
        out, err = proc.communicate(timeout=600)
        for line in out.splitlines()[-3:]:
            print("  " + line)
        return proc.returncode, out, err

    comp = [*common[:-1], str(ck / "ef"), "--grad-compression"]
    whole = [*common[:-1], str(ck / "whole")]
    whole_comp = [*common[:-1], str(ck / "whole_ef"), "--grad-compression"]
    # the failing runs, the uninterrupted ones and the compressed granite
    # run are independent: together
    inject = [start(a + ["--inject-failure-at", "6"]) for a in (common,
                                                                 comp)]
    others = [start(a) for a in (whole, whole_comp)]
    moe = start(["--arch", "granite-moe-3b-a800m", "--smoke", "--steps", "4",
                 "--checkpoint-dir", str(ck / "moe"), "--grad-compression"])
    for proc in inject:
        rc, out, err = finish(proc)
        require(rc != 0 and "injected failure at step 6" in out + err,
                f"the injected run exited {rc} without its failure: "
                f"{err[-2000:]}")
    for proc in others + [moe]:
        rc, out, err = finish(proc)
        require(rc == 0, f"a train run exited {rc}: {err[-2000:]}")
    for proc in [start(common), start(comp)]:
        rc, out, err = finish(proc)
        require(rc == 0, f"the resumed run exited {rc}: {err[-2000:]}")
        require("resumed from checkpoint step 4" in out and "step   11" in out,
                "the rerun did not resume from step 4 and reach step 11")
    name = "qwen3-8b-smoke"
    for resumed, uninterrupted, what in ((ck, ck / "whole", "plain"),
                                         (ck / "ef", ck / "whole_ef",
                                          "--grad-compression")):
        got = _ckpt_bytes(resumed / name, 11)
        want = _ckpt_bytes(uninterrupted / name, 11)
        moved = sorted(k for k in want if got.get(k) != want[k])
        require(set(got) == set(want) and not moved,
                f"{what}: the resumed run's step-11 checkpoint differs from "
                f"the uninterrupted run's in {moved[:5]}")
        print(f"  {what}: the crashed-and-resumed run's step-11 checkpoint "
              f"has the uninterrupted run's bytes in all {len(want)} leaves")


def run_codesign_resume(torch) -> None:
    """Phase 19 (e): the measured co-design flow on the card, checkpointed
    once per intrinsic, its newest payload deleted, then resumed."""
    import numpy as np

    from repro_torch.ft import CheckpointManager
    from repro_torch.kernels import KERNELS
    from repro_torch.tuner import __main__ as tuner

    ck = ROOT / "artifacts" / "chip_smoke" / "codesign_ckpt"
    for path in (ck, RESUME_DB):
        if path.exists():
            shutil.rmtree(path) if path.is_dir() else path.unlink()
    flags = RESUME_APP + ["--measure", "--backend", "cuda", "--trials", "6",
                          "--init", "3", "--db", str(RESUME_DB)]
    reports, at_payload = [], []
    codesign, save_payload = tuner.codesign, CheckpointManager.save_payload

    def spy(*args, **kwargs):
        reports.append(codesign(*args, **kwargs))
        return reports[-1]

    def spy_save(self, step, obj):
        # every kernel's launches when this round's payload was written
        at_payload.append({k.__name__: k.launches for k in KERNELS})
        return save_payload(self, step, obj)

    tuner.codesign, CheckpointManager.save_payload = spy, spy_save
    try:
        runs = []
        for extra in (["--checkpoint-dir", str(ck)], ["--resume", str(ck)]):
            print("$ python -m repro_torch.tuner " + " ".join(flags + extra),
                  flush=True)
            _read_launches(reset=True)
            require(tuner.main(flags + extra) == 0, "the tuner failed")
            runs.append(_read_launches())
            if extra[0] == "--checkpoint-dir":
                steps = CheckpointManager(ck).payload_steps()
                require(steps == [1, 2], f"payload steps {steps}, not [1, 2]")
                (ck / "state-000000000002.pkl").unlink()
    finally:
        tuner.codesign, CheckpointManager.save_payload = codesign, save_payload
    first, resumed = reports
    # the DOT round's launches in the first run: after its GEMM payload
    dot_round = {k: runs[0][k] - at_payload[0][k] for k in runs[0]}
    print(f"  first run launches {runs[0]} (GEMM round {at_payload[0]}, "
          f"DOT round {dot_round}); resumed run {runs[1]}")
    for name in ("GEMM", "DOT"):
        for label, rep in (("first", first), ("resumed", resumed)):
            summ = rep.measured[name]
            print(f"  {label} {name}: best measured total "
                  f"{summ['best_measured_total_s'] * 1e3:.4f} ms over "
                  f"{summ['measured']} points")
    require(runs[1] == dot_round and 0 < runs[1]["gemm"] < runs[0]["gemm"],
            f"the resumed run launched {runs[1]}, not the DOT round's "
            f"{dot_round}: the GEMM round was not restored")
    require(resumed.measured["GEMM"] == first.measured["GEMM"],
            "the restored GEMM measured summary differs")
    # the analytical search is deterministic: the restored GEMM round and
    # the re-run DOT round explored the first run's points exactly
    for name in ("GEMM", "DOT"):
        a, b = first.per_intrinsic[name], resumed.per_intrinsic[name]
        require([c.encode() for c in a.configs] ==
                [c.encode() for c in b.configs] and np.array_equal(a.ys, b.ys),
                f"the resumed {name} round explored other points")
    # each round commits the best measured of its top-k feasible candidates
    # (analytical order); the DOT round's were timed again, and candidates
    # that run one kernel geometry rank by host noise, so the commit must
    # be one of that round's candidates, not the first run's own pick
    sol = resumed.solution
    res = resumed.per_intrinsic[sol.intrinsic]
    order = np.argsort(res.ys[:, 0])[:3]
    require(sol.hw.encode() in [res.configs[i].encode() for i in order],
            f"the resumed run committed {sol.describe()}, not one of its "
            f"round's candidates")
    same = (sol.intrinsic, sol.hw.encode(), sorted(sol.schedules.items())) \
        == (first.solution.intrinsic, first.solution.hw.encode(),
            sorted(first.solution.schedules.items()))
    print(f"  both runs explored the same points; resumed commit "
          f"{sol.describe()}; the same as the first run's: {same}")


def run_training(torch) -> dict:
    """Phase 19; returns (c)'s state bytes and peak for phase 21 (d)."""
    t0 = time.perf_counter()
    check_attention_vjp(torch)
    check_train_step_vs_cpu(torch)
    full = run_full_width_training(torch)
    run_train_cli(torch)
    run_codesign_resume(torch)
    print(f"  phase 19 took {time.perf_counter() - t0:.1f} s")
    return full


# -- phase 20: distributed on the one card ------------------------------------

def _zamba_prompts(cfg):
    import numpy as np
    rng = np.random.default_rng(0)       # phase 17's requests
    lo, hi = SERVE["prompt"]
    return [rng.integers(0, cfg.vocab, size=int(rng.integers(lo, hi + 1)))
            for _ in range(SERVE["n"])]


def _serve_paged(torch, cfg, params, mesh=None, impl="cuda",
                 n: int = SERVE["n"]) -> dict:
    """Phase 17's ample paged run (no trace) on ``params``, its first ``n``
    requests: the tokens, tokens/s, launches and the collectives' calls
    and seconds."""
    from repro_torch.distributed import local
    from repro_torch.launch.serve import Request, serve_requests

    reqs = [Request(i, p, SERVE["max_new"])
            for i, p in enumerate(_zamba_prompts(cfg)[:n])]
    _read_launches(reset=True)
    local.STATS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done, stats = serve_requests(
        cfg, params, reqs, slots=SERVE["slots"], max_seq=SERVE["max_seq"],
        impl=impl, paged=True, mesh=mesh, **PAGED)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    require([r.status for r in done] == ["OK"] * n,
            f"statuses {stats['status_counts']}")
    return {"tokens": {r.rid: list(r.out) for r in done},
            "tok_s": stats["generated"] / dt, "seconds": dt,
            "launches": _read_launches(),
            "collectives": {k: list(v) for k, v in local.STATS.items()}}


def _collectives(stats: dict) -> str:
    return ", ".join(f"{k} {n} calls {sec:.3f} s" for k, (n, sec, *_) in
                     sorted(stats.items())) or "none"


def phase20_rank() -> int:
    """One rank of phase 20 (b) and (c): ``chip_smoke.py --phase20-rank``,
    two of them started by ``run_distributed`` on the one card.  Prints
    its readings as one JSON object on its last line."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_host_mesh

    require(torch.cuda.is_available(), "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed("cuda")
    res = {"rank": dist.get_rank(), "backend": dist.get_backend(),
           "part_seconds": {}}
    mesh = make_host_mesh(tp=2, device="cuda")
    for part, run in (("qwen3", lambda: _rank_qwen3(torch, mesh)),
                      ("zamba2", lambda: _rank_zamba2(torch, mesh)),
                      ("train", lambda: _rank_train(
                          torch, make_host_mesh(tp=1, device="cuda")))):
        t0 = time.perf_counter()
        res[part] = run()
        torch.cuda.empty_cache()
        res["part_seconds"][part] = time.perf_counter() - t0
    dist.destroy_process_group()
    print(json.dumps(res))
    return 0


def _rank_qwen3(torch, mesh) -> dict:
    """(b) qwen3-8b's full-sequence forward over phase 7's 1 x 4096 tokens
    on a model=2 mesh: H 16 / KV 4 a rank."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import local
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.steps import make_prefill_step, shard_params
    from repro_torch.models import family_module

    cfg = get_config("qwen3-8b")
    whole = family_module(cfg).init(cfg, seed=0, tp=2, device="cuda")
    params = shard_params(cfg, whole, mesh)
    del whole
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(3)   # phase 7's
    tokens = torch.randint(0, cfg.vocab, (1, FWD_TOKENS), generator=gen,
                           device="cuda")
    step = make_prefill_step(cfg, impl="cuda", mesh=mesh)
    out = {"heads": params["layers"]["all"]["attn"]["wq"].shape[-1]
           // cfg.head_dim,
           "kv_heads": params["layers"]["all"]["attn"]["wk"].shape[-1]
           // cfg.head_dim}
    with torch.no_grad():
        step(params, {"tokens": tokens[:, :256]})          # warm-up
        torch.cuda.synchronize()
        _read_launches(reset=True)
        local.STATS.clear()
        t0 = time.perf_counter()
        logits = step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t0
        out["launches"] = _read_launches()
        out["routes"] = dict(flash_attention.route_launches)
        out["collectives"] = {k: list(v) for k, v in local.STATS.items()}
        checked = _CheckedOps(torch)
        make_prefill_step(cfg, impl=checked, mesh=mesh)(
            params, {"tokens": tokens})
        out["checked"] = list(checked.worst["attention"])
        if dist.get_rank() == 0:
            cmp = _compare_logits(torch, logits, torch.load(QWEN_LOGITS)
                                  .to("cuda"))
            out["vs_single"] = {k: cmp[k] for k in (
                "min_cosine", "argmax_agree", "max_abs_err",
                "worst_position")}
    return out


def _tp_zamba_cfg():
    """zamba2-2.7b, whole, in float32."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("zamba2-2.7b"), dtype="float32")


def _rank_zamba2(torch, mesh) -> dict:
    """(b) zamba2-2.7b in float32 on the paged engine at model=2 (40 SSD
    heads, 16 attention heads a rank), the first TP_ZAMBA_REQUESTS of phase
    17's requests; rank 0 first serves them on the whole params without a
    mesh."""
    import torch.distributed as dist

    from repro_torch.models import family_module

    cfg = _tp_zamba_cfg()
    whole = family_module(cfg).init(cfg, seed=0, tp=2, device="cuda")
    out = {"single": None}
    if dist.get_rank() == 0:
        single = _serve_paged(torch, cfg, whole, n=TP_ZAMBA_REQUESTS)
        out["single"] = {k: single[k] for k in ("tokens", "tok_s",
                                                 "launches")}
    dist.barrier()
    got = _serve_paged(torch, cfg, whole, mesh=mesh, n=TP_ZAMBA_REQUESTS)
    checked = _CheckedOps(torch)
    again = _serve_paged(torch, cfg, whole, mesh=mesh, impl=checked,
                         n=TP_ZAMBA_REQUESTS)
    out.update(tokens=got["tokens"], tok_s=got["tok_s"],
               launches=got["launches"], collectives=got["collectives"],
               checked_tokens=again["tokens"] == got["tokens"],
               checked=list(checked.worst["mamba2"]))
    return out


def _rank_train(torch, mesh) -> dict:
    """(c) a reduced zamba2-2.7b train step, float32, each rank taking half
    the global batch, against one process on the whole batch; then (d)'s
    save: the ZeRO-1 state checkpointed whole from the two ranks."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import local
    from repro_torch.ft import CheckpointManager
    from repro_torch.launch.steps import (make_loss_fn, make_train_step,
                                          shard_params, value_and_grad)
    from repro_torch.launch.train import to_device
    from repro_torch.models import family_module, reduced
    from repro_torch.models.tree import leaves, tree_map
    from repro_torch.optim import AdamW, OptState

    t = DP_TRAIN
    cfg = reduced(get_config(t["arch"]), dtype="float32")
    mod = family_module(cfg)
    specs, segs = mod.specs(cfg), mod.compute_segments(cfg, 1)
    whole = mod.init(cfg, seed=0, device="cuda")
    data = SyntheticLM(cfg.vocab, t["seq"], t["batch"], seed=0)
    full = to_device(data.batch(0), "cuda", torch.float32)
    mine = to_device(data.global_arrays(0, mesh), "cuda", torch.float32)
    loss_fn = make_loss_fn(cfg)
    l0, g0 = value_and_grad(loss_fn, whole, full)
    ax = local.mesh_axis(mesh, "data")
    local.STATS.clear()
    t0 = time.perf_counter()
    l1, g1 = value_and_grad(loss_fn, whole, mine)
    l1 = local.all_reduce(l1, ax.group) / ax.size
    g1 = tree_map(lambda g: local.all_reduce(g, ax.group) / ax.size, g1)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0

    def worst(a, b):
        return max(float((x - y).abs().max()) / max(float(y.abs().max()),
                                                     1e-30)
                   for x, y in zip(leaves(a), leaves(b)))

    pa = tree_map(torch.clone, whole)
    oa = AdamW(lr=t["lr"])
    pa, sa, _ = make_train_step(cfg, oa)(pa, oa.init(pa), full)
    ob = AdamW(lr=t["lr"]).shard(mesh, specs, segs)
    pb = shard_params(cfg, tree_map(torch.clone, whole), mesh)
    sb = ob.init(pb)
    halves = sum(int(m.numel() * 2 == p.numel())
                 for m, p in zip(leaves(sb.m), leaves(pb)))
    pb, sb, mb = make_train_step(cfg, ob, mesh=mesh)(pb, sb, mine)
    out = {"loss": float(l0), "loss_rel": float(abs(l1 - l0) / abs(l0)),
           "grad": worst(g1, g0),
           "params": max(float((x - y).abs().max())
                         for x, y in zip(leaves(pb), leaves(pa))),
           "m": worst(ob.gather_moments(sb.m), sa.m),
           "v": worst(ob.gather_moments(sb.v), sa.v),
           "halves": halves, "leaves": len(list(leaves(pb))),
           "seconds": sec,
           "collectives": {k: list(v) for k, v in local.STATS.items()}}
    # (d): the two ranks' state saved whole (rank 0 writes), each rank's
    # ZeRO-1 slices of m kept beside it for the one-rank restore
    shapes = tree_map(lambda x: x.to("meta"), whole)
    state = OptState(sb.step, local.full_params(ob.gather_moments(sb.m),
                                                specs, mesh, shapes, segs),
                     local.full_params(ob.gather_moments(sb.v), specs,
                                       mesh, shapes, segs))
    CheckpointManager(DIST_DIR / "ckpt").save(
        1, (local.full_params(pb, specs, mesh, shapes, segs), state))
    torch.save({"m": tree_map(lambda x: x.cpu(), sb.m),
                "params": tree_map(lambda x: x.cpu(), pb)},
               DIST_DIR / f"rank{dist.get_rank()}.pt")
    return out


def run_distributed(torch, paged17: dict, fwd_seconds: dict) -> dict:
    """Phase 20: (a) a one-rank NCCL mesh, (b) and (c) two ranks on the
    card (``phase20_rank``), (d) the two ranks' checkpoint restored onto
    the one-rank mesh.  Returns each kernel's launches a rank at (b)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import local
    from repro_torch.distributed.sharding import zero1_specs
    from repro_torch.ft import CheckpointManager
    from repro_torch.launch.mesh import make_host_mesh, rank_json, run_ranks
    from repro_torch.models import family_module, reduced
    from repro_torch.optim import AdamW

    t_all = time.perf_counter()
    if DIST_DIR.exists():
        shutil.rmtree(DIST_DIR)
    DIST_DIR.mkdir(parents=True)
    # (a) the one-rank mesh: NCCL, data=1, model=1
    mesh1 = make_host_mesh(device="cuda")
    print(f"(a) one-rank mesh {mesh1.mesh_dim_names} "
          f"{tuple(mesh1.mesh.shape)}, backend {dist.get_backend()}")
    require(dist.get_backend() == "nccl", "the one-rank mesh is not NCCL")
    cfg = get_config("zamba2-2.7b")
    params = family_module(cfg).init(cfg, seed=0, device="cuda")
    bare = _serve_paged(torch, cfg, params)
    meshed = _serve_paged(torch, cfg, params, mesh=mesh1)
    del params
    torch.cuda.empty_cache()
    require(bare["tokens"] == paged17["tokens"],
            "the mesh-less engine's tokens are not phase 17's")
    require(meshed["tokens"] == bare["tokens"],
            "the one-rank mesh changed a token")
    require(meshed["launches"] == bare["launches"],
            f"the one-rank mesh launched {meshed['launches']}, not "
            f"{bare['launches']}")
    print(f"  zamba2-2.7b paged, phase 17's requests: the one-rank mesh's "
          f"tokens equal the engine's without a mesh (and phase 17's), "
          f"bit for bit; {meshed['tok_s']:.2f} tokens/s on the mesh, "
          f"{bare['tok_s']:.2f} without; collectives "
          f"{_collectives(meshed['collectives'])}")

    # (b), (c): two ranks on the one card
    t0 = time.perf_counter()
    procs = run_ranks([str(ROOT / "chip_smoke.py"), "--phase20-rank"], 2,
                      DIST_DIR / "ranks", timeout=900)
    for r, p in enumerate(procs):
        for line in p.stderr.strip().splitlines()[-5:]:
            print(f"  [rank {r}] {line}")
        require(p.returncode == 0, f"rank {r} exited {p.returncode}: "
                f"{p.stderr[-3000:]}")
    ranks = [rank_json(p) for p in procs]
    print(f"(b) two ranks on the card: {time.perf_counter() - t0:.1f} s "
          f"for both processes, backend {ranks[0]['backend']} (NCCL refuses "
          f"two ranks on one card), which took the CUDA tensors of every "
          f"all-reduce, all-gather and broadcast as they are (no host "
          f"staging); rank 0's parts {ranks[0]['part_seconds']} s")
    require(all(r["backend"] == "gloo" for r in ranks),
            "two ranks on one card did not run gloo")
    q0 = ranks[0]["qwen3"]
    for r, res in enumerate(ranks):
        q = res["qwen3"]
        require((q["heads"], q["kv_heads"]) == (16, 4),
                f"rank {r}: qwen3-8b ran {q['heads']}/{q['kv_heads']} heads")
        require(q["launches"]["flash_attention"] == 36
                and q["routes"]["tc"] == 36 and q["routes"]["simt"] == 0,
                f"rank {r}: flash_attention {q['launches']} routes "
                f"{q['routes']}, not 36 on the tensor-core route")
        require(q["checked"][0] == 36, f"rank {r}: {q['checked'][0]} "
                f"checked attention calls, not 36")
        print(f"  rank {r}: qwen3-8b model=2 forward 1x{FWD_TOKENS} at H "
              f"{q['heads']} / KV {q['kv_heads']}: {q['seconds']:.3f} s "
              f"({FWD_TOKENS / q['seconds']:.0f} tokens/s; phase 7 single "
              f"device {fwd_seconds['qwen3-8b']:.3f} s, "
              f"{FWD_TOKENS / fwd_seconds['qwen3-8b']:.0f} tokens/s); "
              f"launches {q['launches']}, routes {q['routes']}; 36 "
              f"attention calls each within its bfloat16 tolerance of the "
              f"plain version (max abs err {q['checked'][1]:.3g}); "
              f"collectives {_collectives(q['collectives'])}")
    v = q0["vs_single"]
    print(f"  model=2 logits vs phase 7's single-device kernel forward: min "
          f"cosine {v['min_cosine']:.6f} (at position {v['worst_position']})"
          f", argmax agrees at {v['argmax_agree']:.4f}, max abs err "
          f"{v['max_abs_err']:.4g}")
    require(v["min_cosine"] >= TP_FWD_COSINE,
            f"the model=2 forward drifts from the single-device one "
            f"({v['min_cosine']:.6f} < {TP_FWD_COSINE})")

    z0 = ranks[0]["zamba2"]
    single = z0["single"]
    zcfg = _tp_zamba_cfg()
    multi = sum(min(PAGED["prefill_chunk"], len(p) - s_) > 1
                for p in _zamba_prompts(zcfg)[:TP_ZAMBA_REQUESTS]
                for s_ in range(0, len(p), PAGED["prefill_chunk"]))
    want = zcfg.n_layers * multi
    for r, res in enumerate(ranks):
        z = res["zamba2"]
        require(z["tokens"] == single["tokens"],
                f"rank {r}: the model=2 float32 tokens differ from the "
                f"single-device engine's")
        require(z["checked_tokens"], f"rank {r}: the checked run's tokens "
                f"differ")
        require(z["launches"]["mamba2"] == want and z["checked"][0] == want,
                f"rank {r}: {z['launches']['mamba2']} mamba2 launches, "
                f"{z['checked'][0]} checked, not {want}")
        print(f"  rank {r}: zamba2-2.7b float32 paged at model=2 (40 SSD "
              f"heads, 16 attention heads): the first {TP_ZAMBA_REQUESTS} of "
              f"phase 17's {SERVE['n']} requests x {SERVE['max_new']} "
              f"tokens, every token the single-device engine's on the same "
              f"requests; "
              f"{z['tok_s']:.2f} tokens/s (single device "
              f"{single['tok_s']:.2f}); mamba2 {z['launches']['mamba2']} "
              f"launches ({zcfg.n_layers} layers x {multi} chunks), each "
              f"within its float32 tolerance of the plain version in the "
              f"checked run (max abs err {z['checked'][1]:.3g}); "
              f"collectives {_collectives(z['collectives'])}")

    for r, res in enumerate(ranks):
        t = res["train"]
        print(f"(c) rank {r}: reduced {DP_TRAIN['arch']} float32, "
              f"{DP_TRAIN['batch'] // 2} of {DP_TRAIN['batch']} rows x "
              f"{DP_TRAIN['seq']} tokens a rank: loss {t['loss']:.6f}, rel "
              f"diff {t['loss_rel']:.3g}; worst leaf / its max: grads "
              f"{t['grad']:.3g}, ZeRO-1 step m {t['m']:.3g}, v "
              f"{t['v']:.3g}; params max abs diff {t['params']:.3g} (lr "
              f"{DP_TRAIN['lr']}); moments halved in "
              f"{t['halves']} of {t['leaves']} leaves; grads + all-reduce "
              f"{t['seconds'] * 1e3:.1f} ms, collectives "
              f"{_collectives(t['collectives'])}")
        require(t["loss_rel"] <= DP_TOL["loss"], "the DP loss drifts")
        for k in ("grad", "m", "v"):
            require(t[k] <= DP_TOL["grad"], f"the DP {k} drifts: {t[k]}")
        require(t["params"] <= DP_TOL["param_updates"] * DP_TRAIN["lr"],
                f"the DP step's params drift: {t['params']}")
        require(t["halves"] > 0, "no moment is sharded over 'data'")

    # (d) the two ranks' checkpoint onto the one-rank mesh
    t0 = time.perf_counter()
    cfg = reduced(get_config(DP_TRAIN["arch"]), dtype="float32")
    mod = family_module(cfg)
    specs = mod.specs(cfg)
    like_p = mod.init(cfg, seed=0, device="cuda")
    got_p, got_s = CheckpointManager(DIST_DIR / "ckpt").restore(
        1, like=(like_p, AdamW().init(like_p)), mesh=mesh1,
        specs=(zero1_specs(specs), AdamW.init_specs(specs)))
    slices = [torch.load(DIST_DIR / f"rank{r}.pt") for r in range(2)]
    n = 0

    def same(restored, want):
        nonlocal n
        n += 1
        whole = local.full_tensor(restored).cpu()
        require(torch.equal(whole, want), "a restored leaf differs")

    def walk(a, b, c=None):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], None if c is None else c[k])
        elif c is None:
            same(a, b)
        else:       # ZeRO-1: the two ranks' slices along the cut dim
            dim = next((i for i, (x, y) in enumerate(zip(b.shape, a.shape))
                        if x != y), None)
            same(a, b if dim is None else torch.cat([b, c], dim))
    walk(got_p, slices[0]["params"])
    walk(got_s.m, slices[0]["m"], slices[1]["m"])
    print(f"(d) the two-rank checkpoint restored onto the one-rank mesh "
          f"as DTensors: {n} leaves with the values the ranks held (the "
          f"ZeRO-1 moments the two ranks' slices joined) in "
          f"{time.perf_counter() - t0:.2f} s")
    QWEN_LOGITS.unlink(missing_ok=True)
    dist.destroy_process_group()
    print(f"  phase 20 took {time.perf_counter() - t_all:.1f} s")
    return {"flash_attention": q0["launches"]["flash_attention"],
            "mamba2": z0["launches"]["mamba2"]}


# -- phase 21: analysis and the dry run -----------------------------------------

# (b): the serving programs at phases 8 and 17's sizes: 4 slots of 2048
# rows at ragged positions (each slot's pages mapped under its rows, in
# phase 17's pages of 16), one 1024-token prompt (phase 8's longest)
AUDIT_POS = (1024, 517, 130, 2000)
AUDIT_PROMPT = 1024
AUDIT_ARCHS = ("zamba2-2.7b", "qwen3-8b")
# (c): the dry-run cells on the production meshes (tag, arch, shape, flags);
# qwen3-8b x train_4k in the FSDP layout (the default) and in ZeRO-1's
DRYRUN_CELLS = (("qwen3-8b", "qwen3-8b", "train_4k", ()),
                ("qwen3-8b_zero1", "qwen3-8b", "train_4k",
                 ("--mode", "zero1")),
                ("zamba2-2.7b", "zamba2-2.7b", "decode_32k",
                 ("--both-meshes",)),
                ("rwkv6-3b", "rwkv6-3b", "long_500k", ()))


def _spawn(args: list[str], tag: str, phase_dir: str = "phase21",
           hide_card: bool = True):
    """``python <args>`` from the checkout, the card hidden unless
    ``hide_card`` is false; its output in
    build/<phase_dir>/<tag>.{out,err}."""
    logs = ROOT / "build" / phase_dir
    logs.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    if hide_card:
        env["CUDA_VISIBLE_DEVICES"] = ""
    so = open(logs / f"{tag}.out", "w+")
    se = open(logs / f"{tag}.err", "w+")
    proc = subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env,
                            text=True, stdout=so, stderr=se)
    return SimpleNamespace(proc=proc, so=so, se=se, tag=tag)


def _finish(job, deadline: float) -> str:
    """The job's standard output once it ends (killed at ``deadline``, a
    ``time.perf_counter`` reading); it must exit 0."""
    try:
        job.proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        job.proc.kill()
        job.proc.wait()
    job.so.seek(0)
    job.se.seek(0)
    out, err = job.so.read(), job.se.read()
    job.so.close()
    job.se.close()
    require(job.proc.returncode == 0, f"{job.tag} exited "
            f"{job.proc.returncode}: {err[-3000:]}")
    return out


def run_analysis(torch, fwd_seconds: dict, train: dict,
                 bf16_peak: float) -> dict:
    """Phase 21: (a), (c) and (d) on the CPU in subprocesses while (b)
    audits the serving programs on the card; returns (b)'s mamba2
    launches by arch and program."""
    t_all = time.perf_counter()
    smoke = str(ROOT / "chip_smoke.py")
    jobs = {}
    try:
        jobs["lint"] = _spawn(["-m", "repro_torch.analysis", "--json",
                               str(ROOT / "build" / "phase21_findings.json")],
                              "lint")
        jobs["placements"] = _spawn([smoke, "--phase21-placements"],
                                    "placements")
        for tag, arch, shape, extra in DRYRUN_CELLS:
            jobs[tag] = _spawn(["-m", "repro_torch.launch.dryrun", "--arch",
                                arch, "--shape", shape, *extra],
                               f"dryrun_{tag}")
        for which in ("train", "forward"):
            jobs[which] = _spawn([smoke, "--phase21-cell", which],
                                 f"cell_{which}")
        print("(b) the serving hot paths on the card (the CPU parts run "
              "meanwhile)")
        audit = run_audit(torch)
        print(f"  (b) took {time.perf_counter() - t_all:.1f} s")
        deadline = time.perf_counter() + 600
        outs = {k: _finish(j, deadline) for k, j in jobs.items()}
        print(f"  the CPU parts ended {time.perf_counter() - t_all:.1f} s "
              f"into the phase")
    finally:
        for j in jobs.values():
            if j.proc.poll() is None:
                j.proc.kill()
                j.proc.wait()

    print("(a) python -m repro_torch.analysis (every config x {no mesh, "
          "data=2,model=4}, the golden schedule): exit 0")
    lint = outs["lint"].strip().splitlines()
    for line in lint:
        if line.startswith(("sharding ", "golden ")):
            print("  " + line)
    print("  " + lint[-1])
    for line in outs["placements"].strip().splitlines():
        print("  " + line)

    print("(c) the dry run on the production meshes (fake process groups, "
          "fake tensors), then the roofline")
    check_dryrun([outs[tag] for tag, *_ in DRYRUN_CELLS])

    print("(d) the dry run on one device against phases 19 and 7")
    check_dryrun_vs_card(json.loads(outs["train"].strip().splitlines()[-1]),
                         json.loads(outs["forward"].strip().splitlines()[-1]),
                         train, fwd_seconds, bf16_peak)
    print(f"  phase 21 took {time.perf_counter() - t_all:.1f} s")
    return audit


def _sync_controls(torch, trace_audit) -> None:
    """Phase 21 (b)'s positive controls: programs that do sync on the card
    (a scalar read of a device tensor, a blocking upload of host data).
    The card must report each at the program's line, and the audit of the
    same program must name that line: so a serving program's 0 is a
    reading, not a watch that cannot see."""
    def scalar_read(t):
        return t.sum().item()

    def blocking_upload(t):
        return t + torch.ones(t.shape).to("cuda")

    x = torch.arange(4096.0, device="cuda")
    for fn in (scalar_read, blocking_upload):
        fn(x)                                               # warm-up
        torch.cuda.synchronize()
        _, syncs = trace_audit.reported_syncs(fn, x)
        found = trace_audit.sync_sources(
            trace_audit.audit_program(fn, x, site=fn.__name__))
        line = f"chip_smoke.py:{fn.__code__.co_firstlineno + 1}"
        print(f"  control {fn.__name__}: the card reported {syncs}, the "
              f"audit names {sorted(found)}")
        require(syncs and set(syncs) == {line}, f"control {fn.__name__}: "
                f"the card reported {syncs}, not a sync at {line}")
        require(found == {line}, f"control {fn.__name__}: the audit names "
                f"{sorted(found)}, not {line}")


def _card_audit(torch, trace_audit) -> None:
    """Phase 21 (b): ``audit_hot_paths`` on the card (the CLI's ``--audit``
    default) for reduced configs of the audited archs: a sync the card
    reports that the watch missed is a finding, and a serving program
    may have none."""
    from repro_torch.configs import get_config
    from repro_torch.models import reduced

    for arch in AUDIT_ARCHS:
        t0 = time.perf_counter()
        got = trace_audit.audit_hot_paths(reduced(get_config(arch)))
        card = [f for f in got if "reported by the card" in f.detail]
        print(f"  audit_hot_paths({arch}, reduced) on the card: "
              f"{len(got)} finding(s), {len(card)} reported by the card "
              f"alone ({time.perf_counter() - t0:.1f} s)")
        for f in got:
            print(f"    {f}")
        serving = [f for f in card if not f.site.endswith("/train_step")]
        require(not serving, f"{arch}: the card reported serving syncs "
                f"that the audit's watch missed: {[str(f) for f in serving]}")
        # ROADMAP C.3 closed: no sync in the train step, reported by the
        # card or found by the watch
        train = [f for f in got if f.site.endswith("/train_step")
                 and f.rule == trace_audit.R_HOST_SYNC]
        require(not train, f"{arch}: the train step syncs: "
                f"{[str(f) for f in train]}")


def run_audit(torch) -> dict:
    """Phase 21 (b): the positive controls; each serving program run once
    on the card under the sync debug mode after a warm-up, its launches
    counted from that run; every sync the card reports must be a
    ``trace/host-sync`` finding of ``audit_program`` on the same program
    and inputs; then ``audit_hot_paths`` on the card at reduced sizes."""
    import numpy as np

    from repro_torch.analysis import trace_audit
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import _write_slot
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import family_module

    _sync_controls(torch, trace_audit)

    slots, max_seq, ps = SERVE["slots"], SERVE["max_seq"], PAGED["page_size"]
    per_slot = max_seq // ps
    pos = np.array(AUDIT_POS, np.int64)
    row_map = np.full((slots, max_seq), -1, np.int32)
    for s_, p_ in enumerate(pos):      # slot s owns pages s*128 onwards
        rows = (s_ * per_slot * ps + np.arange(p_ + 1)).astype(np.int32)
        row_map[s_, :p_ + 1] = rows
    out = {}
    for arch in AUDIT_ARCHS:
        cfg = get_config(arch)
        mod = family_module(cfg)
        params = mod.init(cfg, seed=0, device="cuda")
        decode_step = make_decode_step(cfg, impl="cuda")
        prefill = make_prefill_step(cfg, impl="cuda", cache_len=max_seq)
        cache = mod.init_cache(cfg, slots, max_seq, 1, device="cuda")
        pcache = mod.init_paged_cache(cfg, slots, slots * per_slot * ps,
                                      max_seq, 1, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(5)
        toks = torch.randint(0, cfg.vocab, (slots, 1), generator=gen,
                             device="cuda")
        prompt = torch.randint(0, cfg.vocab, (1, AUDIT_PROMPT),
                               generator=gen, device="cuda")
        axes = mod.cache_slot_axes(cfg)
        with torch.no_grad():
            _, slot_cache = prefill(params, prompt)

        def decode(p, c, t, q):
            return decode_step(p, c, t, q)

        def paged(p, c, t, q, r):
            return decode_step(p, c, t, q, r)

        def write_slot(c, sc, slot):
            _write_slot(c, sc, slot, axes)
            return c

        programs = {
            "decode": (decode, (params, cache, toks, pos)),
            "paged_decode": (paged, (params, pcache, toks, pos, row_map)),
            "prefill": (prefill, (params, prompt)),
            "write_slot": (write_slot, (cache, slot_cache, 0)),
        }
        out[arch] = {}
        for name, (fn, args) in programs.items():
            t0 = time.perf_counter()
            with torch.no_grad():
                fn(*args)                                   # warm-up
                torch.cuda.synchronize()
                _read_launches(reset=True)
                _, syncs = trace_audit.reported_syncs(fn, *args)
                launches = {k: v for k, v in _read_launches().items() if v}
                findings = trace_audit.audit_program(fn, *args,
                                                     site=f"{arch}/{name}")
            explained = trace_audit.sync_sources(findings)
            print(f"  {arch} {name}: {len(syncs)} sync(s) reported by the "
                  f"card {sorted(set(syncs)) or ''}; launches {launches}; "
                  f"audit findings {len(findings)} "
                  f"({time.perf_counter() - t0:.1f} s)")
            for f in findings:
                print(f"    {f}")
            unexplained = set(syncs) - explained
            require(not unexplained, f"{arch} {name}: the card reported "
                    f"syncs at {sorted(unexplained)} that the audit does "
                    f"not find")
            run = {"decode": "decode", "paged_decode": "decode",
                   "prefill": "prefill"}.get(name)
            want = {} if run is None else {
                k: n for k, n in _launches(cfg, run).items() if n}
            require(launches == want, f"{arch} {name} launched {launches}, "
                    f"not {want}")
            out[arch][name] = launches.get("mamba2", 0)
        del params, cache, pcache, slot_cache
        torch.cuda.empty_cache()
    _card_audit(torch, trace_audit)
    return out


def check_dryrun(outs: list[str]) -> None:
    """Phase 21 (c): every cell printed OK; each record's per-device
    figures and its roofline row."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, roofline
    from repro_torch.models.config import SHAPES

    records = []
    for out in outs:
        for line in out.strip().splitlines():
            require(line.startswith("OK "), f"dry run: {line}")
            print("  " + line)
            records.append(json.loads(
                (dryrun.ART_DIR / line.split("-> ")[-1]).read_text()))
    require(len(records) == 5, f"{len(records)} dry-run records, not 5")
    for rec in records:
        row = roofline.build_row(rec)
        m, ops = rec["memory"], rec["ops"]
        useful = roofline.model_flops(get_config(rec["arch"]),
                                      SHAPES[rec["shape"]]) / rec["n_devices"]
        require(ops["dot_flops"] > 0 and m["argument_bytes"] > 0,
                f"an empty record: {rec}")
        print(f"  {rec['arch']} x {rec['shape']} on {rec['mesh']} "
              f"({rec['rows_per_device']} rows a device): "
              f"{ops['dot_flops']:.4g} matmul FLOP a device (MODEL_FLOPS "
              f"{useful:.4g}), "
              f"wire {ops['wire_bytes']:.4g} B over groups "
              f"{ops['group_sizes']} spanning {ops['group_nodes']} nodes; "
              f"argument {m['argument_bytes'] / 2**30:.3f} GiB, temp "
              f"{m['temp_bytes'] / 2**30:.3f} GiB; terms compute "
              f"{row.compute_s:.4g} s, memory {row.memory_s:.4g} s, "
              f"collective {row.collective_s:.4g} s: {row.dominant}-bound, "
              f"roofline fraction {row.roofline_fraction:.4f}")
    # FSDP's params and moments a rank against ZeRO-1's, same cell
    arg = {rec["mode"]: rec["memory"]["argument_bytes"] for rec in records
           if (rec["arch"], rec["shape"]) == ("qwen3-8b", "train_4k")}
    print(f"  qwen3-8b x train_4k on 16x16, argument bytes a rank: fsdp "
          f"{arg['fsdp']} ({arg['fsdp'] / 2**30:.3f} GiB), zero1 "
          f"{arg['zero1']} ({arg['zero1'] / 2**30:.3f} GiB)")
    require(arg["fsdp"] < arg["zero1"], f"FSDP's argument bytes {arg} are "
            f"not below ZeRO-1's")
    md = ROOT / "build" / "phase21_roofline.md"
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline",
                          "--all-meshes", "--emit", str(md)], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(SRC)},
                         capture_output=True, text=True, timeout=300)
    require(res.returncode == 0, f"roofline: {res.stderr[-2000:]}")
    table = [ln for ln in res.stdout.splitlines() if ln.startswith("| ")]
    for rec in records:
        row = f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} |"
        require(any(ln.startswith(row) for ln in table),
                f"the roofline table has no row {row}")
    print(f"  python -m repro_torch.launch.roofline: {len(table) - 1} rows "
          f"(every record's among them) -> {md.relative_to(ROOT)}")


def check_dryrun_vs_card(train_rec: dict, fwd_rec: dict, train: dict,
                         fwd_seconds: dict, bf16_peak: float) -> None:
    """Phase 21 (d): the dry run's argument bytes of phase 19 (c)'s
    training config equal phase 19's params, moments, step and batch
    bytes; the rest are readings."""
    from repro_torch.configs import get_config
    from repro_torch.launch.roofline import model_flops
    from repro_torch.models.config import ShapeCell

    sb = train["state_bytes"]
    want = sb["params"] + sb["m"] + sb["v"] + train["step_bytes"] \
        + train["batch_bytes"]
    m = train_rec["memory"]
    print(f"  {train_rec['arch']} train 1 x {train_rec['seq_len']}, one "
          f"device: argument bytes {m['argument_bytes']} predicted, phase "
          f"19 params {sb['params']} + m {sb['m']} + v {sb['v']} + step "
          f"{train['step_bytes']} + batch {train['batch_bytes']} = {want} "
          f"measured; peak predicted (arguments + temporaries) "
          f"{(m['argument_bytes'] + m['temp_bytes']) / 1e9:.2f} GB "
          f"(temporaries {m['temp_bytes'] / 1e9:.2f} GB, phase 19's grads "
          f"{sb['grads'] / 1e9:.2f} GB among them), phase 19 measured "
          f"{train['peak'] / 1e9:.2f} GB; {train_rec['ops']['dot_flops']:.4g}"
          f" matmul FLOP a step (trace {train_rec['trace_s']} s)")
    require(m["argument_bytes"] == want, f"the dry run's argument bytes "
            f"{m['argument_bytes']} != phase 19's {want}")
    cfg = get_config(fwd_rec["arch"])
    cell = ShapeCell(fwd_rec["shape"], fwd_rec["seq_len"], 1, "prefill")
    count, useful = fwd_rec["ops"]["dot_flops"], model_flops(cfg, cell)
    bound = count / bf16_peak
    took = fwd_seconds[fwd_rec["arch"]]
    # the counter takes the plain attention's full S x S products; the
    # causal kernel computes the S (S + 1) / 2 unmasked scores' share
    s_ = fwd_rec["seq_len"]
    attn = 4 * s_ * s_ * cfg.n_heads * cfg.head_dim * cfg.n_layers
    causal = (count - attn + attn * (s_ + 1) / (2 * s_)) / bf16_peak
    print(f"  {fwd_rec['arch']} forward 1 x {s_}, one "
          f"device: {count:.6g} FLOP counted (the plain versions' matmuls "
          f"and attention, {attn:.6g} of it the full S x S attention), "
          f"MODEL_FLOPS {useful:.6g} (ratio {useful / count:.4f}); compute "
          f"bound {bound * 1e3:.3f} ms at {bf16_peak / 1e12:.0f} TFLOP/s "
          f"against phase 7's {took * 1e3:.1f} ms: {bound / took:.4f} of "
          f"the roofline; attention counted causally {causal * 1e3:.3f} "
          f"ms: {causal / took:.4f}")


def phase21_cell(argv: list[str]) -> int:
    """One of phase 21 (d)'s dry-run cells on one device (no mesh), its
    record printed as JSON on the last line."""
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.models.config import ShapeCell

    if argv == ["train"]:
        t = TRAIN_FULL
        rec = lower_cell(t["arch"], ShapeCell(
            f"train_{t['batch']}x{t['seq_len']}", t["seq_len"], t["batch"],
            "train"), single=True)
    elif argv == ["forward"]:
        rec = lower_cell("qwen3-8b", ShapeCell(
            f"forward_1x{FWD_TOKENS}", FWD_TOKENS, 1, "prefill"),
            single=True)
    else:
        raise SystemExit(f"--phase21-cell train|forward, not {argv}")
    print(json.dumps(rec))
    return 0


def phase21_placements() -> int:
    """Phase 21 (a): every arch's specs linted on a fake 16x16 mesh: each
    spec that passes the rules must turn into DTensor placements on it
    (no ``sharding/no-placement``), and the params must be clean; the
    caches' 4 slots do not divide over 'data' 16, which the lint reports
    (as the reference's does) and nothing raises."""
    from repro_torch.analysis.sharding_lint import R_PLACEMENT, lint_config
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import describe, make_production_mesh

    bad = []
    with fake_world(256):
        mesh = make_production_mesh(device="cpu")
        for arch in ARCH_IDS:
            got = lint_config(get_config(arch), mesh=mesh)
            rules = sorted({f.rule for f in got})
            print(f"placements {arch} on {describe(mesh)}: {len(got)} "
                  f"finding(s) {rules}")
            bad += [f for f in got if f.rule == R_PLACEMENT or (
                f.severity == "error" and "/params" in f.site)]
    for f in bad:
        print(f"  {f}")
    return 1 if bad else 0


# -- phase 22: FSDP training ------------------------------------------------------

def _fsdp_cfg():
    """zamba2-2.7b at full width, its depth cut to FSDP_TRAIN's groups, in
    float32."""
    from repro_torch.configs import get_config

    cfg = get_config(FSDP_TRAIN["arch"])
    return dataclasses.replace(
        cfg, n_layers=FSDP_TRAIN["groups"] * cfg.attn_every, dtype="float32")


def _fsdp_data(cfg):
    from repro_torch.data import SyntheticLM

    return SyntheticLM(cfg.vocab, FSDP_TRAIN["seq"], FSDP_TRAIN["batch"],
                       seed=0)


def _nbytes(tree) -> int:
    from repro_torch.models.tree import leaves

    return sum(x.numel() * x.element_size() for x in leaves(tree))


def _digest(tree) -> dict[str, str]:
    """The sha256 of each leaf's bytes, by its key path."""
    import hashlib

    import torch

    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}")
            return
        raw = t.detach().contiguous().view(-1).view(torch.uint8).cpu()
        out[path] = hashlib.sha256(raw.numpy().tobytes()).hexdigest()
    walk(tree, "")
    return out


def phase22_rank() -> int:
    """One rank of phase 22 (b): ``chip_smoke.py --phase22-rank``, two of
    them started by ``run_fsdp`` on the one card (gloo).  Takes the step
    on its row of the global batch, first with FSDP params (each rank's
    shard by the specs; its whole params checkpointed for (c)), then
    ZeRO-1's, each from the same seeded weights; prints its readings as
    one JSON object on its last line."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import local
    from repro_torch.ft import CheckpointManager
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.launch.steps import make_train_step, shard_params
    from repro_torch.launch.train import to_device
    from repro_torch.models import abstract, family_module
    from repro_torch.optim import AdamW

    require(torch.cuda.is_available(), "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed("cuda")
    mesh = make_host_mesh(device="cuda")
    cfg = _fsdp_cfg()
    mod = family_module(cfg)
    specs, segs = mod.specs(cfg), mod.compute_segments(cfg, 1)
    batch = to_device(_fsdp_data(cfg).global_arrays(0, mesh), "cuda",
                      torch.float32)
    res = {"rank": dist.get_rank(), "backend": dist.get_backend(),
           "rows": int(batch["tokens"].shape[0])}
    for layout in ("fsdp", "zero1"):
        fsdp = layout == "fsdp"
        params = shard_params(cfg, mod.init(cfg, seed=0, device="cuda"),
                              mesh, fsdp=fsdp)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        opt = AdamW(lr=FSDP_TRAIN["lr"]).shard(mesh, specs, segs, fsdp=fsdp)
        state = opt.init(params)
        step = make_train_step(cfg, opt, mesh=mesh)
        local.STATS.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        out = {"seconds": time.perf_counter() - t0,
               "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "peak": torch.cuda.max_memory_allocated(),
               "params": _nbytes(params),
               "moments": _nbytes(state.m) + _nbytes(state.v),
               "collectives": {k: list(v) for k, v in local.STATS.items()}}
        if fsdp:
            # (c): the whole params, checkpointed (rank 0 writes)
            shapes = abstract(mod.init, cfg, device="cpu")
            whole = local.full_params(params, specs, mesh, shapes, segs,
                                      fsdp=True)
            CheckpointManager(FSDP_DIR / "ckpt").save(1, (whole,))
            if dist.get_rank() == 0:
                out["digest"] = _digest(whole)
            del whole
        res[layout] = out
        del params, state, m, step, opt
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    print(json.dumps(res))
    return 0


def run_fsdp(torch) -> None:
    """Phase 22: (a) one AdamW step in one process, (b) the same step on
    two ranks sharing the card (``phase22_rank``: FSDP, then ZeRO-1), (c)
    (b)'s FSDP checkpoint restored onto a one-rank mesh, bit for bit."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import local
    from repro_torch.ft import CheckpointManager
    from repro_torch.launch.mesh import make_host_mesh, rank_json, run_ranks
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import to_device
    from repro_torch.models import family_module
    from repro_torch.models.tree import leaves, tree_map
    from repro_torch.optim import AdamW

    t_all = time.perf_counter()
    if FSDP_DIR.exists():
        shutil.rmtree(FSDP_DIR)
    FSDP_DIR.mkdir(parents=True)
    t = FSDP_TRAIN
    cfg = _fsdp_cfg()
    mod = family_module(cfg)
    full_depth = get_config(t["arch"]).n_layers

    # (a) one process, the whole batch
    torch.cuda.empty_cache()
    params = mod.init(cfg, seed=0, device="cuda")
    n_params = sum(x.numel() for x in leaves(params))
    torch.cuda.reset_peak_memory_stats()
    opt = AdamW(lr=t["lr"])
    state = opt.init(params)
    batch = to_device(_fsdp_data(cfg).batch(0), "cuda", torch.float32)
    step = make_train_step(cfg, opt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, m = step(params, state, batch)
    torch.cuda.synchronize()
    one = {"seconds": time.perf_counter() - t0, "loss": float(m["loss"]),
           "grad_norm": float(m["grad_norm"]),
           "peak": torch.cuda.max_memory_allocated(),
           "params": _nbytes(params),
           "moments": _nbytes(state.m) + _nbytes(state.v)}
    print(f"(a) one process: {cfg.name} at full width (d {cfg.d_model}, "
          f"80 SSD heads x 64, state 64; the shared block H 32, D 80), depth "
          f"cut to {cfg.n_layers} of {full_depth} Mamba-2 layers "
          f"({t['groups']} of {full_depth // cfg.attn_every} groups), "
          f"float32, {n_params / 1e9:.3f} B parameters; one AdamW step "
          f"(lr {t['lr']}) on {t['batch']} x {t['seq']} tokens: loss "
          f"{one['loss']:.8f}, grad norm {one['grad_norm']:.8f}, "
          f"{one['seconds'] * 1e3:.1f} ms; params {one['params'] / 1e9:.3f} "
          f"GB, moments {one['moments'] / 1e9:.3f} GB, peak "
          f"{one['peak'] / 1e9:.2f} GB")
    require(math.isfinite(one["loss"]) and math.isfinite(one["grad_norm"]),
            f"(a) non-finite loss or grad norm: {one}")
    del params, state, m, step, batch
    torch.cuda.empty_cache()

    # (b) two ranks on the card: FSDP, then ZeRO-1
    t0 = time.perf_counter()
    procs = run_ranks([str(ROOT / "chip_smoke.py"), "--phase22-rank"], 2,
                      FSDP_DIR / "ranks", timeout=600)
    for r, p in enumerate(procs):
        for line in p.stderr.strip().splitlines()[-5:]:
            print(f"  [rank {r}] {line}")
        require(p.returncode == 0, f"rank {r} exited {p.returncode}: "
                f"{p.stderr[-3000:]}")
    ranks = [rank_json(p) for p in procs]
    print(f"(b) two ranks on the card, data=2 (backend "
          f"{ranks[0]['backend']}), {ranks[0]['rows']} row of "
          f"{t['seq']} tokens a rank: {time.perf_counter() - t0:.1f} s for "
          f"both processes")
    require(all(r_["backend"] == "gloo" for r_ in ranks),
            "two ranks on one card did not run gloo")
    for r, res in enumerate(ranks):
        for layout in ("fsdp", "zero1"):
            x = res[layout]
            x["loss_rel"] = abs(x["loss"] - one["loss"]) / abs(one["loss"])
            x["gnorm_rel"] = abs(x["grad_norm"] - one["grad_norm"]) \
                / one["grad_norm"]
            gloo = sum(v[1] for v in x["collectives"].values())
            print(f"  rank {r} {layout:5s}: loss {x['loss']:.8f} (rel "
                  f"{x['loss_rel']:.3g}), grad norm {x['grad_norm']:.8f} "
                  f"(rel {x['gnorm_rel']:.3g}); step "
                  f"{x['seconds'] * 1e3:.1f} ms, {gloo / x['seconds']:.0%} "
                  f"in collectives ({_collectives(x['collectives'])}); "
                  f"params {x['params'] / 1e9:.3f} GB, moments "
                  f"{x['moments'] / 1e9:.3f} GB, peak "
                  f"{x['peak'] / 1e9:.2f} GB")
        f, z = res["fsdp"], res["zero1"]
        require(f["loss_rel"] <= FSDP_TOL["loss"], f"rank {r}: the FSDP "
                f"loss is {f['loss_rel']:.3g} from one process's")
        require(f["gnorm_rel"] <= FSDP_TOL["grad_norm"], f"rank {r}: the "
                f"FSDP grad norm is {f['gnorm_rel']:.3g} from one process's")
        require(f["params"] < z["params"] and f["peak"] < z["peak"],
                f"rank {r}: FSDP holds {f['params']} param bytes, peak "
                f"{f['peak']}, ZeRO-1 {z['params']}, {z['peak']}")

    # (c) the FSDP checkpoint onto a one-rank mesh
    t0 = time.perf_counter()
    mesh1 = make_host_mesh(device="cuda")
    like = mod.init(cfg, seed=0, device="cuda")
    (got,) = CheckpointManager(FSDP_DIR / "ckpt").restore(
        1, like=(like,), mesh=mesh1, specs=(mod.specs(cfg),))
    del like
    digest = _digest(tree_map(local.full_tensor, got))
    want = ranks[0]["fsdp"]["digest"]
    require(set(digest) == set(want), "the restored leaves differ in name")
    bad = [k for k in want if digest[k] != want[k]]
    require(not bad, f"restored leaves differ from (b)'s whole params: {bad}")
    print(f"(c) (b)'s FSDP checkpoint restored onto the one-rank mesh "
          f"({dist.get_backend()}) as DTensors: all {len(want)} leaves "
          f"bit for bit (b)'s whole params, in "
          f"{time.perf_counter() - t0:.1f} s")
    del got
    dist.destroy_process_group()
    shutil.rmtree(FSDP_DIR / "ckpt")
    torch.cuda.empty_cache()
    print(f"  phase 22 took {time.perf_counter() - t_all:.1f} s")


# -- phase 23: the experiment scripts and the serving gates ------------------

# (b)'s scripts at the reference's settings, in this order, in a process of
# their own on the card while (c) runs; each one's main() with its output
# captured, and each must allocate on the card (the DQNs; bench_calibration's
# kernels)
BENCH_FIGS = ("fig7_intrinsics", "fig11_sw_dse", "ablation_qlearning",
              "fig10_hw_dse", "table3_codesign", "bench_sw_dse",
              "bench_calibration")
# the host-numpy gated scripts: bench_acquisition (~1 min) with (d) in the
# CPU subprocess; bench_batched_eval (~1 s) at the end, alone on the host,
# since a busy host moves its 10x reading
BENCH_HOST = ("bench_acquisition",)
BENCH_LAST = "bench_batched_eval"
# kernel_micro's rows by the names of the kernels JSON line
MICRO_ROWS = {"gemm": "gemm", "flash_attention": "flash_attention",
              "rwkv6": "rwkv6", "mamba2_ssd": "mamba2"}
BENCH_DIR = ROOT / "build" / "phase23"
# (b)'s bank check: a bank of `seeds` slots, one of the first `part`, the
# 1-seed banks and standalone DQNs, through `rounds` ragged rounds of
# frontiers of up to k (bench_sw_dse's k) at the DSE's feature and move
# counts; each slot's frontier size per round, rotated over the slots (a
# mean of 4.1 a round: every slot's replay warms and trains)
BANK = dict(seeds=16, part=4, rounds=12, k=6)
BANK_RAGGED = (6, 6, 5, 6, 3, 0, 6, 1)


def _gate(name: str, ok: bool, reading: str) -> bool:
    print(f"  gate {name} {'pass' if ok else 'MISS'} {reading}", flush=True)
    return ok


def _csv_numbers_finite(out: str) -> list[str]:
    """The fields of the printed CSV rows that read as numbers but are not
    finite (an empty list where every row is finite)."""
    bad = []
    for line in out.splitlines():
        if line.startswith("#") or "," not in line:
            continue
        for field in line.split(","):
            try:
                x = float(field)
            except ValueError:
                continue
            if not math.isfinite(x):
                bad.append(line)
                break
    return bad


def _run_script(name: str, device: str = "cuda") -> tuple[str, float, int]:
    """``repro_torch.bench.<name>.main(["--device", device])`` with its
    standard output captured: (output, seconds, exit code of a gate)."""
    import contextlib
    import importlib
    import io

    mod = importlib.import_module(f"repro_torch.bench.{name}")
    buf = io.StringIO()
    code = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        try:
            mod.main(argv=["--device", device])
        except SystemExit as e:      # a gated script that missed its gate
            code = e.code if isinstance(e.code, int) else 1
    return buf.getvalue(), time.perf_counter() - t0, code


def check_micro(torch) -> None:
    """(a) each of kernel_micro's kernels against its plain version on the
    same inputs, at the smoke's tolerances (the recurrences' atol scaled by
    the call's largest value, as ``_CheckedOps`` does: these inputs are not
    normalised); flash attention on its tensor-core route."""
    from repro_torch.bench import kernel_micro
    from repro_torch.kernels import flash_attention

    tc0 = flash_attention.route_launches["tc"]
    for c in kernel_micro.cases("cuda"):
        got, want = c["call"](), c["plain"]()
        if c["kernel"] == "gemm":
            rtol, atol = TOL["gemm"]["float32"]
        elif c["kernel"] == "flash_attention":
            rtol, atol = FLASH_TOL["bfloat16"]
        else:
            rtol, atol = LIN_TOL["float32"]
            atol *= max(1.0, float(want.float().abs().max()))
        err = _close(torch, got, want, rtol, atol)
        print(f"  {c['kernel']} {c['shape']} {c['dtype']}: max abs err "
              f"{err:.3g} against its plain version (rtol {rtol}, atol "
              f"{atol:.3g})")
    require(flash_attention.route_launches["tc"] == tc0 + 1,
            "kernel_micro's bfloat16 attention left the tensor-core route")


def _bench_micro(torch, by_name: dict) -> None:
    """(a): kernel_micro checked, then timed with its launches counted
    from that run alone; its rows join the kernels line."""
    from repro_torch.bench import kernel_micro

    print("(a) kernel_micro: the reference's four rows at its shapes")
    check_micro(torch)
    _read_launches(reset=True)
    t0 = time.perf_counter()
    micro = kernel_micro.run("cuda")
    launches = _read_launches()
    for m in micro:
        name = MICRO_ROWS[m["kernel"]]
        require(launches[name] > 0, f"kernel_micro launched no {name}")
        require(m["finite"], f"kernel_micro {name}: non-finite output")
        print(f"  {m['kernel']:15s} {m['shape']:14s} {m['dtype']:8s} "
              f"{m['us_per_call']:.2f} us a call by events, replayed "
              f"{m['us_per_call_graph']:.2f} us ({m['gflops']:.1f} "
              f"GFLOP/s); plain {m['plain_us_per_call']:.2f} us; bound "
              f"{m['bound_us']:.2f} us by {m['bound_by']}; launches "
              f"{launches[name]}; max abs err {m['max_abs_err']:.3g}")
        if name in by_name:
            by_name[name]["bench_micro"] = {
                "launches": launches[name],
                **{k: m[k] for k in ("shape", "dtype", "max_abs_err",
                                     "us_per_call", "us_per_call_graph",
                                     "plain_us_per_call", "bound_us",
                                     "bound_by", "gflops")}}
    print(f"  (a) took {time.perf_counter() - t0:.1f} s")


def _bench_figures(res: dict, by_name: dict, speed: list[bool]) -> None:
    """(b): each script's rows, wall clock, allocations on the card and
    launches, from ``phase23_figs``; every number finite and every script
    allocating on the card."""
    from repro_torch.bench import bench_sw_dse

    print("(b) the figures, Table III, the DSE and calibration benchmarks at "
          "the reference's settings, the DQNs on the card, in a process of "
          "their own while (c) ran")
    b = res["bank"]
    g, e = b["graph_ms"][b["first"] + 1:], b["eager_ms"][b["first"] + 1:]
    print(f"  the DQN bank first: slot i of a {b['slots']}-seed bank, of a "
          f"{b['part']}-seed bank (i < {b['part']}), of the 1-seed bank and "
          f"a standalone DQN equal bit for bit (actions every round; params, "
          f"target, Adam moments, counts and epsilon at the end) after "
          f"{b['rounds']} ragged rounds of up to {b['k']} transitions at "
          f"{b['features']} features and {b['actions']} moves, counts "
          f"{min(b['t'])}-{max(b['t'])}; the graph-replayed rounds equal "
          f"the eager ones bit for bit; a warm round's train steps took "
          f"{min(g):.3f}-{max(g):.3f} ms replayed, {min(e):.3f}-{max(e):.3f} "
          f"ms eagerly (host clock, the {len(g)} rounds after the first warm "
          f"one, whose replay took {b['graph_ms'][b['first']]:.3f} ms with "
          f"its capture); the check took {b['seconds']:.1f} s")
    for name in BENCH_FIGS:
        r_ = res[name]
        for line in r_["out"].strip().splitlines():
            print(f"    {line}")
        print(f"  {name}: {r_['seconds']:.1f} s of wall clock, exit "
              f"{r_['exit']}, {r_['allocations']} allocations on the card")
        bad = _csv_numbers_finite(r_["out"])
        require(not bad, f"{name}: non-finite rows {bad[:3]}")
        require(r_["allocations"] > 0, f"{name} ran nothing on the card")
    gemm = res["bench_calibration"]["launches"]["gemm"]
    require(gemm > 0, "bench_calibration launched no gemm")
    by_name["gemm"]["calibration_launches"] = gemm
    print(f"  bench_calibration launched gemm {gemm} times")
    m = res["bench_sw_dse"]["metrics"]
    require(m["round_loop_parity"], "bench_sw_dse: the batched engine's "
            "schedules or latencies differ from the per-search engine's")
    require(m["codesign_q4_identical"], "bench_sw_dse: codesign(q=4) "
            "committed another solution")
    speed.append(_gate("bench_sw_dse_round_loop>=5x",
                       m["round_loop_speedup"] >= bench_sw_dse.TARGET_SPEEDUP,
                       f"{m['round_loop_speedup']}x"))
    speed.append(_gate("bench_sw_dse_codesign_q4_faster",
                       m["codesign_q4_batched_s"]
                       < m["codesign_q4_reference_s"],
                       f"{m['codesign_q4_speedup']}x"))


def _host_gate(name: str, r_: dict, speed: list[bool]) -> None:
    """A host-numpy gated script's rows and its 10x gate."""
    from repro_torch.bench import bench_acquisition

    for line in r_["out"].strip().splitlines():
        print(f"    {line}")
    print(f"  {name}: {r_['seconds']:.1f} s of wall clock, exit {r_['exit']}")
    bad = _csv_numbers_finite(r_["out"])
    require(not bad, f"{name}: non-finite rows {bad[:3]}")
    m = r_["metrics"]
    if name == "bench_acquisition":
        require(m["hv_parity_rel_err"] <= bench_acquisition.HV_PARITY_RTOL,
                f"bench_acquisition: hypervolume parity "
                f"{m['hv_parity_rel_err']}")
        sp = m["hvi_speedup"]
    else:
        sp = m["worst_speedup_batched"]
    speed.append(_gate(f"{name}>=10x", sp >= m["target_speedup"], f"{sp}x"))


def _bench_serving(torch, speed: list[bool]) -> dict:
    """(c): the serving gates at full width on one model; returns
    bench_serve_tp's model=1 metrics."""
    import torch.distributed as dist

    from repro_torch.bench import bench_obs, bench_serve, bench_serve_tp

    print("(c) the serving gates at full width: qwen3-8b, float32")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    cfg, params = bench_serve.model("cuda", full_width=True)
    print(f"  {cfg.name}: d {cfg.d_model}, {cfg.n_layers} layers, vocab "
          f"{cfg.vocab}, {cfg.dtype}, drawn in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    _read_launches(reset=True)
    t0 = time.perf_counter()
    m = bench_serve.run(cfg, params)
    print(f"  bench_serve uniform: {json.dumps(m)} "
          f"({time.perf_counter() - t0:.1f} s)")
    require(m["outputs_identical"], "bench_serve: batched and sequential "
            "outputs differ")
    speed.append(_gate("bench_serve>=2x",
                       m["speedup"] >= bench_serve.TARGET_SPEEDUP,
                       f"{m['speedup']}x ({m['tok_s_batched']} against "
                       f"{m['tok_s_sequential']} tokens/s)"))
    t0 = time.perf_counter()
    mm = bench_serve.run_mixed(cfg, params)
    print(f"  bench_serve mixed: {json.dumps(mm)} "
          f"({time.perf_counter() - t0:.1f} s)")
    require(mm["outputs_identical"], "bench_serve mixed: outputs differ "
            "across the sequential, pinned and paged engines")
    speed.append(_gate("bench_serve_mixed>=2x",
                       mm["speedup_paged"] >= bench_serve.TARGET_SPEEDUP,
                       f"{mm['speedup_paged']}x ({mm['tok_s_paged']} against "
                       f"{mm['tok_s_sequential']} tokens/s)"))
    speed.append(_gate("bench_serve_mixed_p95_paged<pinned",
                       mm["p95_queue_paged_s"] < mm["p95_queue_pinned_s"],
                       f"{mm['p95_queue_paged_s']} s against "
                       f"{mm['p95_queue_pinned_s']} s"))
    t0 = time.perf_counter()
    mo = bench_obs.run(cfg, params, art_dir=BENCH_DIR)
    print(f"  bench_obs: {json.dumps(mo)} ({time.perf_counter() - t0:.1f} s)")
    require(mo["outputs_identical"], "bench_obs: traced and untraced "
            "outputs differ")
    require(not mo["lifecycle_defects"], f"bench_obs: lifecycle defects "
            f"{mo['lifecycle_defects'][:3]}")
    require(not mo["schema_errors"], f"bench_obs: telemetry schema errors "
            f"{mo['schema_errors'][:3]}")
    speed.append(_gate("bench_obs>=0.97x",
                       mo["overhead_ratio"] >= bench_obs.MIN_RATIO,
                       f"{mo['overhead_ratio']}x ({mo['tok_s_traced']} "
                       f"against {mo['tok_s_untraced']} tokens/s)"))
    t0 = time.perf_counter()
    m1 = bench_serve_tp.run_model1(cfg, params)
    print(f"  bench_serve_tp model=1: {json.dumps(m1)} "
          f"({time.perf_counter() - t0:.1f} s) on a one-rank "
          f"{dist.get_backend()} group")
    require(m1["outputs_identical"], "bench_serve_tp: the model=1 mesh's "
            "outputs differ from no mesh's")
    launched = ", ".join(f"{k} {v}" for k, v in _read_launches().items()
                         if v) or "none"
    print(f"  kernel launches in (c): {launched} (both engines prefill and "
          f"decode qwen3-8b with plain attention over the cache, as the "
          f"reference's do)")
    del params
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return m1


def _bench_cpu(res: dict, m1: dict, speed: list[bool]) -> None:
    """(d): the CPU subprocess's results: the 8-way scenario, codesign and
    the host-numpy gated scripts."""
    from repro_torch.bench import bench_serve_tp

    m8, mc = res["tp8"], res["codesign"]
    print(f"  tp8: identical {m8['outputs_identical']}, "
          f"{m8['tok_s_tp8']} tokens/s on 8 ranks against "
          f"{m8['tok_s_single']} on one; codesign: {json.dumps(mc)} "
          f"({res['seconds']:.1f} s)")
    require(m8["outputs_identical"], "bench_serve_tp: 8 ranks' tokens "
            "differ from one rank's")
    require(bench_serve_tp.gate(m1, m8, mc), f"bench_serve_tp: the TP-aware "
            f"codesign did not commit another, faster solution: {mc}")
    for name in BENCH_HOST:
        _host_gate(name, res["scripts"][name], speed)


def run_bench(torch, rows: list[dict]) -> None:
    """Phase 23: the ported experiment scripts (``repro_torch.bench``) on
    the card.  (a) kernel_micro, checked then timed, alone; then three
    processes at once: (b) the figures, Table III and the DSE and
    calibration benchmarks at the reference's settings, on the card in a
    process of their own (``phase23_figs``); (c) the serving gates at full
    width (qwen3-8b, float32) here; (d) the 8-way tensor-parallel scenario,
    the TP-aware codesign and bench_acquisition on the CPU with the card
    hidden (``phase23_cpu``); last, bench_batched_eval alone, then
    bench_sw_dse's round loop alone (``phase23_sw_dse``).  A correctness
    gate that fails ends the smoke; a speed gate's miss is a reading."""
    t_all = time.perf_counter()
    by_name = {r_["name"]: r_ for r_ in rows}
    speed: list[bool] = []
    _bench_micro(torch, by_name)
    smoke = str(ROOT / "chip_smoke.py")
    jobs = {"cpu": _spawn([smoke, "--phase23-cpu"], "cpu", "phase23"),
            "figs": _spawn([smoke, "--phase23-figs"], "figs", "phase23",
                           hide_card=False)}
    try:
        m1 = _bench_serving(torch, speed)
        t0 = time.perf_counter()
        deadline = t0 + 600
        res = {k: json.loads(_finish(j, deadline).strip().splitlines()[-1])
               for k, j in jobs.items()}
        print(f"  waited {time.perf_counter() - t0:.1f} s for (b) and (d)")
    finally:
        for j in jobs.values():        # a check above failed: stop them
            if j.proc.poll() is None:
                j.proc.kill()
                j.proc.wait()
    _bench_figures(res["figs"], by_name, speed)
    print("(d) on the CPU with the card hidden, while (b) and (c) ran: "
          "bench_serve_tp's 8-way scenario and codesign, then "
          "bench_acquisition")
    _bench_cpu(res["cpu"], m1, speed)
    print(f"then {BENCH_LAST} alone")
    out, sec, code = _run_script(BENCH_LAST)
    _host_gate(BENCH_LAST, {
        "out": out, "seconds": sec, "exit": code, "metrics": importlib_attr(
            BENCH_LAST, "LAST_METRICS")}, speed)
    _sw_dse_alone(speed)
    print(f"  {sum(speed)} of {len(speed)} speed gates pass; phase 23 took "
          f"{time.perf_counter() - t_all:.1f} s")


def _sw_dse_alone(speed: list[bool]) -> None:
    """bench_sw_dse's round loop (its warm-up, best of 2) alone in a
    process on the card, as ``python -m repro_torch.bench.bench_sw_dse``
    runs it: both engines' seconds, parity required, the 5x gate a
    reading."""
    from repro_torch.bench import bench_sw_dse

    print("then bench_sw_dse's round loop alone, in a process on the card")
    t0 = time.perf_counter()
    job = _spawn([str(ROOT / "chip_smoke.py"), "--phase23-sw-dse"], "sw_dse",
                 "phase23", hide_card=False)
    m = json.loads(_finish(job, t0 + 300).strip().splitlines()[-1])
    require(m["parity"], "bench_sw_dse alone: the batched engine's "
            "schedules or latencies differ from the per-search engine's")
    sp = m["reference_s"] / m["batched_s"]
    print(f"  per-search engine {m['reference_s']:.3f} s, lock-step engine "
          f"{m['batched_s']:.3f} s ({time.perf_counter() - t0:.1f} s in all)")
    speed.append(_gate("bench_sw_dse_round_loop_alone",
                       sp >= bench_sw_dse.TARGET_SPEEDUP, f"{sp:.1f}x"))


def phase23_sw_dse() -> int:
    """Phase 23's last reading, a process on the card: bench_sw_dse's
    round loop; one JSON line."""
    from repro_torch.bench import bench_sw_dse

    t_ref, t_bat, parity, _, _ = bench_sw_dse.run_round_loop("cuda")
    print(json.dumps({"reference_s": t_ref, "batched_s": t_bat,
                      "parity": parity}))
    return 0


def _bank_leaves(state, i: int) -> list:
    """Slot ``i``'s params, target, m, v (every leaf) and update count."""
    return [x[i] for tree in (state.params, state.target, state.m, state.v)
            for layer in tree for x in layer.values()] + [state.t[i]]


def check_bank(torch) -> dict:
    """(b)'s bank check, on the card before the scripts: slot i of a
    16-seed bank, of a 4-seed bank and of the 1-seed bank of seed i, and a
    standalone DQN of seed i, take the same actions and end with the same
    params, target, Adam moments and counts, bit for bit, after BANK's
    ragged rounds; a 16-seed bank that runs each round's train steps
    eagerly ends bit for bit where the one replaying them from a CUDA graph
    does.  Returns the readings."""
    import numpy as np

    from repro_torch.bench import bench_sw_dse
    from repro_torch.core.qlearning import DQN, DQNBank
    from repro_torch.core.sw_dse import SoftwareSpace

    t_all = time.perf_counter()
    sp = bench_sw_dse._specs()[0]
    space = SoftwareSpace(sp.workload, sp.choices, sp.hw, "spatial")
    F, A, k = space.n_features, len(space.moves), BANK["k"]
    n, p = BANK["seeds"], BANK["part"]
    seeds = [17 * i for i in range(n)]
    bank = lambda ss: DQNBank(F, A, ss, device="cuda")  # noqa: E731
    big, part, eager = bank(seeds), bank(seeds[:p]), bank(seeds)
    eager.state.graph = False
    ones = [bank([s_]) for s_ in seeds]
    dqns = [DQN(F, A, seed=s_, device="cuda") for s_ in seeds]
    rng = np.random.default_rng(0)
    ms = {"graph": [], "eager": []}
    first = None
    for rnd in range(BANK["rounds"]):
        feats = rng.random((n, k, F)).astype(np.float32)
        counts = [BANK_RAGGED[(i + rnd) % len(BANK_RAGGED)] for i in range(n)]
        acts = big.select_round(feats, counts=counts)
        require((eager.select_round(feats, counts=counts) == acts).all()
                and (part.select_round(feats[:p], counts=counts[:p])
                     == acts[:p]).all(),
                f"round {rnd}: the banks' actions differ")
        s2 = rng.random((n, k, F)).astype(np.float32)
        rew = rng.uniform(-1, 1, (n, k))
        for i, (one, d, m) in enumerate(zip(ones, dqns, counts)):
            require((one.select_round(feats[i:i + 1], counts=[m])
                     == acts[i:i + 1]).all()
                    and (m == 0 or (d.select_batch(feats[i, :m])
                                    == acts[i, :m]).all()),
                    f"round {rnd}: slot {i}'s actions differ from its 1-seed "
                    f"bank's or its DQN's")
            for j in range(m):
                d.record(feats[i, j], int(acts[i, j]), float(rew[i, j]),
                         s2[i, j])
                d.train_step()
            one.train_round(feats[i:i + 1], acts[i:i + 1], rew[i:i + 1],
                            s2[i:i + 1], counts=[m])
        part.train_round(feats[:p], acts[:p], rew[:p], s2[:p],
                         counts=counts[:p])
        for name, b in (("graph", big), ("eager", eager)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b.train_round(feats, acts, rew, s2, counts=counts)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
        if first is None and big.t.max() > 0:
            first = rnd                   # the round that captured the graph
    t = big.t
    require(t.min() > 0, f"a slot never trained: t {t.tolist()}")
    for i in range(n):
        want = _bank_leaves(big.state, i)
        others = [("the eager bank", eager.state, i),
                  ("the 1-seed bank", ones[i].state, 0),
                  ("the standalone DQN", dqns[i].state, 0)]
        if i < p:
            others.append((f"the {p}-seed bank", part.state, i))
        for what, st, j in others:
            require(all(torch.equal(a, b) for a, b in
                        zip(want, _bank_leaves(st, j))),
                    f"slot {i} of the {n}-seed bank differs from {what}")
        require(big.eps[i] == dqns[i].eps == ones[i].eps[0],
                f"slot {i}: epsilon differs")
    return {"slots": n, "part": p, "rounds": BANK["rounds"], "k": k,
            "features": F, "actions": A, "t": t.tolist(),
            "graph_ms": ms["graph"], "eager_ms": ms["eager"], "first": first,
            "seconds": time.perf_counter() - t_all}


def phase23_figs() -> int:
    """Phase 23 (b), a process on the card: the bank check, then each of
    ``BENCH_FIGS``'s ``main()`` with its output, wall clock, allocations on
    the card and launches, and bench_sw_dse's metrics; one JSON line."""
    import torch
    require(torch.cuda.is_available(), "no CUDA device for phase 23 (b)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    allocs = lambda: torch.cuda.memory_stats().get(  # noqa: E731
        "allocation.all.allocated", 0)
    res = {"bank": check_bank(torch)}
    for name in BENCH_FIGS:
        _read_launches(reset=True)
        a0 = allocs()
        out, sec, code = _run_script(name)
        res[name] = {"out": out, "seconds": sec, "exit": code,
                     "allocations": allocs() - a0,
                     "launches": _read_launches()}
    res["bench_sw_dse"]["metrics"] = importlib_attr("bench_sw_dse",
                                                    "LAST_METRICS")
    print(json.dumps(res))
    return 0


def importlib_attr(name: str, attr: str):
    """``repro_torch.bench.<name>.<attr>``."""
    import importlib
    return getattr(importlib.import_module(f"repro_torch.bench.{name}"), attr)


def phase23_cpu() -> int:
    """Phase 23 (d), a process with the card hidden: bench_serve_tp's
    8-way scenario (8 gloo ranks) and its codesign scenario on the CPU,
    then bench_acquisition; one JSON line."""
    from repro_torch.bench import bench_serve_tp

    t0 = time.perf_counter()
    m8 = bench_serve_tp.run_tp8(store_dir=BENCH_DIR / "tp8")
    m8.pop("outs")
    mc = bench_serve_tp.run_codesign("cpu")
    seconds = time.perf_counter() - t0
    scripts = {}
    for name in BENCH_HOST:
        out, sec, code = _run_script(name, "cpu")
        scripts[name] = {"out": out, "seconds": sec, "exit": code,
                         "metrics": importlib_attr(name, "LAST_METRICS")}
    print(json.dumps({"tp8": m8, "codesign": mc, "seconds": seconds,
                      "scripts": scripts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
