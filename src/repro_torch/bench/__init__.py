"""The paper's experiment scripts and the system's gates on the port: one
module per script of ``benchmarks/`` (reference name, constants,
``run(...)``/``main()`` split, CSV columns and ``LAST_METRICS`` keys), run
as ``python -m repro_torch.bench.<name>``.  Every script takes ``--device``
(default ``cuda``; it raises where there is no card unless given ``--device
cpu``): the software DSE's DQNs, the serving engines' kernels and the
tuner's measurements run there.

| module | paper artifact | output |
|---|---|---|
| ``fig7_intrinsics`` | Fig. 7 | normalized throughput per (workload family × intrinsic) at the 64-PE + 256 KiB budget |
| ``fig10_hw_dse`` | Fig. 10 + Table II | hypervolume-vs-trial curves, MOBO / NSGA-II / random (3-seed means), and constrained best latency per method |
| ``fig11_sw_dse`` | Fig. 11 + §VII-D | per-layer latency under library (im2col), template and HASCO software on a fixed GEMMCore |
| ``table3_codesign`` | Table III | co-design vs decoupled latency under edge (2 W) / cloud (20 W) power |
| ``ablation_qlearning`` | §VI-B | Q-learning vs random revision at equal evaluation budgets |
| ``kernel_micro`` | — | the ``gemm``, ``flash_attention``, ``rwkv6`` and ``mamba2`` kernels at the reference's shapes: µs a call by CUDA events and by CUDA-graph replay, the plain version's, GFLOP/s and the bound |
| ``bench_batched_eval`` | — | batched vs scalar cost-model evaluation (≥ 10× gate) |
| ``bench_acquisition`` | — | the vectorized Pareto/HVI engine vs per-candidate loops (≥ 10× gate, hypervolume parity) |
| ``bench_sw_dse`` | — | the batched DQN bank vs the per-search engine (≥ 5× gate, bit-exact parity, the same ``codesign(q=4)`` solution) |
| ``bench_calibration`` | — | Spearman of analytical vs measured latency, before and after calibration, over 64 GEMM candidates timed through the ``gemm`` kernel |
| ``bench_serve`` | — | continuous batching vs sequential (≥ 2×, identical outputs) and the paged 10:1 mix (≥ 2×, p95 queue latency below pinned, identical outputs) |
| ``bench_obs`` | — | traced vs untraced paged serving (≥ 0.97×, identical outputs, lifecycle replay, telemetry schema) |
| ``bench_serve_tp`` | — | a ``model=1`` mesh bit for bit, 8 gloo ranks token for token, TP-aware codesign differing from TP-blind |
| ``run`` | — | all of the above in the reference's order, into ``artifacts/torch_bench_results.json`` |

The serving scripts take ``--full-width``: the published qwen3-8b config in
float32, on the card only.
"""
