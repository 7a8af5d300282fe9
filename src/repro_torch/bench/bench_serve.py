"""Serving-throughput benchmark: continuous batching and paged KV against
the sequential one-request-at-a-time lower bound (DESIGN.md §11-12).

Two scenarios:

  * ``uniform``: 12 mixed-short requests, the slot-pinned engine at 4
    slots vs itself at ``max_concurrency=1`` — same compiled step
    functions both sides, so the speedup is pure slot occupancy.
  * ``mixed``: the ROADMAP 10:1 short/long traffic mix.  The paged engine
    gets the SAME physical KV budget as the slot-pinned engine but spends
    it on twice the slots (short requests only hold the pages they use),
    so queue latency — not just throughput — is the headline metric.

Gates (exit 1 on miss):
  * uniform: >= 2x generated tokens/s at 4 slots over sequential AND
    identical per-request outputs (batching changes wall-clock, never
    content)
  * mixed: paged >= 2x tokens/s over sequential AND paged p95 queue
    latency strictly below the slot-pinned engine's, with outputs
    identical across all three engines

Prints CSV; merges metrics into ``artifacts/torch_bench_results.json``
without running the whole ``repro_torch.bench.run`` suite.  Port of
``benchmarks/bench_serve.py``.  The model is the reference's reduced
qwen3-8b, drawn from seed 0 on ``--device`` (the card by default, where the
engines run the kernels; the CPU runs the plain versions).
``--full-width`` serves the published qwen3-8b config in float32 instead
(the card only): float32 because the engines' rows do not depend on one
another there, so the outputs-identical gates hold, where bfloat16 ties
could flip a token.

    PYTHONPATH=src python -m repro_torch.bench.bench_serve [--device cpu]
    PYTHONPATH=src python -m repro_torch.bench.bench_serve --full-width
"""
from __future__ import annotations

import dataclasses
import time

SLOTS = 4
MAX_SEQ = 48
N_REQUESTS = 12
MAX_NEW = 16
TARGET_SPEEDUP = 2.0

# mixed 10:1 short/long scenario (ROADMAP item 1): identical physical KV
# budget both ways — 4 slots x 48 rows pinned == 24 pages x 8 rows paged —
# but the paged engine spends it on 8 slots
MIX_N = 22
MIX_MAX_NEW = 8
MIX_SLOTS_PAGED = 8
MIX_PAGE_SIZE = 8
MIX_N_PAGES = SLOTS * MAX_SEQ // MIX_PAGE_SIZE
MIX_PREFILL_CHUNK = 16

LAST_METRICS: dict = {}


def model(device="cuda", full_width: bool = False):
    """(cfg, params): the reference's reduced qwen3-8b in its own dtype,
    or with ``full_width`` the published config in float32, its weights
    drawn from seed 0 on ``device``."""
    from repro_torch.configs import get_config
    from repro_torch.models import family_module, reduced

    cfg = get_config("qwen3-8b")
    if full_width:
        if not str(device).startswith("cuda"):
            raise ValueError("--full-width runs on the card only")
        cfg = dataclasses.replace(cfg, dtype="float32")
    else:
        cfg = reduced(cfg)
    return cfg, family_module(cfg).init(cfg, seed=0, tp=1, device=device)


def _impl(params) -> str:
    """The kernels where the params lie on the card, else the plain
    versions."""
    from repro_torch.bench._results import impl_for

    return impl_for(params["embed"]["table"].device)


def _requests(cfg):
    import numpy as np

    from repro_torch.launch.serve import Request

    rng = np.random.default_rng(0)
    # mixed prompt lengths over a small fixed set so both timed runs reuse
    # the same prefill shapes
    lengths = [4, 7, 11, 5, 9, 6] * 3
    return [Request(i, rng.integers(0, cfg.vocab, size=lengths[i])
                    .astype(np.int32), MAX_NEW) for i in range(N_REQUESTS)]


def _serve(cfg, params, *, max_concurrency=None):
    from repro_torch.launch.serve import serve_requests

    t0 = time.perf_counter()
    done, stats = serve_requests(cfg, params, _requests(cfg), slots=SLOTS,
                                 max_seq=MAX_SEQ, impl=_impl(params),
                                 max_concurrency=max_concurrency)
    return done, stats, time.perf_counter() - t0


def _mixed_requests(cfg):
    from repro_torch.launch.serve import make_requests

    return make_requests(cfg, MIX_N, MIX_MAX_NEW, seed=0, long_every=11)


def _serve_mixed(cfg, params, mode):
    from repro_torch.launch.serve import serve_requests

    kw = dict(max_seq=MAX_SEQ, impl=_impl(params))
    if mode == "sequential":
        kw.update(slots=SLOTS, max_concurrency=1)
    elif mode == "pinned":
        kw.update(slots=SLOTS)
    else:                                     # paged: same budget, 8 slots
        kw.update(slots=MIX_SLOTS_PAGED, paged=True,
                  page_size=MIX_PAGE_SIZE, n_pages=MIX_N_PAGES,
                  prefill_chunk=MIX_PREFILL_CHUNK)
    t0 = time.perf_counter()
    done, stats = serve_requests(cfg, params, _mixed_requests(cfg), **kw)
    return done, stats, time.perf_counter() - t0


def run_mixed(cfg, params) -> dict:
    for mode in ("sequential", "pinned", "paged"):  # warm every shape
        _serve_mixed(cfg, params, mode)

    out = {}
    for mode in ("sequential", "pinned", "paged"):
        done, stats, dt = _serve_mixed(cfg, params, mode)
        done = sorted(done, key=lambda r: r.rid)
        out[mode] = {
            "outs": [r.out for r in done],
            "tok_s": stats["generated"] / dt,
            # the engine's own latency summary (submit -> first token);
            # same quantity the old ad-hoc np.percentile scan computed
            "p95_queue_s": stats["ttft_s"]["p95"],
            "preemptions": stats.get("preemptions", 0),
        }
    same = (out["paged"]["outs"] == out["pinned"]["outs"]
            == out["sequential"]["outs"])
    return {
        "requests": MIX_N, "max_new": MIX_MAX_NEW,
        "long_every": 11, "page_size": MIX_PAGE_SIZE,
        "n_pages": MIX_N_PAGES, "slots_paged": MIX_SLOTS_PAGED,
        "slots_pinned": SLOTS,
        "tok_s_sequential": round(out["sequential"]["tok_s"], 1),
        "tok_s_pinned": round(out["pinned"]["tok_s"], 1),
        "tok_s_paged": round(out["paged"]["tok_s"], 1),
        "speedup_paged": round(out["paged"]["tok_s"]
                               / out["sequential"]["tok_s"], 2),
        "p95_queue_pinned_s": round(out["pinned"]["p95_queue_s"], 4),
        "p95_queue_paged_s": round(out["paged"]["p95_queue_s"], 4),
        "preemptions": out["paged"]["preemptions"],
        "outputs_identical": same,
    }


def run(cfg=None, params=None, device="cuda") -> dict:
    if cfg is None:
        cfg, params = model(device)

    _serve(cfg, params)                       # warm every shape
    _serve(cfg, params, max_concurrency=1)

    done_b, stats_b, t_b = _serve(cfg, params)
    done_s, stats_s, t_s = _serve(cfg, params, max_concurrency=1)

    tok_s_batched = stats_b["generated"] / t_b
    tok_s_seq = stats_s["generated"] / t_s
    same = [r.out for r in done_b] == [r.out for r in done_s]
    return {
        "slots": SLOTS, "requests": N_REQUESTS, "max_new": MAX_NEW,
        "tokens": stats_b["generated"],
        "decode_steps_batched": stats_b["decode_steps"],
        "decode_steps_sequential": stats_s["decode_steps"],
        "tok_s_batched": round(tok_s_batched, 1),
        "tok_s_sequential": round(tok_s_seq, 1),
        "speedup": round(tok_s_batched / tok_s_seq, 2),
        "outputs_identical": same,
    }


def parse_args(argv=None, description: str | None = None):
    """``--device`` and ``--full-width``, for every serving script."""
    import argparse

    from repro_torch.bench._results import parse_device

    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--full-width", action="store_true",
                    help="the published qwen3-8b config in float32 (the "
                         "card only)")
    return parse_device(argv, parser=ap)


def main(argv=None) -> None:
    global LAST_METRICS
    from repro_torch.bench._results import publish

    args = parse_args(argv, __doc__.splitlines()[0])
    cfg, params = model(args.device, args.full_width)
    m = run(cfg, params)
    m["pass"] = bool(m["outputs_identical"]
                     and m["speedup"] >= TARGET_SPEEDUP)

    mm = run_mixed(cfg, params)
    mm["pass"] = bool(mm["outputs_identical"]
                      and mm["speedup_paged"] >= TARGET_SPEEDUP
                      and mm["p95_queue_paged_s"]
                      < mm["p95_queue_pinned_s"])

    LAST_METRICS = {**m, "mixed": mm, "model": cfg.name,
                    "dtype": cfg.dtype, "device": args.device}
    print("bench,case,tok_s_sequential,tok_s_batched,speedup,detail")
    print(f"bench_serve,{SLOTS}slots_mixed_prompts,"
          f"{m['tok_s_sequential']},{m['tok_s_batched']},{m['speedup']},"
          f"identical={m['outputs_identical']}")
    print(f"bench_serve_mixed,10to1_paged_{MIX_SLOTS_PAGED}slots,"
          f"{mm['tok_s_sequential']},{mm['tok_s_paged']},"
          f"{mm['speedup_paged']},"
          f"p95_paged={mm['p95_queue_paged_s']}s_vs_pinned="
          f"{mm['p95_queue_pinned_s']}s_identical="
          f"{mm['outputs_identical']}")
    publish("bench_serve", m, failed=not m["pass"])
    publish("bench_serve_mixed", mm, failed=not mm["pass"])
    if not m["pass"]:
        raise SystemExit(
            f"bench_serve gate missed: speedup {m['speedup']} "
            f"(target {TARGET_SPEEDUP}) identical={m['outputs_identical']}")
    if not mm["pass"]:
        raise SystemExit(
            f"bench_serve_mixed gate missed: speedup {mm['speedup_paged']} "
            f"(target {TARGET_SPEEDUP}), p95 paged "
            f"{mm['p95_queue_paged_s']}s vs pinned "
            f"{mm['p95_queue_pinned_s']}s, "
            f"identical={mm['outputs_identical']}")


if __name__ == "__main__":
    main()
