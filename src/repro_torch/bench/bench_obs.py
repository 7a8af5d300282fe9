"""Observability overhead gate (DESIGN.md §13).

The observability layer's contract is that it may be left ON in serving
without changing results or meaningfully costing throughput.  This bench
runs the ROADMAP 10:1 short/long mixed scenario on the paged engine twice —
tracing disabled vs enabled (full lifecycle instrumentation: spans around
every decode/prefill step, per-request instants, queue/TTFT histograms,
page-pool gauges) — and gates:

  * traced tokens/s >= 0.97x untraced (best-of-2 each, interleaved so
    neither side systematically benefits from cache warmth);
  * per-request outputs BIT-IDENTICAL between the two runs (tracing must
    never perturb the math);
  * the exported trace replays every request's lifecycle: submit ->
    admit -> (preempt/resume)* -> retire, in order, with the trace's
    preempt count matching each request's ``preemptions`` field;
  * the exported telemetry artifact passes schema validation.

Prints CSV; merges metrics into ``artifacts/torch_bench_results.json``, and
exports the traced run to ``artifacts/torch_telemetry.json`` and
``artifacts/torch_trace.json``.  Port of ``benchmarks/bench_obs.py``, with
``bench_serve``'s model and flags (``--device``, ``--full-width``).

    PYTHONPATH=src python -m repro_torch.bench.bench_obs [--device cpu]
    PYTHONPATH=src python -m repro_torch.bench.bench_obs --full-width
"""
from __future__ import annotations

import time
from pathlib import Path

# the bench_serve mixed scenario: identical physical KV budget to 4 pinned
# slots x 48 rows, spent on 8 paged slots (see bench_serve.py)
N_REQUESTS = 22
MAX_NEW = 8
SLOTS = 8
PAGE_SIZE = 8
N_PAGES = 24
PREFILL_CHUNK = 16
LONG_EVERY = 11

MIN_RATIO = 0.97
ROUNDS = 2          # best-of-N per side, interleaved

ART_DIR = Path(__file__).resolve().parents[3] / "artifacts"

LAST_METRICS: dict = {}


def _serve(cfg, params):
    from repro_torch.bench.bench_serve import _impl
    from repro_torch.launch.serve import make_requests, serve_requests

    reqs = make_requests(cfg, N_REQUESTS, MAX_NEW, seed=0,
                         long_every=LONG_EVERY)
    t0 = time.perf_counter()
    done, stats = serve_requests(cfg, params, reqs, slots=SLOTS,
                                 impl=_impl(params), paged=True,
                                 page_size=PAGE_SIZE,
                                 n_pages=N_PAGES,
                                 prefill_chunk=PREFILL_CHUNK)
    dt = time.perf_counter() - t0
    return sorted(done, key=lambda r: r.rid), stats, dt


def _lifecycle_defects(tracer, done) -> list[str]:
    """Replay every request's lifecycle from the trace; [] == clean."""
    from repro_torch.obs.trace import ARGS, NAME

    life: dict[int, list[str]] = {}
    for ev in tracer.events():
        if ev[NAME].startswith("req."):
            life.setdefault(ev[ARGS]["rid"], []).append(
                ev[NAME].removeprefix("req."))
    defects = []
    by_rid = {r.rid: r for r in done}
    if set(life) != set(by_rid):
        defects.append(f"traced rids {sorted(life)} != served "
                       f"{sorted(by_rid)}")
        return defects
    for rid, seq in sorted(life.items()):
        req = by_rid[rid]
        if seq[0] != "submit" or seq[-1] != "retire":
            defects.append(f"rid {rid}: lifecycle {seq} does not run "
                           f"submit..retire")
        if seq.count("admit") != 1:
            defects.append(f"rid {rid}: {seq.count('admit')} fresh admits")
        if seq.count("preempt") != req.preemptions:
            defects.append(f"rid {rid}: trace has {seq.count('preempt')} "
                           f"preempts, engine counted {req.preemptions}")
        if seq.count("resume") != seq.count("preempt"):
            defects.append(f"rid {rid}: {seq.count('preempt')} preempts vs "
                           f"{seq.count('resume')} resumes (all requests "
                           f"finished, so these must pair)")
        if "first_token" not in seq:
            defects.append(f"rid {rid}: no first_token event")
    return defects


def run(cfg=None, params=None, device="cuda", art_dir=None) -> dict:
    from repro_torch import obs
    from repro_torch.bench.bench_serve import model
    from repro_torch.obs.export import validate_telemetry_file

    if cfg is None:
        cfg, params = model(device)

    _serve(cfg, params)                       # warm every shape

    # interleaved best-of-N: off, on, off, on ...
    t_off, t_on = [], []
    outs_off = outs_on = None
    preemptions = 0
    last_state = None
    tokens = 0
    for _ in range(ROUNDS):
        obs.disable()
        done, stats, dt = _serve(cfg, params)
        outs_off = [r.out for r in done]
        tokens = stats["generated"]
        t_off.append(dt)

        last_state = obs.enable()
        done, stats, dt = _serve(cfg, params)
        outs_on = [r.out for r in done]
        done_on = done
        preemptions = stats["preemptions"]
        t_on.append(dt)
    obs.disable()

    identical = outs_off == outs_on
    defects = _lifecycle_defects(last_state.tracer, done_on)

    # export + validate through the real artifact path
    art = Path(art_dir) if art_dir is not None else ART_DIR
    from repro_torch.obs.export import export_chrome_trace, export_telemetry
    tpath = export_telemetry(last_state.tracer, last_state.metrics,
                             art / "torch_telemetry.json")
    export_chrome_trace(last_state.tracer, art / "torch_trace.json")
    schema_errs = validate_telemetry_file(tpath)

    tok_off = tokens / min(t_off)
    tok_on = tokens / min(t_on)
    return {
        "requests": N_REQUESTS, "max_new": MAX_NEW, "rounds": ROUNDS,
        "preemptions": preemptions,
        "trace_events": len(last_state.tracer),
        "trace_dropped": last_state.tracer.dropped,
        "metrics_instruments": len(last_state.metrics),
        "tok_s_untraced": round(tok_off, 1),
        "tok_s_traced": round(tok_on, 1),
        "overhead_ratio": round(tok_on / tok_off, 4),
        "outputs_identical": identical,
        "lifecycle_defects": defects,
        "schema_errors": schema_errs,
    }


def main(argv=None) -> None:
    global LAST_METRICS
    from repro_torch.bench._results import publish
    from repro_torch.bench.bench_serve import model, parse_args

    args = parse_args(argv, __doc__.splitlines()[0])
    cfg, params = model(args.device, args.full_width)
    m = run(cfg, params)
    m.update(model=cfg.name, dtype=cfg.dtype, device=args.device)
    m["pass"] = bool(m["outputs_identical"]
                     and m["overhead_ratio"] >= MIN_RATIO
                     and not m["lifecycle_defects"]
                     and not m["schema_errors"])
    LAST_METRICS = m
    print("bench,case,tok_s_untraced,tok_s_traced,ratio,detail")
    print(f"bench_obs,mixed_10to1_paged_{SLOTS}slots,"
          f"{m['tok_s_untraced']},{m['tok_s_traced']},"
          f"{m['overhead_ratio']},"
          f"identical={m['outputs_identical']}_events={m['trace_events']}"
          f"_preemptions={m['preemptions']}")
    publish("bench_obs", m, failed=not m["pass"])
    if not m["pass"]:
        raise SystemExit(
            f"bench_obs gate FAILED: ratio {m['overhead_ratio']} "
            f"(need >= {MIN_RATIO}), identical={m['outputs_identical']}, "
            f"lifecycle_defects={m['lifecycle_defects']}, "
            f"schema_errors={m['schema_errors']}")


if __name__ == "__main__":
    main()
