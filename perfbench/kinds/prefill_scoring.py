"""Prefill scoring: one client scores documents one after another (a
closed loop).  A request is a (batch, seq_len) block of token ids; the
program's full-sequence forward (``make_prefill_step``) gives the logits,
and the client takes each position's log-probability of the next token
into host memory.

Set-up: weights drawn on the device from the seed, the step built, and
``warmup`` requests of the cell's own shape from a stream of their own.
Window: requests back to back until ``--seconds`` have passed; a
request's latency runs from its submission to its log-probabilities on the
host.  Traced runs then profile ``traced`` more requests.  The check:
``check_sample`` of the window's requests (the last among them), drawn
from the seed, scored again by the plain float32 reference on weights
drawn again from the seed, after the program's weights are freed.
"""
from __future__ import annotations

import contextlib
import math
import time
from types import SimpleNamespace

from perfbench import counts, traffic, weights
from perfbench import trace as tr
from perfbench.reference import common as C


def next_token_logprobs(logits, tokens):
    """(B, S-1) float32: log p(tokens[:, t+1] | ..t) from logits (B, S,
    V)."""
    import torch

    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    return lp.gather(-1, tokens[:, 1:, None])[..., 0]


def compare(got, want) -> dict:
    """The numbers of one row of log-probabilities against the
    reference's: ``logprob_decorrelation``, 1 - the Pearson correlation of
    the two rows (for rows of equal spread, the mean squared gap over
    twice their variance); ``logprob_rms_gap`` and ``logprob_max_gap``,
    the RMS and largest absolute gap.  Infinite where a row is not
    finite."""
    import torch

    got, want = got.double(), want.double()
    gap = got - want
    g, w = got - got.mean(), want - want.mean()
    corr = (g * w).sum() / torch.sqrt((g * g).sum() * (w * w).sum())
    out = {"logprob_decorrelation": float(1.0 - corr),
           "logprob_rms_gap": float(torch.sqrt((gap * gap).mean())),
           "logprob_max_gap": float(gap.abs().max())}
    if not all(math.isfinite(v) for v in out.values()):
        return {k: math.inf for k in out}
    return out


def worst(rows: list[dict]) -> dict:
    return {k: max(r[k] for r in rows) for k in rows[0]}


def build(model: dict, ref, seed: int, dev):
    """The program's side: (weights drawn from the seed, the prefill step
    with the hand-written kernels, or the plain versions on the CPU)."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.config import ModelConfig

    params = weights.make(ref.param_tree(model), seed, dev)
    step = make_prefill_step(ModelConfig(**model),
                             impl="cuda" if dev.type == "cuda" else "torch")
    return params, step


def run(run, ref, limits, *, device, trace, t_start, fault=None):
    import torch

    dev = torch.device(device)
    model, mix = run.config["model"], run.traffic
    spec = ref.param_tree(model)
    marks = run.marks
    marks["harness_s"] = time.perf_counter()
    if dev.type == "cuda":
        from repro_torch.kernels import cuda_lib
        cuda_lib.build()      # nvcc on a checkout's first run
    marks["build_s"] = time.perf_counter()
    params, step = build(model, ref, run.seed, dev)
    if fault is not None:
        step = fault(step, SimpleNamespace(ref=ref, model=model, spec=spec,
                                           seed=run.seed, device=dev))
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    sync()
    marks["weights_s"] = time.perf_counter()
    stream = traffic.TokenStream(mix, run.seed, model["vocab"])
    batch, seq = stream.shape

    def request(ids, ranges=False):
        tokens = torch.from_numpy(ids).to(dev)
        opened = torch.profiler.record_function(tr.STEP) if ranges \
            else contextlib.nullcontext()
        t0 = time.perf_counter()
        with torch.no_grad(), opened:
            logits = step(params, {"tokens": tokens})
        t1 = time.perf_counter()
        with torch.no_grad():
            host = next_token_logprobs(logits, tokens).cpu()
        return host, t1 - t0

    warm = traffic.TokenStream(mix, run.seed, model["vocab"],
                               stream="warmup")
    for i in range(int(mix["warmup"])):
        request(warm.get(i))
    sync()
    marks["warmup_s"] = time.perf_counter()
    run.setup_s = marks["warmup_s"] - t_start
    at = t_start
    for part, t in marks.items():
        run.setup_parts[part] = t - at
        at = t

    outputs = []
    t0 = time.perf_counter()
    while True:
        ids = stream.get(len(outputs))
        t_sub = time.perf_counter()
        if outputs and t_sub - t0 >= run.seconds:
            break
        host, enq = request(ids)
        t_done = time.perf_counter()
        outputs.append(host)
        run.latencies_s.append(t_done - t_sub)
        run.enqueue_s.append(enq)
    run.window_s = t_done - t0
    run.requests = len(outputs)
    run.tokens = run.requests * batch * seq
    run.flops_per_request = batch * counts.model_flops(
        weights.matmul_params(spec), ref.seq_ops(model, seq), seq)
    run.device = device_info(torch, dev)
    run.peak = counts.peaks(run.device["kind"]) if dev.type == "cuda" else {}

    if trace:
        calls: dict = {}
        k = int(mix["traced"])

        def stretch():
            with tr.op_ranges(calls):
                for j in range(k):
                    request(stream.get(run.requests + j), ranges=True)
        run.trace = tr.capture(stretch, dev)
        run.trace.op_calls = calls
        run.traced_requests = k
        run.device.update(busy_s=run.trace.busy_s,
                          window_s=run.trace.window_s)

    # the check, on weights drawn again once the program's are freed
    del params, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with torch.no_grad(), C.no_tf32():
        wref = weights.make(spec, run.seed, dev)
        for i in traffic.sample(run.seed, run.requests,
                                int(mix["check_sample"])):
            ids = torch.from_numpy(stream.get(i)).to(dev)
            want = [C.next_token_logprobs(ref.forward(wref, model, row), row)
                    .cpu() for row in ids]
            run.compared += list(zip(outputs[i], want))
    run.numbers = worst([compare(got, w) for got, w in run.compared])
    run.checks = [(name, run.numbers[name], lim["limit"])
                  for name, lim in limits.items()]


def device_info(torch, dev) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(dev)}
