"""Spans inside the port's prefill forward (``repro_torch.obs``, DESIGN.md
§13): the profiler as a second switch, the profiled session kept after it
stops, the shared clock and device spans.

A tiny rwkv6 through ``make_prefill_step(impl="torch")`` on the CPU; one
test marked ``cuda`` times device spans by CUDA events on the card.  This
file imports neither JAX nor the reference package, so it also runs on the
card's machine:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_obs_spans.py
"""
import json
import time
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import reduced, rwkv6, zamba2
from repro_torch.obs.export import snapshot, validate_telemetry
from repro_torch.obs.trace import ARGS, DEPTH, DUR, NAME, PH, TS

NAMES = ("prefill.forward", "rwkv6.time_mix", "rwkv6.channel_mix",
         "ops.rwkv6")
DEPTHS = {"prefill.forward": 0, "rwkv6.time_mix": 1, "rwkv6.channel_mix": 1,
          "ops.rwkv6": 2}


@pytest.fixture
def model():
    obs.disable()
    cfg = reduced(get_config("rwkv6-3b"), dtype="float32")
    params = rwkv6.init(cfg, 0, device="cpu")
    step = make_prefill_step(cfg, impl="torch")
    tokens = torch.randint(0, cfg.vocab, (1, 24),
                           generator=torch.Generator().manual_seed(5))
    yield cfg, params, lambda: step(params, {"tokens": tokens})
    obs.disable()


def _forward_profiled(forward, tmp_path):
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        out = forward()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return out, json.loads(path.read_text())


def test_nothing_records_without_a_session_or_the_profiler(model):
    _, _, forward = model
    assert obs.span("x", device=torch.device("cpu")) is obs.NULL_SPAN
    assert obs.recording() is None
    with torch.no_grad():
        forward()
    assert obs.profiled() is None and obs.state() is None


def test_a_profiled_forward_records_its_spans_nested(model, tmp_path):
    cfg, _, forward = model
    _forward_profiled(forward, tmp_path)
    st = obs.profiled()
    assert st is not None and obs.state() is None
    evs = st.tracer.events()
    assert Counter(e[NAME] for e in evs) == {
        "prefill.forward": 1, **{n: cfg.n_layers for n in NAMES[1:]}}
    assert len(evs) == 1 + 3 * cfg.n_layers
    for e in evs:
        assert e[PH] == "X" and e[DEPTH] == DEPTHS[e[NAME]]
        assert e[ARGS]["device_ms"] == pytest.approx(e[DUR] / 1e3)
    # each span lies inside its parent: the forward holds every block half,
    # each time mix holds its layer's kernel op
    fwd = next(e for e in evs if e[NAME] == "prefill.forward")
    assert fwd[ARGS]["forward"] == 0 and fwd[ARGS]["seq"] == 24

    def inside(child, parent):
        return parent[TS] <= child[TS] and \
            child[TS] + child[DUR] <= parent[TS] + parent[DUR]
    halves = {(e[NAME], e[ARGS]["layer"]): e for e in evs
              if e[NAME].startswith("rwkv6.")}
    assert sorted(halves) == sorted(
        (n, i) for n in NAMES[1:3] for i in range(cfg.n_layers))
    assert all(inside(e, fwd) for e in halves.values())
    ops_ = sorted((e for e in evs if e[NAME] == "ops.rwkv6"),
                  key=lambda e: e[TS])
    for i, e in enumerate(ops_):
        assert inside(e, halves["rwkv6.time_mix", i])
        assert tuple(e[ARGS]["r"]) == (1, 24, cfg.d_model // cfg.rwkv_head_dim,
                                       cfg.rwkv_head_dim) \
            and e[ARGS]["implementation"] == "torch"
    # the session keeps the spans after the profiler stops; a second
    # profiled forward adds to it, and disable() drops it
    _forward_profiled(forward, tmp_path)
    evs = obs.profiled().tracer.events()
    assert [e[ARGS]["forward"] for e in evs
            if e[NAME] == "prefill.forward"] == [0, 1]
    obs.disable()
    assert obs.profiled() is None


def test_spans_are_profiler_ranges_on_the_profilers_clock(model, tmp_path):
    _, _, forward = model
    _, doc = _forward_profiled(forward, tmp_path)
    base_us = doc["baseTimeNanoseconds"] / 1e3
    ranges: dict = {}
    for e in doc["traceEvents"]:
        if e.get("cat") == "user_annotation" and e["name"] in NAMES:
            ranges.setdefault(e["name"], []).append(
                (e["ts"] + base_us, e["ts"] + base_us + e["dur"]))
    spans: dict = {}
    for e in obs.profiled().tracer.events():
        spans.setdefault(e[NAME], []).append((e[TS], e[TS] + e[DUR]))
    assert set(ranges) == set(NAMES)
    for name in NAMES:
        assert len(ranges[name]) == len(spans[name])
        for (s0, s1), (r0, r1) in zip(sorted(spans[name]),
                                      sorted(ranges[name])):
            assert abs(s0 - r0) < 500 and abs(s1 - r1) < 500, name


def test_logits_are_the_same_off_under_a_session_and_profiled(model,
                                                              tmp_path):
    _, _, forward = model
    with torch.no_grad():
        off = forward()
    st = obs.enable()
    with torch.no_grad():
        on = forward()
    assert obs.profiled() is None
    profiled, _ = _forward_profiled(forward, tmp_path)
    assert torch.equal(off, on) and torch.equal(off, profiled)
    # under a session the spans go there, the profiler or not
    assert obs.profiled() is None
    assert Counter(e[NAME] for e in st.tracer.events())["prefill.forward"] \
        == 2
    doc = snapshot(st.tracer, st.metrics)
    assert validate_telemetry(doc) == []
    assert doc["metrics"]["counters"]["prefill.forwards"]["value"] == 2


def test_a_zamba2_forward_records_its_layers_and_kernel_ops(tmp_path):
    """zamba2's published form (small): a profiled forward records one
    ``zamba2.mamba`` span a layer around its ``ops.mamba2`` span and one
    ``zamba2.shared`` span a hybrid call around its ``ops.attention``
    span, and counts both; unprofiled, nothing records."""
    obs.disable()
    cfg = reduced(get_config("zamba2-7b"), dtype="float32")
    params = zamba2.init(cfg, 0, device="cpu")
    step = make_prefill_step(cfg, impl="torch")
    tokens = torch.randint(0, cfg.vocab, (1, 20),
                           generator=torch.Generator().manual_seed(7))
    try:
        with torch.no_grad():
            off = step(params, {"tokens": tokens})
        assert obs.profiled() is None and obs.state() is None
        on, _ = _forward_profiled(lambda: step(params, {"tokens": tokens}),
                                  tmp_path)
        assert torch.equal(off, on)
        st = obs.profiled()
        evs = st.tracer.events()
        calls = len(cfg.hybrid_layer_ids)
        assert Counter(e[NAME] for e in evs) == {
            "prefill.forward": 1, "zamba2.mamba": cfg.n_layers,
            "ops.mamba2": cfg.n_layers, "zamba2.shared": calls,
            "ops.attention": calls}
        depth = {"prefill.forward": 0, "zamba2.mamba": 1,
                 "zamba2.shared": 1, "ops.mamba2": 2, "ops.attention": 2}
        assert all(e[DEPTH] == depth[e[NAME]] for e in evs)
        spans = sorted(evs, key=lambda e: e[TS])
        for e in spans:
            if e[NAME].startswith("ops."):
                parent = max((p for p in spans if p[DEPTH] == 1
                              and p[TS] <= e[TS]), key=lambda p: p[TS])
                assert parent[NAME] == {"ops.mamba2": "zamba2.mamba",
                                        "ops.attention": "zamba2.shared"}[
                    e[NAME]]
                assert e[TS] + e[DUR] <= parent[TS] + parent[DUR]
        assert sorted(e[ARGS]["layer"] for e in evs
                      if e[NAME] == "zamba2.shared") == list(range(calls))
        assert tuple(next(e for e in evs if e[NAME] == "ops.mamba2")[ARGS][
            "b"])[2] == cfg.ssm_groups
        counters = st.metrics.snapshot()["counters"]
        assert counters["zamba2.mamba_layers"]["value"] == cfg.n_layers
        assert counters["zamba2.shared_calls"]["value"] == calls
    finally:
        obs.disable()


def test_a_serving_step_records_no_spans(model):
    """Only the whole-sequence forward records: decode steps and a slot's
    prefill, which carry state, record nothing under a session."""
    cfg, params, _ = model
    slot_prefill = make_prefill_step(cfg, impl="torch", cache_len=32)
    tokens = torch.randint(0, cfg.vocab, (1, 8),
                           generator=torch.Generator().manual_seed(6))
    st = obs.enable()
    with torch.no_grad():
        logits, cache = slot_prefill(params, tokens)
        cache = rwkv6.init_cache(cfg, 1, 32, device="cpu")
        rwkv6.decode_step(params, cfg, cache, tokens[:, :1],
                          torch.zeros(1, dtype=torch.int64), impl="torch")
    assert logits.shape[1] == 8 and len(st.tracer) == 0


class _Event:
    """A timing event whose card has passed it once ``synchronize`` ran."""
    made = 0

    def __init__(self, enable_timing=False):
        _Event.made += 1
        self.t, self.done = None, False

    def record(self, stream=None):
        self.t, self.done = time.perf_counter() * 1e3, False

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        assert end.done          # and so the start, recorded before it
        return end.t - self.t


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: 0)
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    _Event.made = 0
    obs.disable()
    yield capturing
    obs.disable()


def test_device_span_events_are_pooled_and_resolved_when_read(fake_cuda):
    dev = torch.device("cuda")
    st = obs.enable(capacity=4)
    for _ in range(2):
        with obs.span("a", device=dev):
            pass
    # nothing is read on the hot path: both pairs wait for the reading
    assert _Event.made == 4 and len(st.tracer._pending) == 2
    assert not any(e.done for _, _, pair in st.tracer._pending for e in pair)
    evs = st.tracer.events()
    assert [e[NAME] for e in evs] == ["a", "a"]
    assert all(e[ARGS]["device_ms"] >= 0 for e in evs)
    assert not st.tracer._pending and len(st.tracer._free[dev]) == 2
    # six more: two pairs from the pool, three new, then the first one's,
    # whose event the ring of four has dropped (nothing left to read)
    for _ in range(6):
        with obs.span("c", device=dev):
            pass
    first = st.tracer._pending[-1][2]
    assert _Event.made == 10 and len(st.tracer._pending) == 5
    assert all(first is not pair for _, _, pair in
               list(st.tracer._pending)[:-1])
    assert [e[NAME] for e in st.tracer.events()] == ["c"] * 4
    assert len(st.tracer._free[dev]) == 5


def test_device_start_moves_the_innermost_device_span_start(fake_cuda):
    dev = torch.device("cuda")
    st = obs.enable()
    obs.device_start()                       # no span open: nothing
    with obs.span("op", device=dev):
        start = st.tracer._stack()[-1]._marks[0]
        t0 = start.t
        time.sleep(0.02)                     # the op's checks
        with obs.span("host"):               # a host span inside it
            pass
        obs.device_start()                   # the launch
    assert start.t > t0 + 15
    (host, op), = [st.tracer.events()]
    assert (host[NAME], op[NAME]) == ("host", "op")
    assert "device_ms" not in (host[ARGS] or {})
    assert op[ARGS]["device_ms"] < 10 < op[DUR] / 1e3
    # while a CUDA graph is captured a device span records no events
    fake_cuda[0] = True
    with obs.span("captured", device=dev):
        obs.device_start()
    assert _Event.made == 2 and not st.tracer._pending
    assert "device_ms" not in (st.tracer.events()[-1][ARGS] or {})


@pytest.mark.cuda
def test_device_spans_time_cuda_work_by_events():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device spans time by CUDA events")
    obs.disable()
    dev = torch.device("cuda")
    a = torch.randn(2048, 2048, device=dev)
    st = obs.enable()
    try:
        for _ in range(3):
            with obs.span("mm", device=dev):
                for _ in range(8):
                    a = torch.tanh(a @ a * 1e-3)
        assert len(st.tracer._pending) == 3
        evs = st.tracer.events()
        assert len(evs) == 3 and all(e[ARGS]["device_ms"] > 0 for e in evs)
        assert not st.tracer._pending and len(st.tracer._free[dev]) == 3
        # a span started at its launch leaves the host's wait out
        with obs.span("late", device=dev):
            torch.cuda.synchronize()
            time.sleep(0.05)
            obs.device_start()
            a = a @ a
        late = st.tracer.events()[-1]
        assert late[ARGS]["device_ms"] < 25 < late[DUR] / 1e3
    finally:
        obs.disable()
