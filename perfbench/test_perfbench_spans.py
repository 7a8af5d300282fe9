"""The readers of the program's own spans (``spans.py``: ``forward_ms``,
``time_mix_ms``, ``channel_mix_ms``, ``wkv_ms``) on a traced run.

On the CPU, at the tiny size of ``test_perfbench_runs.py``, the line leaves
them out (no card: a span's time is the host's) and the session they read
holds the traced requests' spans, nested as the forward runs them.  The
test marked ``chip`` reads them from the line at the cell's own size on the
card: ``wkv_ms`` (the span's device time, from the kernel's launch to the
op's exit) within 15% of the device time of the kernels that the range
around ``ops.rwkv6`` attributes to the op, and the trace's idle gaps named
by the program's spans, the innermost ranges now open there."""
import time

import pytest
import torch

from perfbench import harness, spans
from perfbench import trace as tr
from perfbench.test_perfbench_runs import PREFILL, TINY

METRICS = {"forward_ms.prefill": "prefill.forward",
           "time_mix_ms.prefill": "rwkv6.time_mix",
           "channel_mix_ms.prefill": "rwkv6.channel_mix",
           "wkv_ms.prefill": "ops.rwkv6"}


@pytest.fixture
def fresh():
    from repro_torch import obs

    obs.disable()
    yield
    obs.disable()


def _traced(cell, **kw):
    return harness.execute(cell, 31_000_000_019, 0.3, True,
                           time.perf_counter(), **kw)


def _ordered(ms):
    fwd, tm, cm, wkv = (ms[m] for m in METRICS)
    assert all(v > 0 for v in ms.values()), ms
    assert tm + cm <= fwd, ms
    assert wkv <= tm, ms


@pytest.mark.parametrize("cell", PREFILL)
def test_the_spans_of_a_traced_tiny_run(fresh, cell):
    run, line = _traced(cell, device="cpu", config_override=TINY["rwkv6"],
                        mix_override={"seq_len": 64})
    assert line["correct"] and not set(METRICS) & set(line["metrics"])
    events = spans.session_events()
    assert sum(e[1] == spans.FORWARD for e in events) \
        == run.traced_requests == 4
    layers = TINY["rwkv6"]["n_layers"] * run.traced_requests
    for name in list(METRICS.values())[1:]:
        assert sum(e[1] == name for e in events) == layers, name
    _ordered({m: spans.per_forward_ms(n, events)
              for m, n in METRICS.items()})


def test_nothing_to_read_gives_none(fresh, monkeypatch):
    from repro_torch import obs

    assert spans.session_events() is None
    assert spans.per_forward_ms("ops.rwkv6", None) is None
    assert spans.per_forward_ms("ops.rwkv6", []) is None
    # spans but no forward, a forward but none of the name
    one = [("X", "ops.rwkv6", 0.0, 1.0, 0, 0, {"device_ms": 1.0})]
    assert spans.per_forward_ms("ops.rwkv6", one) is None
    fwd = [("X", spans.FORWARD, 0.0, 9.0, 0, 0, {"device_ms": 9.0})]
    assert spans.per_forward_ms("ops.rwkv6", fwd) is None
    assert spans.per_forward_ms("ops.rwkv6", fwd + one * 2) == 2.0
    # a program that keeps no profiled session
    monkeypatch.delattr(obs, "profiled")
    assert spans.session_events() is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark runs only on one")


@pytest.mark.chip
@pytest.mark.parametrize("cell", PREFILL)
def test_the_spans_of_a_traced_run_on_the_card(card, fresh, cell):
    run, line = _traced(cell)
    assert line["correct"]
    _ordered({m: line["metrics"][m]["value"] for m in METRICS})
    outside = run.per_request_ms(lambda o: tr.OP + "rwkv6" in o.ranges)
    wkv = line["metrics"]["wkv_ms.prefill"]["value"]
    assert abs(wkv - outside) <= 0.15 * outside, (wkv, outside)
    gaps = {name for name, _ in line["breakdown"]["idle_gaps"]}
    assert gaps & set(METRICS.values()), gaps
