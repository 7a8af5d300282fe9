"""Traced stretches: ranges opened from the benchmark's own files, a
``torch.profiler`` capture, and its device time attributed by range.

Every device operation (kernel, copy, fill) is tied to the host call that
launched it by the profiler's correlation id, and that call to the host
ranges that were open around it.  So a kernel op's device time is the
time of whatever was launched inside the range around its entry point in
``repro_torch.kernels.ops``, whatever the kernels are named, and a matrix
product is whatever an ``aten`` matrix-product op launched.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field

from perfbench.counts import Meta

STRETCH = "perfbench.stretch"
STEP = "perfbench.step"
OP = "perfbench.op."
GEMM_OPS = frozenset({"aten::mm", "aten::bmm", "aten::addmm",
                      "aten::baddbmm", "aten::addbmm", "aten::mv",
                      "aten::addmv", "aten::dot", "aten::_scaled_mm"})
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
LAUNCH_CATS = frozenset({"cuda_runtime", "cuda_driver"})
RANGE_CATS = frozenset({"cpu_op", "user_annotation"})


@dataclass
class DeviceOp:
    name: str
    ts: float           # microseconds
    dur: float
    ranges: tuple       # names of the benchmark's ranges open at launch
    host_op: str        # innermost host op at launch ("" if none)


@dataclass
class Trace:
    ops: list = field(default_factory=list)
    stretch: tuple = (0.0, 0.0)              # (start, end), microseconds
    gaps: list = field(default_factory=list)  # (seconds, host activity)
    op_calls: dict = field(default_factory=dict)   # name -> [(args, kw)]

    @property
    def window_s(self) -> float:
        return (self.stretch[1] - self.stretch[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return _union(self._clipped()) * 1e-6

    def _clipped(self):
        t0, t1 = self.stretch
        return [(max(t0, o.ts), min(t1, o.ts + o.dur)) for o in self.ops
                if o.ts + o.dur > t0 and o.ts < t1]

    def device_s(self, pred) -> float:
        return sum(o.dur for o in self.ops if pred(o)) * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict[str, float] = {}
        for o in self.ops:
            by_name[o.name[:160]] = by_name.get(o.name[:160], 0.0) \
                + o.dur * 1e-6
        host: dict[str, float] = {}
        for sec, what in self.gaps:
            host[what] = host.get(what, 0.0) + sec
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in order(by_name)],
                "idle_gaps": [[k, v] for k, v in order(host)]}


def _union(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def parse(events: list) -> Trace:
    """A :class:`Trace` from a Chrome-trace event list of one stretch."""
    xs = [e for e in events if e.get("ph") == "X"]
    stretch = [e for e in xs if e.get("name") == STRETCH]
    if not stretch:
        raise ValueError("the trace holds no stretch range")
    s = stretch[0]
    tid = s.get("tid")
    # host side, per thread: ranges nest; a launch is a leaf
    by_tid: dict = {}
    for e in xs:
        cat = e.get("cat", "")
        if cat in RANGE_CATS or cat in LAUNCH_CATS:
            by_tid.setdefault(e.get("tid"), []).append(e)
    context: dict = {}            # correlation -> (ranges, innermost op)
    host_spans = []               # (start, end, name) on the stretch's
    for t, evs in by_tid.items():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0))))
        stack: list = []
        for e in evs:
            ts = float(e["ts"])
            while stack and float(stack[-1]["ts"]) \
                    + float(stack[-1].get("dur", 0)) <= ts:
                stack.pop()
            if e.get("cat") in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    names = tuple(x["name"] for x in stack)
                    ops = [n for n, x in zip(names, stack)
                           if x.get("cat") == "cpu_op"]
                    context[corr] = (tuple(n for n in names
                                           if n.startswith("perfbench.")),
                                     ops[-1] if ops else "")
                continue
            if t == tid:
                host_spans.append((ts, ts + float(e.get("dur", 0)),
                                   e["name"]))
            stack.append(e)
    tr = Trace(stretch=(float(s["ts"]), float(s["ts"]) + float(s["dur"])))
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        corr = (e.get("args") or {}).get("correlation")
        ranges, host_op = context.get(corr, ((), ""))
        tr.ops.append(DeviceOp(e["name"], float(e["ts"]),
                               float(e.get("dur", 0)), ranges, host_op))
    tr.gaps = _gaps(tr, host_spans)
    return tr


def _gaps(tr: Trace, host_spans) -> list:
    """(seconds, what the host was doing) of each stretch of the device's
    idleness: the innermost host range open at the gap's middle.  The
    host ranges of one thread nest, so one sweep keeps the open ones on a
    stack."""
    t0, t1 = tr.stretch
    gaps, at = [], t0
    for a, b in sorted(tr._clipped()):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if t1 > at:
        gaps.append((at, t1))
    spans = sorted(((s, e, n) for s, e, n in host_spans if n != STRETCH),
                   key=lambda x: (x[0], -x[1]))
    out, stack, i = [], [], 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) / 2
        while i < len(spans) and spans[i][0] <= mid:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        out.append(((b - a) * 1e-6,
                    stack[-1][2] if stack else "host outside any op"))
    return out


@contextlib.contextmanager
def op_ranges(trace_calls: dict, names=("attention", "mamba2", "rwkv6")):
    """While open, each of ``repro_torch.kernels.ops``'s entry points in
    ``names`` runs inside a profiler range of its own, and the shapes of
    each call's tensor arguments (``Meta``, None for others) and its
    scalar keywords are appended to ``trace_calls[name]``."""
    import torch
    from repro_torch.kernels import ops

    saved = {n: getattr(ops, n) for n in names}

    def wrap(name, fn):
        def call(*args, **kwargs):
            trace_calls.setdefault(name, []).append((
                [Meta.of(a) if isinstance(a, torch.Tensor) else None
                 for a in args],
                {k: v for k, v in kwargs.items()
                 if isinstance(v, (bool, int, float))}))
            with torch.profiler.record_function(OP + name):
                return fn(*args, **kwargs)
        return call
    for n, fn in saved.items():
        setattr(ops, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def capture(run_stretch, device) -> Trace:
    """Profile ``run_stretch()`` (device and host) inside the stretch
    range, after a short capture that is thrown away (the profiler's own
    start-up), and parse it.  The trace is written to a temporary file
    under ``TMPDIR`` and removed."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()
    with profile(activities=acts):
        sync()
    sync()
    with profile(activities=acts) as prof:
        with record_function(STRETCH):
            run_stretch()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return parse(events)
