"""Unified tracing + metrics layer (DESIGN.md §13).

Off by default.  One module-level singleton (:func:`state`) guards every
instrumentation site in serving, co-design, and the tuner:

  * **disabled** (the default) — :func:`state` returns ``None`` and
    :func:`span`/:func:`instant` hand back a shared no-op, so an
    uninstrumented run pays one global read + ``is not None`` per site and
    allocates nothing (call sites that build ``args`` dicts or touch
    metrics must sit behind an ``if st is not None`` guard — the decode hot
    path's zero-allocation contract, gated by ``benchmarks/bench_obs.py``);
  * **enabled** (:func:`enable`) — spans land in a preallocated ring buffer
    (:mod:`repro.obs.trace`), instruments in a
    :class:`~repro.obs.metrics.MetricsRegistry`, and :func:`snapshot` /
    :func:`export_telemetry` / :func:`export_chrome_trace` turn the session
    into a schema-versioned ``artifacts/telemetry.json`` plus a
    Perfetto-viewable trace.

Instrumentation idioms::

    from repro_torch import obs

    with obs.span("serve.decode_step"):      # no-op CM when disabled
        ...
    st = obs.state()
    if st is not None:                       # guard dict/metric work
        st.tracer.instant("req.retire", {"rid": rid})
        st.metrics.counter("serve.preemptions").inc()
"""
from __future__ import annotations

from .metrics import (DEFAULT_COUNT_EDGES, DEFAULT_TIME_EDGES, Counter,
                      Gauge, Histogram, MetricsRegistry, geometric_edges,
                      linear_edges)
from .trace import NULL_SPAN, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "ObsState",
    "Tracer", "DEFAULT_COUNT_EDGES", "DEFAULT_TIME_EDGES", "disable",
    "enable", "enabled", "export_chrome_trace", "export_telemetry",
    "geometric_edges", "instant", "linear_edges", "snapshot", "span",
    "state",
]


class ObsState:
    """One observability session: a tracer and a metrics registry."""

    __slots__ = ("tracer", "metrics")

    def __init__(self, capacity: int = 65536):
        self.tracer = Tracer(capacity)
        self.metrics = MetricsRegistry()


_STATE: ObsState | None = None


def enable(capacity: int = 65536) -> ObsState:
    """Start a fresh observability session (replacing any previous one)."""
    global _STATE
    _STATE = ObsState(capacity)
    return _STATE


def disable() -> None:
    """Back to no-op mode; the previous session's data is dropped."""
    global _STATE
    _STATE = None


def enabled() -> bool:
    return _STATE is not None


def state() -> ObsState | None:
    """The live session, or ``None`` — THE guard every hot path checks."""
    return _STATE


def span(name: str, args: dict | None = None):
    """A span context manager, or the shared no-op when disabled."""
    st = _STATE
    if st is None:
        return NULL_SPAN
    return st.tracer.span(name, args)


def instant(name: str, args: dict | None = None) -> None:
    st = _STATE
    if st is not None:
        st.tracer.instant(name, args)


def snapshot() -> dict:
    """Schema-versioned telemetry document for the live session."""
    if _STATE is None:
        raise RuntimeError("observability is disabled; call obs.enable()")
    from .export import snapshot as _snapshot
    return _snapshot(_STATE.tracer, _STATE.metrics)


def export_telemetry(path=None):
    """Write ``artifacts/telemetry.json`` (atomic); returns the path."""
    if _STATE is None:
        raise RuntimeError("observability is disabled; call obs.enable()")
    from .export import DEFAULT_TELEMETRY_PATH, export_telemetry as _export
    return _export(_STATE.tracer, _STATE.metrics,
                   path if path is not None else DEFAULT_TELEMETRY_PATH)


def export_chrome_trace(path=None):
    """Write the Perfetto-viewable Chrome trace; returns the path."""
    if _STATE is None:
        raise RuntimeError("observability is disabled; call obs.enable()")
    from .export import DEFAULT_TRACE_PATH, export_chrome_trace as _export
    return _export(_STATE.tracer,
                   path if path is not None else DEFAULT_TRACE_PATH)
