"""Span tracer over a preallocated ring buffer (DESIGN.md §13).

Events are plain tuples written into a fixed-size list — recording a span is
two ``perf_counter_ns`` reads, one tuple build, and one list-slot store, so
an *enabled* tracer stays cheap enough to leave on around jitted model
steps.  When the buffer wraps, the oldest events are overwritten (``dropped``
counts them); capacity is chosen at construction and never grows.

Export is Chrome trace-event JSON (the ``{"traceEvents": [...]}`` document
both ``chrome://tracing`` and https://ui.perfetto.dev open directly):
complete spans are ``"ph": "X"`` events with microsecond ``ts``/``dur``,
instant events are ``"ph": "i"``.  Span nesting is tracked per thread; the
recorded ``depth`` makes parent/child structure testable without re-deriving
it from timestamps.
"""
from __future__ import annotations

import threading
import time

# event tuple layout: (ph, name, ts_us, dur_us, tid, depth, args)
PH, NAME, TS, DUR, TID, DEPTH, ARGS = range(7)


class _NullSpan:
    """The shared do-nothing context manager handed out while tracing is
    disabled — no allocation per call site (``__slots__`` keeps it inert)."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records a complete ("X") event at exit."""

    __slots__ = ("_tracer", "name", "args", "_t0", "depth")

    def __init__(self, tracer: "Tracer", name: str, args: dict | None):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        stack = self._tracer._stack()
        self.depth = len(stack)
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        tr = self._tracer
        tr._stack().pop()
        tr._record(("X", self.name, (self._t0 - tr._t0) / 1e3,
                    (t1 - self._t0) / 1e3, threading.get_ident(), self.depth,
                    self.args))
        return False


class Tracer:
    """Nested-span recorder over a preallocated ring buffer."""

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError("tracer capacity must be >= 1")
        self.capacity = capacity
        self._buf: list[tuple | None] = [None] * capacity
        self._n = 0
        self._t0 = time.perf_counter_ns()
        self._local = threading.local()

    # -- recording ----------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, ev: tuple) -> None:
        self._buf[self._n % self.capacity] = ev
        self._n += 1

    def span(self, name: str, args: dict | None = None) -> _Span:
        """Context manager recording one complete span on exit."""
        return _Span(self, name, args)

    def instant(self, name: str, args: dict | None = None) -> None:
        """Record one instant ("i") event at the current time."""
        self._record(("i", name, (time.perf_counter_ns() - self._t0) / 1e3,
                      0.0, threading.get_ident(),
                      len(self._stack()), args))

    # -- reading ------------------------------------------------------------

    @property
    def recorded(self) -> int:
        """Total events ever recorded (including ones the ring dropped)."""
        return self._n

    @property
    def dropped(self) -> int:
        return max(0, self._n - self.capacity)

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    def events(self) -> list[tuple]:
        """Surviving events, oldest first (ring unrolled)."""
        if self._n <= self.capacity:
            return [e for e in self._buf[:self._n]]
        i = self._n % self.capacity
        return self._buf[i:] + self._buf[:i]

    def to_chrome(self) -> dict:
        """The Chrome trace-event JSON document (Perfetto-viewable)."""
        out = []
        for ev in self.events():
            d = {"name": ev[NAME], "ph": ev[PH], "ts": ev[TS],
                 "pid": 0, "tid": ev[TID],
                 "args": dict(ev[ARGS] or {}, depth=ev[DEPTH])}
            if ev[PH] == "X":
                d["dur"] = ev[DUR]
            else:
                d["s"] = "t"
            out.append(d)
        return {"traceEvents": out, "displayTimeUnit": "ms"}
