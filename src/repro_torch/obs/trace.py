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
from collections import deque

import torch
from torch.autograd import profiler

# event tuple layout: (ph, name, ts_us, dur_us, tid, depth, args, device);
# device: None (host only), milliseconds, or a pending CUDA [start, end]
PH, NAME, TS, DUR, TID, DEPTH, ARGS, DEVICE = range(8)


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

    __slots__ = ("_tracer", "name", "args", "_t0", "depth", "device",
                 "_marks", "_stream", "_range")

    def __init__(self, tracer: "Tracer", name: str, args: dict | None,
                 device: torch.device | None = None):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.device = device

    def __enter__(self) -> "_Span":
        stack = self._tracer._stack()
        self.depth = len(stack)
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        self._range = None
        if profiler._is_profiler_enabled:
            self._range = profiler.record_function(self.name)
            self._range.__enter__()
        self._marks = None
        dev = self.device
        # no events while a CUDA graph is captured: the span is host only
        if dev is not None and dev.type == "cuda" \
                and not torch.cuda.is_current_stream_capturing():
            self._stream = torch.cuda.current_stream(dev)
            self._marks = self._tracer._take_events(dev)
            self._marks[0].record(self._stream)
        return self

    def __exit__(self, *exc) -> bool:
        if self._marks is not None:
            self._marks[1].record(self._stream)
        if self._range is not None:
            self._range.__exit__(None, None, None)
        t1 = time.perf_counter_ns()
        dev = self._marks
        if self.device is not None and self.device.type == "cpu":
            dev = (t1 - self._t0) / 1e6
        tr = self._tracer
        tr._stack().pop()
        tr._record(("X", self.name, (self._t0 - tr._t0) / 1e3,
                    (t1 - self._t0) / 1e3, threading.get_ident(), self.depth,
                    self.args, dev))
        if self._marks is not None:
            tr._pending.append((tr._n - 1, self.device, self._marks))
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
        self._epoch_ns = time.time_ns()       # the anchor pair, taken together
        self._local = threading.local()
        self._free: dict = {}                 # device -> [[start, end]]
        self._pending: deque = deque()        # (event index, device, pair)

    # -- recording ----------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, ev: tuple) -> None:
        self._buf[self._n % self.capacity] = ev
        self._n += 1

    def span(self, name: str, args: dict | None = None,
             device: torch.device | None = None) -> _Span:
        """Context manager recording one complete span on exit.  While
        ``torch.profiler`` records, the span also opens a profiler range of
        its name, inside the span's own start and end.  With a ``device``,
        the span times the work it enqueued there: on a CUDA device by two
        pooled ``torch.cuda.Event`` objects recorded on the stream current
        at entry, resolved into milliseconds only when read
        (:meth:`resolve`); on the CPU, whose ops run synchronously, by its
        host duration."""
        return _Span(self, name, args, device)

    def device_start(self) -> None:
        """Start the innermost open span's device time here: a span site
        whose host work (checks, buffers) precedes its first launch calls
        this just before that launch, so that the span's ``device_ms``
        holds the launched work and not the device's wait for that host
        work.  Nothing where that span times no CUDA work."""
        stack = self._stack()
        if stack and stack[-1]._marks is not None:
            stack[-1]._marks[0].record(stack[-1]._stream)

    def _take_events(self, device: torch.device) -> list:
        """A pair of timing events for a span on ``device``: a pooled one;
        else the oldest pending span's once the ring has dropped its event
        (nothing is left to read, so a long session holds at most
        ``capacity`` pairs); else a new pair."""
        free = self._free.get(device)
        if free:
            return free.pop()
        if self._pending and self._pending[0][1] == device \
                and self._pending[0][0] < self._n - self.capacity:
            return self._pending.popleft()[2]
        return [torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True)]

    def resolve(self) -> None:
        """Turn each pending CUDA span's pair of events into milliseconds,
        waiting for the device where it has not passed them, and pool the
        pairs: reading (:meth:`events`) resolves, a span never does."""
        while self._pending:
            n, device, pair = self._pending.popleft()
            if n >= self._n - self.capacity:       # the ring holds its event
                pair[1].synchronize()
                i = n % self.capacity
                self._buf[i] = self._buf[i][:DEVICE] + (
                    pair[0].elapsed_time(pair[1]),)
            self._free.setdefault(device, []).append(pair)

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
        """Surviving events, oldest first (ring unrolled), as ``(ph, name,
        ts_us, dur_us, tid, depth, args)``; a device span's milliseconds
        are its args' ``device_ms`` (after :meth:`resolve`, which may wait
        for the device).  ``ts_us`` is in Unix-epoch microseconds, from the
        anchor pair (``perf_counter_ns``, ``time_ns``) taken when the tracer
        opened: the clock of a ``torch.profiler`` trace (its ``ts`` plus
        ``baseTimeNanoseconds``), so the two load onto one timeline."""
        self.resolve()
        if self._n <= self.capacity:
            raw = self._buf[:self._n]
        else:
            i = self._n % self.capacity
            raw = self._buf[i:] + self._buf[:i]
        at = self._epoch_ns / 1e3
        out = []
        for ev in raw:
            args = ev[ARGS]
            if len(ev) > DEVICE and ev[DEVICE] is not None:
                args = dict(args or {}, device_ms=ev[DEVICE])
            out.append(ev[:TS] + (ev[TS] + at,) + ev[DUR:ARGS] + (args,))
        return out

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
