"""Watchdogs: heartbeat (node failure / stragglers) and no-progress
(DESIGN.md §14), copied from ``repro/ft/watchdog.py``.

:class:`Watchdog` is the cluster heartbeat: each worker ``beat()``s per
step; the controller calls ``check()`` to classify workers as healthy /
straggler / dead (a dead worker: restart from the latest checkpoint; a
repeated straggler: cordoned).  The trainer (``launch/train.py``) runs one
worker and feeds it each step's time.

:class:`ProgressWatchdog` is the serving engines' stall detector: they feed
it a *progress signature* every tick.  When the signature stops changing for
``stall_limit`` consecutive beats, the engine converts its would-be infinite
``run()`` loop into a diagnosable fail-stop instead of a hang.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class ProgressWatchdog:
    """Fail-stop guard over a monotone progress signature.

    ``beat(signature)`` returns the number of consecutive beats the
    signature has been unchanged; :attr:`stalled` trips at
    ``stall_limit``.  The signature should capture *real* forward progress
    (tokens produced, requests reaching a terminal state), not churn that
    increments forever in exactly the livelocks this guard exists to catch.
    """

    stall_limit: int = 256
    stalled_for: int = 0
    _last: object = None

    def beat(self, signature: object) -> int:
        if signature != self._last:
            self._last = signature
            self.stalled_for = 0
        else:
            self.stalled_for += 1
        return self.stalled_for

    @property
    def stalled(self) -> bool:
        return self.stalled_for >= self.stall_limit


@dataclass
class WorkerState:
    last_beat: float
    last_step: int
    slow_count: int = 0
    cordoned: bool = False


@dataclass
class Watchdog:
    n_workers: int
    dead_after_s: float = 60.0
    straggler_factor: float = 2.0   # slower than factor x median step time
    cordon_after: int = 3
    workers: dict[int, WorkerState] = field(default_factory=dict)
    step_times: list[float] = field(default_factory=list)

    def beat(self, worker: int, step: int, now: float | None = None,
             step_time_s: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        st = self.workers.setdefault(worker, WorkerState(now, step))
        st.last_beat, st.last_step = now, step
        if step_time_s is not None:
            self.step_times.append(step_time_s)
            med = self.median_step_time()
            if med != float("inf") and step_time_s > self.straggler_factor * med:
                st.slow_count += 1
                if st.slow_count >= self.cordon_after:
                    st.cordoned = True
            else:
                st.slow_count = 0

    def median_step_time(self) -> float:
        if not self.step_times:
            return float("inf")
        s = sorted(self.step_times[-256:])
        return s[len(s) // 2]

    def check(self, now: float | None = None) -> dict[str, list[int]]:
        now = time.monotonic() if now is None else now
        dead, stragglers, cordoned = [], [], []
        for w in range(self.n_workers):
            st = self.workers.get(w)
            if st is None or now - st.last_beat > self.dead_after_s:
                dead.append(w)
            elif st.cordoned:
                cordoned.append(w)
            elif st.slow_count > 0:
                stragglers.append(w)
        return {"dead": dead, "stragglers": stragglers, "cordoned": cordoned}

    def healthy_mesh_size(self, total: int, now: float | None = None) -> int:
        """Largest power-of-two worker count available after failures:
        the elastic-restart target size."""
        health = self.check(now=now)
        bad = set(health["dead"]) | set(health["cordoned"])
        avail = total - len([w for w in bad if w < total])
        size = 1
        while size * 2 <= avail:
            size *= 2
        return size
