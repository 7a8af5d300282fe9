"""No-progress watchdog of the serving engines (DESIGN.md §14).

:class:`ProgressWatchdog` is copied from ``repro/ft/watchdog.py``: a
step-counted stall detector the serving engines feed a *progress signature*
every tick.  When the signature stops changing for ``stall_limit``
consecutive beats, the engine converts its would-be infinite ``run()`` loop
into a diagnosable fail-stop instead of a hang.  The cluster heartbeat
``Watchdog`` comes with the training slice (ROADMAP A.7).
"""
from __future__ import annotations

from dataclasses import dataclass


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
