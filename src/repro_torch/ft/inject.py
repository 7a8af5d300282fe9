"""Deterministic fault injection (DESIGN.md §14).

A seeded, process-global :class:`FaultPlan` drives failures through *named
injection sites* registered at the stack's real failure points — the page
allocator, the kernel measurement path, artifact I/O, and the paged serving
engine's prefill/decode ticks.  The design mirrors the ``obs`` singleton
(DESIGN.md §13): off by default, one module-level guarded global, and
allocation-free when disarmed — :func:`check` is a single global read plus
an ``is None`` test on the hot path.

Determinism contract: a site's failure schedule is a pure function of
``(plan seed, site name, per-site call index)``.  Each site owns an
independent RNG stream (seeded from the plan seed and a CRC of the site
name), advanced once per :func:`check` at that site, so adding calls at one
site never perturbs another site's schedule, and two runs with the same
plan + same call sequence inject byte-identical fault patterns — the
property the chaos conformance suite (``tests/test_chaos.py``) builds its
bit-exactness gates on.

Usage::

    from repro_torch.ft import inject

    # at a failure point (library code):
    inject.check("page.alloc", MemoryError)     # no-op unless armed

    # in a chaos test / driver:
    inject.arm(seed=7, rates={"page.alloc": 0.2}, at={"serve.decode": [3]})
    try:
        ...                                      # run the system
    finally:
        inject.disarm()

Sites raise *realistic* exception types (``MemoryError`` for the allocator,
``OSError`` for artifact I/O) so the degradation paths exercised by
injection are exactly the ones real faults would take; sites with no
realistic type raise :class:`InjectedFault` so handlers can be precise.
"""
from __future__ import annotations

import zlib

import numpy as np

from repro_torch import obs

__all__ = ["FaultPlan", "InjectedFault", "arm", "disarm", "plan", "check",
           "fire"]


class InjectedFault(RuntimeError):
    """An injected failure with no more realistic exception type (e.g. a
    serving-tick fault).  Handlers that must distinguish injected faults
    from genuine bugs catch exactly this."""


class FaultPlan:
    """Seeded per-site failure schedules.

    ``rates`` maps site name -> per-call failure probability (drawn from
    the site's own RNG stream); ``at`` maps site name -> explicit 0-based
    call indices that must fail (exact, rate-independent).  Both may be
    given for the same site; a call fails if either schedules it.
    ``max_faults`` optionally caps the total injected faults, turning an
    aggressive rate into a transient burst.
    """

    def __init__(self, seed: int = 0, rates: dict[str, float] | None = None,
                 at: dict[str, object] | None = None,
                 max_faults: int | None = None):
        self.seed = int(seed)
        self.rates = {str(k): float(v) for k, v in (rates or {}).items()}
        for site, r in self.rates.items():
            if not 0.0 <= r <= 1.0:
                raise ValueError(f"site {site!r}: rate {r} not in [0, 1]")
        self.at = {str(k): frozenset(int(i) for i in v)
                   for k, v in (at or {}).items()}
        self.max_faults = max_faults
        self.calls: dict[str, int] = {}     # site -> calls seen
        self.fired: dict[str, int] = {}     # site -> faults injected
        self._rngs: dict[str, np.random.Generator] = {}

    @property
    def total_fired(self) -> int:
        return sum(self.fired.values())

    def _rng(self, site: str) -> np.random.Generator:
        rng = self._rngs.get(site)
        if rng is None:
            rng = np.random.default_rng(
                (self.seed, zlib.crc32(site.encode("utf-8"))))
            self._rngs[site] = rng
        return rng

    def fire(self, site: str) -> bool:
        """Advance ``site``'s schedule one call; True when this call must
        fail.  The rate stream is drawn on *every* call at a rated site so
        the schedule depends only on the call index, never on what other
        sites did in between."""
        n = self.calls.get(site, 0)
        self.calls[site] = n + 1
        hit = False
        rate = self.rates.get(site, 0.0)
        if rate > 0.0 and self._rng(site).random() < rate:
            hit = True
        if site in self.at and n in self.at[site]:
            hit = True
        if hit and self.max_faults is not None \
                and self.total_fired >= self.max_faults:
            hit = False
        if hit:
            self.fired[site] = self.fired.get(site, 0) + 1
            st = obs.state()
            if st is not None:
                st.metrics.counter("faults.injected").inc()
                st.tracer.instant("fault.inject",
                                  {"site": site, "call": n})
        return hit

    def summary(self) -> dict:
        return {"seed": self.seed, "calls": dict(self.calls),
                "fired": dict(self.fired)}


_PLAN: FaultPlan | None = None


def arm(plan: FaultPlan | None = None, **kwargs) -> FaultPlan:
    """Install a fault plan (replacing any previous one).  Either pass a
    prepared :class:`FaultPlan` or keyword arguments for its constructor."""
    global _PLAN
    if plan is not None and kwargs:
        raise ValueError("pass either a FaultPlan or constructor kwargs")
    _PLAN = plan if plan is not None else FaultPlan(**kwargs)
    return _PLAN


def disarm() -> None:
    """Back to no-fault mode (the default)."""
    global _PLAN
    _PLAN = None


def plan() -> FaultPlan | None:
    """The armed plan, or ``None`` — THE guard every site checks."""
    return _PLAN


def fire(site: str) -> bool:
    """True when the armed plan schedules a fault at this call of ``site``
    (and records it); always False when disarmed."""
    p = _PLAN
    if p is None:
        return False
    return p.fire(site)


def check(site: str, exc: type[BaseException] = InjectedFault) -> None:
    """Raise ``exc`` when the armed plan schedules a fault here; the
    disarmed fast path is one global read + ``is None``."""
    p = _PLAN
    if p is not None and p.fire(site):
        raise exc(f"injected fault at {site!r} "
                  f"(call {p.calls[site] - 1}, seed {p.seed})")
