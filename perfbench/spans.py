"""The program's own spans of the traced stretch.

While ``torch.profiler`` records, the program keeps its spans in a session
of their own (``repro_torch.obs.profiled()``), each span that enqueues work
on the card with that work's device milliseconds (CUDA events at its entry
and exit, ``device_ms``).  The stretch is the only profiled part of a run,
so the session holds the traced requests' forwards and nothing else.  A
program without that session gives nothing to read.
"""
from __future__ import annotations

FORWARD = "prefill.forward"


def session_events() -> list | None:
    """The profiled session's events, ``(ph, name, ts_us, dur_us, tid,
    depth, args)``, or None where the program keeps none."""
    from repro_torch import obs

    profiled = getattr(obs, "profiled", None)
    st = profiled() if profiled is not None else None
    return None if st is None else st.tracer.events()


def per_forward_ms(name: str, events: list | None) -> float | None:
    """Device milliseconds of every span ``name`` over the number of
    forwards recorded (``prefill.forward`` spans): the program's own count
    of the sequences it ran.  None where nothing was recorded."""
    if not events:
        return None
    forwards = sum(e[1] == FORWARD for e in events)
    ms = [(e[6] or {}).get("device_ms") for e in events if e[1] == name]
    if not forwards or not ms or None in ms:
        return None
    return sum(ms) / forwards


def read(run, name: str) -> float | None:
    """A reader's value on the card; none without one, where the spans'
    time is the host's (as every device metric of the cell)."""
    if run.device.get("platform") != "gpu":
        return None
    return per_forward_ms(name, session_events())
