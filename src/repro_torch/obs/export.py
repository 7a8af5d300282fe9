"""Telemetry snapshot/export + schema validation (DESIGN.md §13).

``snapshot`` folds one observability session (tracer ring + metrics
registry) into a schema-versioned plain dict; ``export_telemetry`` persists
it as ``artifacts/telemetry.json`` through the corrupt-safe atomic writer
shared with the tuning DB and solution registry, and
``export_chrome_trace`` writes the Perfetto-viewable trace document.

``validate_telemetry`` is the other half of the contract: CI's ``obs-smoke``
job (and ``python -m repro.obs <path>``) reject any artifact that drifts
from the schema, so downstream consumers — e.g. the learned cost model
training on accumulated (config, measurement) telemetry — can trust the
shape without defensive parsing.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

TELEMETRY_SCHEMA_VERSION = 1
DEFAULT_TELEMETRY_PATH = Path("artifacts/telemetry.json")
DEFAULT_TRACE_PATH = Path("artifacts/trace.json")


def snapshot(tracer, metrics) -> dict:
    """One schema-versioned document for the whole session."""
    return {
        "schema_version": TELEMETRY_SCHEMA_VERSION,
        "created_unix": int(time.time()),
        "trace": {
            "capacity": tracer.capacity,
            "recorded": tracer.recorded,
            "dropped": tracer.dropped,
            "events": [
                {"ph": ev[0], "name": ev[1], "ts_us": ev[2], "dur_us": ev[3],
                 "tid": ev[4], "depth": ev[5], "args": ev[6] or {}}
                for ev in tracer.events()
            ],
        },
        "metrics": metrics.snapshot(),
    }


def export_telemetry(tracer, metrics,
                     path: Path | str = DEFAULT_TELEMETRY_PATH) -> Path:
    """Write the telemetry snapshot atomically; returns the path."""
    from repro_torch.core.artifacts import atomic_write_json

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    atomic_write_json(path, snapshot(tracer, metrics))
    return path


def export_chrome_trace(tracer,
                        path: Path | str = DEFAULT_TRACE_PATH) -> Path:
    """Write the Chrome trace-event document (open in ui.perfetto.dev)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(tracer.to_chrome()) + "\n")
    return path


# ---------------------------------------------------------------------------
# Schema validation
# ---------------------------------------------------------------------------

_EVENT_KEYS = {"ph": str, "name": str, "ts_us": (int, float),
               "dur_us": (int, float), "tid": int, "depth": int,
               "args": dict}


def validate_telemetry(doc) -> list[str]:
    """Schema defects of a telemetry document; empty list == valid."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return [f"document is {type(doc).__name__}, expected object"]
    if doc.get("schema_version") != TELEMETRY_SCHEMA_VERSION:
        errs.append(f"schema_version {doc.get('schema_version')!r} != "
                    f"{TELEMETRY_SCHEMA_VERSION}")
    if not isinstance(doc.get("created_unix"), int):
        errs.append("created_unix missing or not an int")

    trace = doc.get("trace")
    if not isinstance(trace, dict):
        errs.append("trace section missing or not an object")
    else:
        for key in ("capacity", "recorded", "dropped"):
            if not isinstance(trace.get(key), int) or trace.get(key, -1) < 0:
                errs.append(f"trace.{key} missing or negative")
        events = trace.get("events")
        if not isinstance(events, list):
            errs.append("trace.events missing or not a list")
        else:
            for i, ev in enumerate(events):
                if not isinstance(ev, dict):
                    errs.append(f"trace.events[{i}] is not an object")
                    continue
                for key, typ in _EVENT_KEYS.items():
                    if not isinstance(ev.get(key), typ):
                        errs.append(f"trace.events[{i}].{key} missing or "
                                    f"mistyped")
                if ev.get("ph") not in ("X", "i"):
                    errs.append(f"trace.events[{i}].ph {ev.get('ph')!r} "
                                f"not in ('X', 'i')")
                if errs and len(errs) > 20:
                    errs.append("... (truncated)")
                    return errs

    met = doc.get("metrics")
    if not isinstance(met, dict):
        errs.append("metrics section missing or not an object")
    else:
        for section in ("counters", "gauges", "histograms"):
            if not isinstance(met.get(section), dict):
                errs.append(f"metrics.{section} missing or not an object")
        for name, h in (met.get("histograms") or {}).items():
            if not isinstance(h, dict):
                errs.append(f"metrics.histograms[{name!r}] is not an object")
                continue
            edges, counts = h.get("edges"), h.get("counts")
            if not isinstance(edges, list) or not isinstance(counts, list) \
                    or len(counts) != len(edges) + 1:
                errs.append(f"metrics.histograms[{name!r}]: counts must be "
                            f"len(edges) + 1 buckets")
            elif isinstance(h.get("count"), int) \
                    and sum(counts) != h["count"]:
                errs.append(f"metrics.histograms[{name!r}]: bucket counts "
                            f"do not sum to count")
    return errs


def validate_telemetry_file(path: Path | str) -> list[str]:
    path = Path(path)
    try:
        doc = json.loads(path.read_text())
    except FileNotFoundError:
        return [f"{path}: not found"]
    except json.JSONDecodeError as e:
        return [f"{path}: corrupt JSON ({e})"]
    return validate_telemetry(doc)
