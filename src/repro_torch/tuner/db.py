"""Persistent tuning database (DESIGN.md §8.3).

One versioned JSON artifact holds everything the runtime needs from a
co-design/tuning run:

  * ``records`` — best-measured kernel configurations keyed by
    ``(op, shape, dtype, backend)``: the block shapes ``kernels/ops.py``
    dispatch consults, plus the measured and predicted latencies that
    justify them;
  * ``calibration`` — the fitted per-op analytical->measured corrections
    (``tuner/calibrate.py``), so later explorations can start calibrated;
  * ``apps`` — per-application co-design solutions (accelerator config +
    intrinsic + objectives), subsuming the older ``core/solution.py``
    registry format;
  * ``failures`` / ``quarantine`` — bounded diagnostic failure records, and
    the persistently-failing kernel candidates future measurement runs skip
    unrun (DESIGN.md §14).

Robustness contract (shared with the hardened solution registry): corrupt or
missing files load as an empty database with a warning — a bad artifact must
never take down serving — and ``save()`` is atomic (tmp file + rename) with
merge-on-save, so concurrent tuning runs of different apps/shapes union
rather than clobber.
"""
from __future__ import annotations

import json
import math
import warnings
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path

from repro_torch.core.artifacts import atomic_write_json, read_json_object

from .calibrate import Calibration

DB_VERSION = 1
# the port's own artifact: the reference package writes
# artifacts/tuning_db.json, and the two must not overwrite each other's
# "apps" entries
DEFAULT_DB_PATH = Path("artifacts/torch_tuning_db.json")
# the "failures" section is bounded: it is diagnostic data (which candidates
# fail, how, and how much wall clock they burn), not a ledger
MAX_FAILURES = 256


def _key(op: str, shape, dtype: str, backend: str) -> str:
    return "|".join([op, "x".join(str(int(v)) for v in shape), dtype, backend])


@dataclass
class TuningRecord:
    """Best-known kernel configuration for one (op, shape, dtype, backend)."""

    op: str
    shape: tuple[int, ...]
    dtype: str
    backend: str
    blocks: dict[str, int]
    measured_s: float = math.inf
    predicted_s: float = math.inf
    app: str = ""

    @property
    def key(self) -> str:
        return _key(self.op, self.shape, self.dtype, self.backend)

    def to_dict(self) -> dict:
        return {"op": self.op, "shape": list(self.shape), "dtype": self.dtype,
                "backend": self.backend,
                "blocks": {k: int(v) for k, v in self.blocks.items()},
                "measured_s": self.measured_s,
                "predicted_s": self.predicted_s, "app": self.app}

    @classmethod
    def from_dict(cls, d: dict) -> "TuningRecord":
        return cls(str(d["op"]), tuple(int(v) for v in d["shape"]),
                   str(d["dtype"]), str(d["backend"]),
                   {k: int(v) for k, v in d["blocks"].items()},
                   float(d.get("measured_s", math.inf)),
                   float(d.get("predicted_s", math.inf)),
                   str(d.get("app", "")))


class TuningDB:
    """In-memory view over the tuning artifact; see module docstring."""

    def __init__(self, path: Path | str = DEFAULT_DB_PATH):
        self.path = Path(path)
        self.records: dict[str, TuningRecord] = {}
        self.calibration = Calibration()
        self.apps: dict[str, dict] = {}
        self.failures: list[dict] = []
        # persistently failing kernel candidates (measure.quarantine_key ->
        # diagnostic info); future measurement runs skip these unrun
        self.quarantine: dict[str, dict] = {}

    # -- loading --------------------------------------------------------------
    @classmethod
    def load(cls, path: Path | str = DEFAULT_DB_PATH) -> "TuningDB":
        db = cls(path)
        data = _read_json(db.path)
        db._absorb(data)
        return db

    def _absorb(self, data: dict) -> None:
        """Fold a raw artifact dict in; schema defects (wrong-typed
        sections, malformed entries — hand edits, version skew, foreign
        files) are dropped with a warning, never fatal (the load contract)."""
        def section(name: str) -> dict:
            sec = data.get(name, {})
            if not isinstance(sec, dict):
                warnings.warn(f"tuning db {self.path}: ignoring {name!r} "
                              f"section of type {type(sec).__name__}",
                              stacklevel=4)
                return {}
            return sec

        for key, rec in section("records").items():
            try:
                self._merge_record(TuningRecord.from_dict(rec))
            except (KeyError, TypeError, ValueError, AttributeError) as e:
                warnings.warn(f"tuning db {self.path}: dropping malformed "
                              f"record {key!r} ({e})", stacklevel=3)
        for op, corr in section("calibration").items():
            try:
                corr = Calibration.from_dict({op: corr}).corrections[op]
            except (KeyError, TypeError, ValueError, AttributeError) as e:
                warnings.warn(f"tuning db {self.path}: dropping malformed "
                              f"calibration for {op!r} ({e})", stacklevel=3)
                continue
            mine = self.calibration.corrections.get(op)
            if mine is None or corr.n_samples >= mine.n_samples:
                self.calibration.corrections[op] = corr
        for app, sol in section("apps").items():
            if not isinstance(sol, dict):
                warnings.warn(f"tuning db {self.path}: dropping malformed "
                              f"app entry {app!r}", stacklevel=3)
                continue
            if app not in self.apps:
                self.apps[app] = sol
        fails = data.get("failures", [])
        if isinstance(fails, list):
            self.add_failures(f for f in fails if isinstance(f, dict))
        elif "failures" in data:
            warnings.warn(f"tuning db {self.path}: ignoring 'failures' "
                          f"section of type {type(fails).__name__}",
                          stacklevel=4)
        for key, info in section("quarantine").items():
            if not isinstance(info, dict):
                warnings.warn(f"tuning db {self.path}: dropping malformed "
                              f"quarantine entry {key!r}", stacklevel=3)
                continue
            self.quarantine.setdefault(str(key), info)

    def _merge_record(self, rec: TuningRecord) -> None:
        cur = self.records.get(rec.key)
        if cur is None or rec.measured_s < cur.measured_s:
            self.records[rec.key] = rec

    # -- updates --------------------------------------------------------------
    def record(self, rec: TuningRecord) -> bool:
        """Keep ``rec`` if it beats the stored config; -> whether it did."""
        cur = self.records.get(rec.key)
        if cur is None or rec.measured_s < cur.measured_s:
            self.records[rec.key] = rec
            return True
        return False

    def set_calibration(self, calibration: Calibration) -> None:
        for op, corr in calibration.corrections.items():
            self.calibration.corrections[op] = corr

    def set_app(self, app: str, solution: dict) -> None:
        self.apps[app] = solution

    def add_failures(self, failures) -> None:
        """Append measurement-failure records (plain dicts: workload,
        error_type, error, elapsed_s, backend, app...).  Deduplicated by
        content — re-absorbing a file this db was saved to is a no-op — and
        capped at MAX_FAILURES most-recent entries."""
        self.failures.extend(dict(f) for f in failures)
        seen: set[str] = set()
        out: list[dict] = []
        for f in self.failures:
            k = json.dumps(f, sort_keys=True, default=str)
            if k not in seen:
                seen.add(k)
                out.append(f)
        self.failures = out[-MAX_FAILURES:]

    def quarantine_candidate(self, key: str, info: dict | None = None) -> bool:
        """Quarantine one kernel candidate (``measure.quarantine_key``
        string): future measurement runs skip it without burning wall
        clock.  -> whether the key was newly quarantined."""
        if key in self.quarantine:
            return False
        self.quarantine[key] = dict(info or {})
        return True

    def quarantined_keys(self) -> set[str]:
        return set(self.quarantine)

    # -- lookups --------------------------------------------------------------
    def best_config(self, op: str, shape, dtype: str = "float32",
                    backend: str = "cuda") -> dict[str, int] | None:
        """Tuned block shapes for an exact (op, shape, dtype, backend), or
        None — callers fall back to their safe defaults."""
        rec = self.records.get(_key(op, shape, dtype, backend))
        return dict(rec.blocks) if rec is not None else None

    def best_record(self, op: str, shape, dtype: str = "float32",
                    backend: str = "cuda") -> TuningRecord | None:
        return self.records.get(_key(op, shape, dtype, backend))

    # -- persistence ----------------------------------------------------------
    def to_dict(self) -> dict:
        out = {
            "version": DB_VERSION,
            "records": {k: r.to_dict()
                        for k, r in sorted(self.records.items())},
            "calibration": self.calibration.to_dict(),
            "apps": dict(sorted(self.apps.items())),
        }
        if self.failures:   # optional section: old artifacts stay byte-stable
            out["failures"] = list(self.failures)
        if self.quarantine:   # optional, same byte-stability contract
            out["quarantine"] = dict(sorted(self.quarantine.items()))
        return out

    def save(self, path: Path | str | None = None) -> Path:
        """Merge-on-save + atomic write: re-read whatever is on disk now,
        union it in (best-measured wins per key), then tmp-file + rename so a
        reader never sees a torn artifact.  The read-merge-write sequence
        holds an flock on a sidecar lock file, so *concurrent* tuning runs
        serialize and genuinely union rather than last-writer-wins."""
        path = Path(path) if path is not None else self.path
        path.parent.mkdir(parents=True, exist_ok=True)
        with _save_lock(path):
            return self._save_locked(path)

    def _save_locked(self, path: Path) -> Path:
        on_disk = _read_json(path)
        if on_disk:
            merged = TuningDB(path)
            merged.records = dict(self.records)
            merged.calibration = Calibration(dict(
                self.calibration.corrections))
            merged.apps = dict(self.apps)
            merged.failures = [dict(f) for f in self.failures]
            merged.quarantine = {k: dict(v)
                                 for k, v in self.quarantine.items()}
            merged._absorb(on_disk)
            # our freshly-set apps/calibration win over stale on-disk ones
            merged.apps.update(self.apps)
            merged.calibration.corrections.update(
                self.calibration.corrections)
            payload = merged.to_dict()
        else:
            payload = self.to_dict()
        atomic_write_json(path, payload)
        return path


def _read_json(path: Path) -> dict:
    return read_json_object(path, "tuning db")


@contextmanager
def _save_lock(path: Path):
    """Advisory flock over ``path``'s sidecar .lock file; degrades to
    unlocked (atomic-rename-only) where flock is unavailable."""
    lock = None
    try:
        import fcntl

        lock = open(path.with_name(path.name + ".lock"), "w")
        fcntl.flock(lock, fcntl.LOCK_EX)
    except (ImportError, OSError):
        if lock is not None:
            lock.close()
            lock = None
    try:
        yield
    finally:
        if lock is not None:
            lock.close()   # closing drops the flock
