"""Solution registry: persisted co-design outputs consumed by the framework.

The HASCO flow produces (accelerator config, per-workload schedules); the
training/serving framework consumes the accelerator config as the *tuned
Pallas kernel configuration* (block shapes, pipeline depth) — this is how the
paper's technique becomes a first-class feature of the framework
(DESIGN.md §2: the co-designed "hardware" is the kernel resource envelope).

This per-app registry is subsumed by the measured tuning database
(``repro.tuner.db``): the DB stores shape-exact measured kernel records plus
an ``apps`` section equivalent to this file's schema, and the dispatch layer
(``kernels/ops.py``) consults the DB first.  The registry remains the
lightweight analytical-only artifact and shares the same robustness
contract: corrupt or missing files load as empty with a warning (a bad
artifact must never take down a launch), and saves are atomic
(tmp file + rename) and merge-on-save.
"""
from __future__ import annotations

import warnings
from dataclasses import asdict
from pathlib import Path

from .artifacts import atomic_write_json, read_json_object
from .codesign import Solution
from .hw_primitives import HWConfig

DEFAULT_PATH = Path("artifacts/solutions.json")


def _read_registry(path: Path) -> dict:
    """Missing/corrupt registries are empty, never fatal."""
    return read_json_object(path, "solution registry")


def save(app: str, sol: Solution, path: Path | str = DEFAULT_PATH) -> None:
    """Merge ``sol`` into the registry under ``app``, atomically.

    Existing apps are preserved (merge-on-save); the write goes through a
    temp file + rename so readers never observe a torn artifact.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = _read_registry(path)
    data[app] = {
        "hw": asdict(sol.hw),
        "intrinsic": sol.intrinsic,
        "latency_s": sol.latency_s,
        "power_w": sol.power_w,
        "area_um2": sol.area_um2,
        "schedules": {
            w: {"tiles": list(map(list, s.tiles)), "order": list(s.order),
                "fuse_outer": s.fuse_outer,
                "index_map": list(map(list, s.choice.index_map))}
            for w, s in sol.schedules.items()},
    }
    atomic_write_json(path, data)


def load_hw(app: str, path: Path | str = DEFAULT_PATH) -> HWConfig | None:
    """The app's co-designed accelerator, or None (missing app, missing
    file, corrupt file, malformed entry — all non-fatal)."""
    data = _read_registry(Path(path))
    entry = data.get(app)
    if not isinstance(entry, dict) or "hw" not in entry:
        return None
    try:
        return HWConfig(**entry["hw"])
    except (TypeError, ValueError) as e:
        warnings.warn(f"solution registry {path}: malformed hw entry for "
                      f"{app!r} ({e})", stacklevel=2)
        return None


def mxu_legal(x: int, lane: int) -> int:
    """Clamp a block dim down to an MXU-legal multiple of ``lane`` (floor,
    never below one lane) — the one place this rule lives."""
    return max(lane, (int(x) // lane) * lane)


def kernel_blocks(app: str, path: Path | str = DEFAULT_PATH,
                  default: tuple[int, int, int] = (256, 256, 512)
                  ) -> tuple[int, int, int]:
    """Tuned (bm, bn, bk) Pallas block shape for the app's GEMM kernel,
    clamped to MXU-legal multiples."""
    hw = load_hw(app, path)
    if hw is None:
        return default
    return (mxu_legal(hw.pe_rows, 8), mxu_legal(hw.pe_cols, 128),
            mxu_legal(hw.pe_depth, 128))
