"""Robust artifact I/O shared by the solution registry, the tuning
database, and the checkpoint manager (DESIGN.md §8.3, §14).

The contract every persistence layer promises: a corrupt, missing, or
foreign artifact loads as empty with a warning — a bad file must never take
down a launch — and writes are atomic (tmp file + rename) so a concurrent
reader never observes a torn artifact.  Both directions carry fault-
injection sites (``artifacts.read`` / ``artifacts.write``, DESIGN.md §14)
raising ``OSError`` — the realistic failure — so the chaos suite drives the
exact degradation paths a flaky filesystem would.
"""
from __future__ import annotations

import json
import os
import tempfile
import warnings
from pathlib import Path

from repro_torch.ft import inject


def read_json_object(path: Path, label: str = "artifact") -> dict:
    """The JSON object at ``path``, or {} (with a warning) on any defect."""
    try:
        inject.check("artifacts.read", OSError)
        text = path.read_text()
    except FileNotFoundError:
        return {}
    except OSError as e:
        warnings.warn(f"{label} {path}: unreadable ({e}); treating as empty",
                      stacklevel=3)
        return {}
    try:
        data = json.loads(text)
    except json.JSONDecodeError as e:
        warnings.warn(f"{label} {path}: corrupt JSON ({e}); treating as "
                      f"empty", stacklevel=3)
        return {}
    if not isinstance(data, dict):
        warnings.warn(f"{label} {path}: expected an object, got "
                      f"{type(data).__name__}; treating as empty",
                      stacklevel=3)
        return {}
    return data


def read_bytes_safe(path: Path, label: str = "artifact") -> bytes | None:
    """The bytes at ``path``, or ``None`` (missing silently, I/O errors
    with a warning) — the binary sibling of :func:`read_json_object`."""
    try:
        inject.check("artifacts.read", OSError)
        return path.read_bytes()
    except FileNotFoundError:
        return None
    except OSError as e:
        warnings.warn(f"{label} {path}: unreadable ({e}); treating as "
                      f"missing", stacklevel=3)
        return None


def atomic_write_bytes(path: Path, payload: bytes) -> None:
    """Write ``payload`` via tmp file + rename (same-directory, so the
    rename is atomic on POSIX).  Raises ``OSError`` on failure — callers
    that must survive a flaky disk catch it (checkpointing warns and keeps
    the previous checkpoint; a torn write can never be observed)."""
    inject.check("artifacts.write", OSError)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name,
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: Path, payload: dict) -> None:
    """Atomic JSON write (tmp file + rename) through the same injected-
    fault path as :func:`atomic_write_bytes`."""
    text = json.dumps(payload, indent=2, sort_keys=True) + "\n"
    atomic_write_bytes(path, text.encode("utf-8"))
