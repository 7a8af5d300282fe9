"""Dispatch wrappers for the intrinsic kernels.

Every op takes ``implementation``: 'cuda' (the hand-written kernel; CUDA
tensors only) or 'torch' (the plain PyTorch version; CPU tensors only).  A
tensor on the wrong device raises: dispatch never moves data and never
falls back from one implementation to the other.

Block shapes left unspecified are resolved through a three-level fallback:
the measured tuning database (``tuner/db.py``) for this exact (op, shape,
dtype, backend); then app-level defaults installed by :func:`configure`;
then the safe built-in constants.  Explicit keyword arguments always win.
"""
from __future__ import annotations

import os
import warnings

import torch

from . import conv2d as _conv2d
from . import dotprod as _dotprod
from . import gemm as _gemm
from . import gemv as _gemv
from . import ref

# where each implementation runs: the kernels on the card, the plain
# versions on the CPU (the tuner's backends are these names too)
DEVICE_OF = {"cuda": "cuda", "torch": "cpu"}
IMPLEMENTATIONS = tuple(DEVICE_OF)

# safe built-in block shapes — the last-resort tier of resolve_blocks
DEFAULT_BLOCKS: dict[str, dict[str, int]] = {
    "gemm": {"bm": 256, "bn": 256, "bk": 512},
    "gemv": {"bm": 512, "bk": 512},
    "dot": {"bk": 2048},
    "conv2d": {"bk": 128},
}

# app-level defaults installed by configure(); shape-exact DB hits override
_APP_BLOCKS: dict[str, dict[str, int]] = {}
# lazy tuning-db handle: (path, mtime) -> TuningDB, reloaded when the
# artifact changes on disk (tuning runs merge-save into it)
_DB_STATE: dict = {"path": None, "mtime": None, "db": None}


def _check(implementation: str, *tensors: torch.Tensor) -> bool:
    """-> whether to run the kernel; raises on an unknown implementation
    or a tensor that does not lie where the implementation runs."""
    if implementation not in IMPLEMENTATIONS:
        raise ValueError(f"implementation must be one of {IMPLEMENTATIONS}")
    want = DEVICE_OF[implementation]
    for t in tensors:
        if t.device.type != want:
            raise ValueError(f"implementation={implementation!r} runs on "
                             f"{want} tensors, got one on {t.device}")
    return implementation == "cuda"


def set_tuning_db(path) -> None:
    """Point the dispatch layer at a tuning database artifact."""
    _DB_STATE.update(path=path, mtime=None, db=None)


def _tuning_db():
    """The current TuningDB, reloaded on mtime change; never raises."""
    from repro_torch.tuner.db import DEFAULT_DB_PATH, TuningDB

    path = _DB_STATE["path"] or DEFAULT_DB_PATH
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        return None
    if _DB_STATE["db"] is None or _DB_STATE["mtime"] != mtime \
            or _DB_STATE["path"] != path:
        try:
            _DB_STATE.update(path=path, mtime=mtime, db=TuningDB.load(path))
        except Exception as e:   # a broken artifact must not break dispatch
            warnings.warn(f"tuning db {path}: {e}; using defaults")
            _DB_STATE.update(path=path, mtime=mtime, db=None)
    return _DB_STATE["db"]


def _db_best(op: str, shape, dtype, implementation: str) -> dict[str, int]:
    """Shape-exact tuned blocks from the DB for this backend only (records
    measured by another backend, the reference's 'interpret' ones included,
    never stand in), filtered to the op's known block names so a malformed
    artifact can only narrow, never break, dispatch."""
    db = _tuning_db()
    if db is None:
        return {}
    dt = str(dtype).removeprefix("torch.")
    rec = db.best_config(op, shape, dt, implementation) or {}
    return {k: v for k, v in rec.items() if k in DEFAULT_BLOCKS[op]}


def resolve_blocks(op: str, shape, dtype, implementation: str,
                   **explicit) -> dict[str, int]:
    """Block shapes for one kernel call: built-in defaults, overridden by
    app-level tuned defaults, overridden by a shape-exact tuning-db record,
    overridden by explicit (non-None) caller arguments."""
    out = dict(DEFAULT_BLOCKS[op])
    out.update(_APP_BLOCKS.get(op, {}))
    if any(v is None for v in explicit.values()):
        out.update(_db_best(op, shape, dtype, implementation))
    out.update({k: v for k, v in explicit.items() if v is not None})
    return out


def configure(app: str = "default", db_path=None,
              solutions_path=None) -> dict[str, dict[str, int]]:
    """Install app-level tuned block shapes as process-wide dispatch
    defaults.

    Sources, in priority order: the tuning database's ``apps`` section (the
    accelerator the measured co-design committed for ``app``), then the
    solution registry (``core/solution.py``).  Returns what was installed
    ({} when nothing is tuned — dispatch stays on safe defaults).
    """
    from repro_torch.core.solution import mxu_legal

    if db_path is not None:
        set_tuning_db(db_path)
    hw_dict = None
    db = _tuning_db()
    if db is not None:
        entry = db.apps.get(app)
        # apps entries are absorbed unvalidated: a malformed one must not
        # take down a launch — fall through to the registry instead
        if isinstance(entry, dict) and isinstance(entry.get("hw"), dict):
            hw_dict = entry["hw"]
    if hw_dict is None:
        try:
            from repro_torch.core.solution import load_hw

            hw = (load_hw(app, solutions_path) if solutions_path is not None
                  else load_hw(app))
            if hw is not None:
                hw_dict = {"pe_rows": hw.pe_rows, "pe_cols": hw.pe_cols,
                           "pe_depth": hw.pe_depth}
        except Exception as e:
            warnings.warn(f"solution registry unavailable ({e}); "
                          f"dispatch stays on defaults")
    if hw_dict is None:
        return {}

    def dim(knob: str, default: int) -> int:
        v = hw_dict.get(knob, default)
        return int(v) if isinstance(v, (int, float)) else default

    installed = {
        "gemm": {"bm": mxu_legal(dim("pe_rows", 256), 8),
                 "bn": mxu_legal(dim("pe_cols", 256), 128),
                 "bk": mxu_legal(dim("pe_depth", 512), 128)},
        "gemv": {"bm": mxu_legal(dim("pe_rows", 512), 8),
                 "bk": mxu_legal(dim("pe_depth", 512), 128)},
        "dot": {"bk": mxu_legal(dim("pe_depth", 2048), 128)},
        "conv2d": {"bk": mxu_legal(dim("pe_cols", 128), 8)},
    }
    _APP_BLOCKS.update(installed)
    return installed


def reset_dispatch() -> None:
    """Forget configure()/set_tuning_db state (tests)."""
    _APP_BLOCKS.clear()
    _DB_STATE.update(path=None, mtime=None, db=None)


def matmul(a, b, *, bm: int | None = None, bn: int | None = None,
           bk: int | None = None, implementation: str = "cuda"):
    if not _check(implementation, a, b):
        return ref.gemm_ref(a, b)
    blk = resolve_blocks("gemm", (a.shape[0], b.shape[1], a.shape[1]),
                         a.dtype, implementation, bm=bm, bn=bn, bk=bk)
    return _gemm.gemm(a, b, **blk)


def matvec(a, x, *, bm: int | None = None, bk: int | None = None,
           implementation: str = "cuda"):
    if not _check(implementation, a, x):
        return ref.gemv_ref(a, x)
    blk = resolve_blocks("gemv", tuple(a.shape), a.dtype, implementation,
                         bm=bm, bk=bk)
    return _gemv.gemv(a, x, **blk)


def dot(a, b, *, bk: int | None = None, implementation: str = "cuda"):
    if not _check(implementation, a, b):
        return ref.dot_ref(a, b)
    blk = resolve_blocks("dot", tuple(a.shape), a.dtype, implementation,
                         bk=bk)
    return _dotprod.dot(a, b, **blk)


def conv2d(a, w, *, bk: int | None = None, implementation: str = "cuda"):
    if not _check(implementation, a, w):
        return ref.conv2d_ref(a, w)
    c, h, wd = a.shape
    k, _, r, s = w.shape
    blk = resolve_blocks("conv2d", (k, c, h - r + 1, wd - s + 1, r, s),
                         a.dtype, implementation, bk=bk)
    return _conv2d.conv2d(a, w, **blk)


def tuned_matmul(a, b, app: str = "default", implementation: str = "cuda"):
    """GEMM with HASCO-tuned block shapes — the paper's technique as a
    first-class framework feature.  Shape-exact tuning-db records win;
    otherwise the app's co-designed accelerator from the solution registry
    sizes the blocks; otherwise the safe defaults."""
    from repro_torch.core.solution import kernel_blocks

    shape = (a.shape[0], b.shape[1], a.shape[1])
    bm, bn, bk = kernel_blocks(app)
    blk = {"bm": bm, "bn": bn, "bk": bk}
    blk.update(_db_best("gemm", shape, a.dtype, implementation))
    return matmul(a, b, implementation=implementation, **blk)
