"""Dispatch wrappers for the intrinsic kernels, attention and the
recurrences (RWKV-6, Mamba-2).

Every op takes ``implementation``: 'cuda' (the hand-written kernel; CUDA
tensors only) or 'torch' (the plain PyTorch version; CPU tensors only).  A
tensor on the wrong device raises: dispatch never moves data and never
falls back from one implementation to the other.  The kernels have no
backward, so 'cuda' attention and recurrences raise under autograd (an
input that requires grad, grad mode on); training runs ``kernels.plain``.

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
from . import flash_attention as _flash
from . import gemm as _gemm
from . import gemv as _gemv
from . import mamba2 as _mamba2
from . import ref, xla_attention, xla_linear
from . import rwkv6 as _rwkv6

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


def _no_grad_through_kernel(name: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would have to differentiate a hand-written
    kernel: none has a backward (nor has its Pallas original), so training
    runs the plain versions, never a silent switch to them."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {name} kernel has no backward: run a model under autograd "
            f"with impl=kernels.plain (the reference's 'xla' training "
            f"implementation; launch/steps.py's default), or run the kernel "
            f"under torch.no_grad()")


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


def attention(q, k, v, *, causal: bool = True, softcap: float = 0.0,
              window: int = 0, scale: float | None = None,
              implementation: str = "cuda"):
    """q (B, Sq, H, D), k/v (B, Skv, Hkv, D) -> (B, Sq, H, D).  'cuda' runs
    the flash kernel, 'torch' the chunked plain version.  No block shape is
    taken: the CUDA kernel's tiles are fixed (64 by 64) and the plain
    version walks 256-key chunks, as the reference's 'xla' implementation
    does."""
    kw = dict(causal=causal, softcap=softcap, window=window, scale=scale)
    if implementation == "cuda":
        _no_grad_through_kernel("flash_attention", q, k, v)
    if not _check(implementation, q, k, v):
        return xla_attention.attention(q, k, v, **kw)
    return _flash.flash_attention(q, k, v, **kw)


def rwkv6(r, k, v, w, u, state=None, *, implementation: str = "cuda"):
    """RWKV-6 WKV: r/k/w (B, T, H, Dk), v (B, T, H, Dv), u (H, Dk), state
    (B, H, Dk, Dv) float32 or None -> (out in v's dtype, final state
    float32), any T >= 1.  'cuda' runs the kernel (chunks of 16), 'torch'
    the plain chunked version (chunks of 32); neither chunk is a knob."""
    ts = (r, k, v, w, u) + (() if state is None else (state,))
    if implementation == "cuda":
        _no_grad_through_kernel("rwkv6", *ts)
    if not _check(implementation, *ts):
        return xla_linear.rwkv6(r, k, v, w, u, state)
    return _rwkv6.rwkv6(r, k, v, w, u, state)


def mamba2(x, a, b, c, state=None, *, implementation: str = "cuda"):
    """Mamba-2 SSD: x (B, T, H, P), a (B, T, H), b/c (B, T, H, N) (stride 0
    over H allowed), state (B, H, N, P) float32 or None -> (y in x's
    dtype, final state float32), any T >= 1.  'cuda' runs the kernel
    (chunks of 64), 'torch' the plain chunked version (chunks of 128);
    neither chunk is a knob."""
    ts = (x, a, b, c) + (() if state is None else (state,))
    if implementation == "cuda":
        _no_grad_through_kernel("mamba2", *ts)
    if not _check(implementation, *ts):
        return xla_linear.mamba2(x, a, b, c, state)
    return _mamba2.mamba2(x, a, b, c, state)


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
