"""Build and bind the hand-written CUDA kernels of ``csrc/``.

The sources are compiled with ``nvcc`` for ``sm_90a`` (one process per
source, all started together, then one link) into a shared library with a
plain C interface, loaded with :mod:`ctypes`.  The library is built at first
use into ``build/repro_torch/<hash of the sources and flags>/`` at the root
of the checkout (listed in ``.gitignore``), so a fresh checkout builds its
own and an edited source never loads a stale one.

Nothing here runs at import: the CPU-only test environment has no ``nvcc``
and imports every module.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("gemm.cu", "gemv.cu", "dotprod.cu", "conv2d.cu")
HEADERS = ("common.cuh",)
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libhasco_kernels.so"

# dtype codes of the C interface (csrc/common.cuh)
DTYPE_CODES = {"float32": 0, "bfloat16": 1}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "hasco_gemm": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "hasco_gemv": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "hasco_dot": [_P, _P, _P, _P, _LL, _LL, _I, _P],
    "hasco_conv2d": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in (*HEADERS, *SOURCES):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, dict]:
    """-> (path of the shared library, build info).  Builds it unless the
    same sources were built before; info holds ``seconds`` (0.0 when
    reused) and ``log`` (nvcc's ptxas report: registers, spills, shared
    memory per kernel)."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, {"seconds": 0.0, "log": ""}
    t0 = time.perf_counter()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        tmp = Path(tmp)
        procs = [(src, subprocess.Popen(
            [cc, *FLAGS, "-c", str(CSRC / src), "-o", str(tmp / f"{src}.o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in SOURCES]
        logs, failed = [], []
        for src, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src}\n{out}")
            if p.returncode:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        link = subprocess.run(
            [cc, *ARCH, "-shared", "-o", str(tmp / LIB_NAME),
             *(str(tmp / f"{s}.o") for s in SOURCES)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        staged = tmp / "lib"
        staged.mkdir()
        (tmp / LIB_NAME).rename(staged / LIB_NAME)
        try:
            staged.rename(out_dir)   # atomic: a reader sees all or nothing
        except OSError:
            if not lib.exists():     # not a concurrent build of the same
                raise
    return lib, {"seconds": time.perf_counter() - t0, "log": "\n".join(logs)}


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with every entry
    point's argument types declared: pointers and the stream as
    ``c_void_p``, so ctypes never truncates them to 32 bits."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error (its return value is
    ``cudaGetLastError()`` right after the launch: a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")


def dtype_code(dtype) -> int:
    name = str(dtype).removeprefix("torch.")
    if name not in DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, not {name}")
    return DTYPE_CODES[name]


def check_operands(*ts) -> None:
    """Operands a kernel takes: CUDA tensors, on one card, contiguous."""
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"kernel operands must all be CUDA tensors, got "
                             f"{[str(x.device) for x in ts]}")
        if t.device != ts[0].device:
            raise ValueError("kernel operands lie on different cards")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
