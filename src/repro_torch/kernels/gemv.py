"""GEMV intrinsic kernel wrapper: ``csrc/gemv.cu`` for CUDA tensors.

Replaces the Pallas TPU kernel ``repro/kernels/gemv.py::gemv``.  Rows
stream in (bm, bk) blocks (``pe_rows x pe_depth`` in HASCO terms); any
positive block is taken as given, clamped to the dims as the reference
does, and the kernel masks the ragged edge.  What bounds it on the H100 and
what the design does about it is noted in the CUDA source.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .ref import gemv_ref as gemv_plain


def gemv(a: torch.Tensor, x: torch.Tensor, *, bm: int = 512,
         bk: int = 512) -> torch.Tensor:
    """y[m] = sum_k A[m,k] x[k] with f32 accumulation; returns (M,) in A's
    dtype.  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises."""
    if a.dim() != 2 or x.shape != (a.shape[1],):
        raise ValueError(f"gemv shapes {tuple(a.shape)} @ {tuple(x.shape)}")
    if a.dtype != x.dtype:
        raise TypeError(f"gemv dtypes differ: {a.dtype} vs {x.dtype}")
    if min(bm, bk) < 1:
        raise ValueError(f"gemv blocks must be positive: {(bm, bk)}")
    if a.device.type == "cpu" and x.device.type == "cpu":
        return gemv_plain(a, x)
    cuda_lib.check_operands(a, x)
    m, k = a.shape
    if min(m, k) < 1:
        raise ValueError(f"gemv kernel takes no empty dims: {(m, k)}")
    bm, bk = min(bm, m), min(bk, k)
    out = torch.empty((m,), dtype=a.dtype, device=a.device)
    rc = cuda_lib.library().hasco_gemv(
        a.data_ptr(), x.data_ptr(), out.data_ptr(), m, k, bm, bk,
        cuda_lib.dtype_code(a.dtype), torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(rc, "gemv")
    gemv.launches += 1
    return out


gemv.launches = 0
