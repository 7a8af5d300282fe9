"""GEMM intrinsic kernel wrapper: ``csrc/gemm.cu`` for CUDA tensors.

Replaces the Pallas TPU kernel ``repro/kernels/gemm.py::gemm``.  The block
shape (bm, bn, bk) is the co-designed accelerator parameter set:
``pe_rows x pe_cols`` maps to (bm, bn) and ``pe_depth`` to bk.  Any positive
block is taken as given (clamped to the dims, as the reference does): the
kernel masks the ragged edge itself and pads nothing in device memory.  What
bounds it on the H100 and what the design does about it is noted in the
CUDA source.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .ref import gemm_ref as gemm_plain


def gemm(a: torch.Tensor, b: torch.Tensor, *, bm: int = 256, bn: int = 256,
         bk: int = 512) -> torch.Tensor:
    """C = A @ B with f32 accumulation.  A: (M, K), B: (K, N), out in A's
    dtype.  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise TypeError(f"gemm dtypes differ: {a.dtype} vs {b.dtype}")
    if min(bm, bn, bk) < 1:
        raise ValueError(f"gemm blocks must be positive: {(bm, bn, bk)}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return gemm_plain(a, b)
    cuda_lib.check_operands(a, b)
    m, k = a.shape
    n = b.shape[1]
    if min(m, n, k) < 1:
        raise ValueError(f"gemm kernel takes no empty dims: {(m, n, k)}")
    bm, bn, bk = min(bm, m), min(bn, n), min(bk, k)
    if -(-m // bm) > 65535:
        raise ValueError(f"gemm grid has {-(-m // bm)} row blocks (> 65535)")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    rc = cuda_lib.library().hasco_gemm(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, bm, bn, bk,
        cuda_lib.dtype_code(a.dtype), torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(rc, "gemm")
    gemm.launches += 1
    return out


gemm.launches = 0

