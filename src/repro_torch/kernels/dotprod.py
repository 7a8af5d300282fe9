"""DOT intrinsic kernel wrapper: ``csrc/dotprod.cu`` for CUDA tensors.

Replaces the Pallas TPU kernel ``repro/kernels/dotprod.py::dot``: the most
general and least data-reusing of the paper's four intrinsics.  ``bk``
(``pe_depth``) is the chunk one CTA reduces; any positive value is taken as
given, clamped to the length as the reference does.  The two-pass
reduction gives the same bits on every run; what bounds it on the H100 is
noted in the CUDA source.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .ref import dot_ref as dot_plain


def dot(a: torch.Tensor, b: torch.Tensor, *, bk: int = 2048) -> torch.Tensor:
    """sum(a * b) over 1-D operands; returns shape (1, 1) float32 whatever
    the input dtype.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    if a.dim() != 1 or b.shape != a.shape:
        raise ValueError(f"dot shapes {tuple(a.shape)} . {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise TypeError(f"dot dtypes differ: {a.dtype} vs {b.dtype}")
    if bk < 1:
        raise ValueError(f"dot block must be positive: {bk}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return dot_plain(a, b)
    cuda_lib.check_operands(a, b)
    (k,) = a.shape
    if k < 1:
        raise ValueError("dot kernel takes no empty operands")
    bk = min(bk, k)
    partial = torch.empty((-(-k // bk),), dtype=torch.float32, device=a.device)
    out = torch.empty((1, 1), dtype=torch.float32, device=a.device)
    rc = cuda_lib.library().hasco_dot(
        a.data_ptr(), b.data_ptr(), partial.data_ptr(), out.data_ptr(), k, bk,
        cuda_lib.dtype_code(a.dtype), torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(rc, "dot")
    dot.launches += 1
    return out


dot.launches = 0
