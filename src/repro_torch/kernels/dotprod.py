"""DOT intrinsic kernel wrapper: ``csrc/dotprod.cu`` for CUDA tensors.

Replaces the Pallas TPU kernel ``repro/kernels/dotprod.py::dot``: the most
general and least data-reusing of the paper's four intrinsics.  ``bk``
(``pe_depth``) is validated and clamped to the length as the reference does,
but the kernel's geometry (:func:`plan`) follows the card alone: a few CTAs
per SM over contiguous spans of whole 16-byte vector rounds, then a
fixed-order sum of their partials.  So the result's bits depend on K, the
dtype, the SM count and the operands' offsets mod 16 bytes, never on bk.
What bounds it on the H100 is noted in the CUDA source.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuda_lib
from .ref import dot_ref as dot_plain

THREADS = 256           # csrc/dotprod.cu
CTAS_PER_SM = 4         # CTAs of pass 1 on each SM
MIN_VECTORS = 8         # 16-byte vectors per thread in one span, at least


class DotPlan(NamedTuple):
    block: int          # bk clamped to K
    ctas: int           # CTAs of pass 1 (1: no second pass)
    span: int           # K values one CTA sums


def plan(k: int, itemsize: int, n_sm: int, bk: int) -> DotPlan:
    """The kernel's geometry for ``k`` pairs of ``itemsize``-byte elements
    on a card of ``n_sm`` SMs: ``CTAS_PER_SM`` CTAs an SM, each over a span
    of whole warp-wide vector rounds and at least ``MIN_VECTORS`` vectors a
    thread, so a small K takes one CTA.  The block does not enter it."""
    round_ = 32 * (16 // itemsize)               # one vector per lane
    span = max(-(-k // (CTAS_PER_SM * n_sm)),
               MIN_VECTORS * THREADS * (16 // itemsize))
    span = -(-span // round_) * round_
    return DotPlan(min(bk, k), -(-k // span), span)


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
    p = plan(k, a.element_size(), cuda_lib.sm_count(a.device.index), bk)
    out = torch.empty((1, 1), dtype=torch.float32, device=a.device)
    partial = (torch.empty((p.ctas,), dtype=torch.float32, device=a.device)
               if p.ctas > 1 else out)
    rc = cuda_lib.library().hasco_dot(
        a.data_ptr(), b.data_ptr(), partial.data_ptr(), out.data_ptr(), k,
        p.ctas, p.span, cuda_lib.dtype_code(a.dtype),
        torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(rc, "dot")
    dot.launches += 1
    return out


dot.launches = 0
