"""GEMV intrinsic kernel wrapper: ``csrc/gemv.cu`` for CUDA tensors.

Replaces the Pallas TPU kernel ``repro/kernels/gemv.py::gemv``.  The block
(bm, bk) is ``pe_rows x pe_depth`` in HASCO terms: any positive block is
taken and clamped to the dims as the reference does, but the kernel's
geometry (:func:`plan`) follows the card alone: one warp per row, and K
split across CTAs where the rows leave SMs idle.  What bounds it on the
H100 and what the design does about it is noted in the CUDA source.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuda_lib
from .ref import gemv_ref as gemv_plain

ROWS_PER_CTA = 8        # one row per warp, 8 warps (csrc/gemv.cu)
CTAS_PER_SM = 2         # fewer row CTAs than this per SM: split K
MIN_VECTORS = 4         # 16-byte vectors per lane in one split, at least


class GemvPlan(NamedTuple):
    block: tuple[int, int]  # (bm, bk) clamped to (M, K)
    splits: int             # CTAs along K (1: no split-K pass)
    span: int               # K values one CTA sums


def plan(m: int, k: int, itemsize: int, n_sm: int, bm: int,
         bk: int) -> GemvPlan:
    """The kernel's geometry for an (m, k) matrix of ``itemsize``-byte
    elements on a card of ``n_sm`` SMs.  Split K only when the row CTAs
    are fewer than ``CTAS_PER_SM`` per SM, into spans of whole warp-wide
    vector rounds; the block does not enter it."""
    block = (min(bm, m), min(bk, k))
    ctas = -(-m // ROWS_PER_CTA)
    if ctas >= CTAS_PER_SM * n_sm:
        return GemvPlan(block, 1, k)
    round_ = 32 * (16 // itemsize)               # one vector per lane
    want = -(-CTAS_PER_SM * n_sm // ctas)
    span = max(-(-k // want), MIN_VECTORS * round_)
    span = -(-span // round_) * round_
    return GemvPlan(block, -(-k // span), span)


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
    p = plan(m, k, a.element_size(), cuda_lib.sm_count(a.device.index), bm, bk)
    out = torch.empty((m,), dtype=a.dtype, device=a.device)
    partial = (torch.empty((p.splits, m), dtype=torch.float32,
                           device=a.device) if p.splits > 1 else out)
    rc = cuda_lib.library().hasco_gemv(
        a.data_ptr(), x.data_ptr(), out.data_ptr(), partial.data_ptr(), m, k,
        p.splits, p.span, cuda_lib.dtype_code(a.dtype),
        torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(rc, "gemv")
    gemv.launches += 1
    return out


gemv.launches = 0
