"""GEMM intrinsic kernel wrapper: ``csrc/gemm.cu`` for CUDA tensors.

Replaces the Pallas TPU kernel ``repro/kernels/gemm.py::gemm``.  The block
shape (bm, bn, bk) is the co-designed accelerator parameter set:
``pe_rows x pe_cols`` maps to (bm, bn) and ``pe_depth`` to bk.  Any positive
block is taken and clamped to the dims as the reference does; :func:`plan`
legalises it to a CTA tile the kernel is compiled for and splits K over
CTAs where the tiles leave SMs idle.  The kernel masks the ragged edges
itself and pads nothing in device memory.  What bounds it on the H100 and
what the design does about it is noted in the CUDA source.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuda_lib
from .ref import gemm_ref as gemm_plain

# CTA tile rows / columns compiled (csrc/gemm.cu).  No 128 class: a 128-row
# tile leaves a 1024^3 product at most 128 tiles, fewer than the H100's SMs,
# so K would be split, and a split re-associates the float32 sums.  Measured
# on the H100 at 1024^3, a 4-way split sits 2.5x closer to a float64 product
# than cuBLAS but up to 2.3e-4 from it, past the 1e-4 that the kernels are
# held to; the unsplit 64 x 64 tile gives cuBLAS's bits.
TILE_SIDES = (32, 64)
STAGE_DEPTHS = (8, 16, 32)     # K values a shared-memory stage
MAX_SPLITS = 65535             # grid y
MAX_TILES = 2 ** 31 - 1        # grid x
SPLIT_SEARCH = 4               # split counts tried: up to this many CTAs an SM


class TilePlan(NamedTuple):
    block: tuple[int, ...]        # the block clamped to the dims
    tile: tuple[int, int, int]    # CTA tile: rows, columns, reduction a stage
    splits: int                   # CTAs along the reduction (1: no 2nd pass)
    span: int                     # reduction values a split (whole stages)
    ctas: int                     # output tiles x splits


def legalise(value: int, classes: tuple[int, ...]) -> int:
    """The largest class not above ``value``, else the smallest: monotone
    in ``value``."""
    return max((c for c in classes if c <= value), default=classes[0])


def split_reduction(tiles: int, stages: int, n_sm: int) -> tuple[int, int]:
    """-> (splits, stages a split) for ``tiles`` output tiles over a
    reduction of ``stages`` stages on ``n_sm`` SMs.  No split where the
    tiles cover the SMs.  Else, of the splits into balanced spans of whole
    stages that give at least ``n_sm`` CTAs (where the reduction has that
    many stages), the one with the least work on the busiest SM: stages a
    split times the CTAs an SM runs; ties go to fewer splits (less partial
    traffic)."""
    if tiles >= n_sm:
        return 1, stages
    best = None
    most = min(stages, MAX_SPLITS, -(-SPLIT_SEARCH * n_sm // tiles))
    for want in range(1, most + 1):
        per = -(-stages // want)
        splits = -(-stages // per)
        key = (tiles * splits < n_sm, per * -(-tiles * splits // n_sm), splits)
        if best is None or key < best[0]:
            best = (key, splits, per)
    return best[1], best[2]


def check_itemsize(itemsize: int) -> None:
    if itemsize not in (2, 4):
        raise ValueError(f"kernels take 2- or 4-byte elements, not {itemsize}")


def plan(m: int, n: int, k: int, itemsize: int, n_sm: int, bm: int, bn: int,
         bk: int) -> TilePlan:
    """The kernel's geometry for an (m, k) @ (k, n) product of
    ``itemsize``-byte elements on a card of ``n_sm`` SMs: (bm, bn) pick the
    tile's rows and columns from :data:`TILE_SIDES` and bk its stage depth
    from :data:`STAGE_DEPTHS` (blocks at or above the largest class share
    it), then K is split where the tiles are fewer than the SMs."""
    if min(bm, bn, bk) < 1:
        raise ValueError(f"gemm blocks must be positive: {(bm, bn, bk)}")
    check_itemsize(itemsize)
    block = (min(bm, m), min(bn, n), min(bk, k))
    tile = (legalise(block[0], TILE_SIDES), legalise(block[1], TILE_SIDES),
            legalise(block[2], STAGE_DEPTHS))
    tiles = -(-m // tile[0]) * -(-n // tile[1])
    if tiles > MAX_TILES:
        raise ValueError(f"gemm grid has {tiles} tiles (> {MAX_TILES})")
    splits, per = split_reduction(tiles, -(-k // tile[2]), n_sm)
    return TilePlan(block, tile, splits, per * tile[2], tiles * splits)


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
    p = plan(m, n, k, a.element_size(), cuda_lib.sm_count(a.device.index),
             bm, bn, bk)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    partial = (torch.empty((p.splits, m, n), dtype=torch.float32,
                           device=a.device) if p.splits > 1 else out)
    rc = cuda_lib.library().hasco_gemm(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), partial.data_ptr(), m, n,
        k, *p.tile, p.splits, p.span, cuda_lib.dtype_code(a.dtype),
        torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(rc, "gemm")
    gemm.launches += 1
    return out


gemm.launches = 0
