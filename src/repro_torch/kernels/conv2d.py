"""CONV2D intrinsic kernel wrapper: ``csrc/conv2d.cu`` for CUDA tensors.

Replaces the Pallas TPU kernel ``repro/kernels/conv2d.py::conv2d``: a
direct 'valid' convolution, C[k,x,y] = sum_{c,r,s} A[c,x+r,y+s] W[k,c,r,s],
with no im2col buffer in device memory (the paper's Fig. 11).  It runs as
an implicit GEMM on GEMM's tile: ``bk`` (output channels per CTA, clamped
to K as the reference does) picks the tile's channels, and :func:`plan`
splits C*R*S over CTAs where the tiles leave SMs idle; see the CUDA source
for what bounds it.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .gemm import (MAX_TILES, TilePlan, check_itemsize, legalise,
                   split_reduction)
from .ref import conv2d_ref as conv2d_plain

TILE_CHANNELS = (32, 64, 128)   # output channels a CTA tile (csrc/conv2d.cu)
TILE_PIXELS = 64    # output pixels a CTA tile
STAGE_DEPTH = 32    # C*R*S values a shared-memory stage


def plan(k: int, c: int, x: int, y: int, r: int, s: int, itemsize: int,
         n_sm: int, bk: int) -> TilePlan:
    """The kernel's geometry for K output channels over an X x Y output
    from C channels and R x S taps, ``itemsize``-byte elements, on a card
    of ``n_sm`` SMs: bk picks the tile's channels from :data:`TILE_CHANNELS`
    (blocks at or above the largest class share it); the tile is
    ``TILE_PIXELS`` pixels wide and C*R*S is split where the tiles are
    fewer than the SMs."""
    if bk < 1:
        raise ValueError(f"conv2d block must be positive: {bk}")
    check_itemsize(itemsize)
    block = (min(bk, k),)
    tile = (legalise(block[0], TILE_CHANNELS), TILE_PIXELS, STAGE_DEPTH)
    tiles = -(-k // tile[0]) * -(-(x * y) // TILE_PIXELS)
    if tiles > MAX_TILES:
        raise ValueError(f"conv2d grid has {tiles} tiles (> {MAX_TILES})")
    splits, per = split_reduction(tiles, -(-(c * r * s) // STAGE_DEPTH), n_sm)
    return TilePlan(block, tile, splits, per * STAGE_DEPTH, tiles * splits)


def conv2d(a: torch.Tensor, w: torch.Tensor, *, bk: int = 128) -> torch.Tensor:
    """a: (C, H, W); w: (K, C, R, S); returns (K, H-R+1, W-S+1) in a's
    dtype.  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises."""
    if a.dim() != 3 or w.dim() != 4 or a.shape[0] != w.shape[1]:
        raise ValueError(f"conv2d shapes {tuple(a.shape)} * {tuple(w.shape)}")
    c, h, wd = a.shape
    k, _, r, s = w.shape
    if h < r or wd < s:
        raise ValueError(f"conv2d filter {(r, s)} larger than input {(h, wd)}")
    if a.dtype != w.dtype:
        raise TypeError(f"conv2d dtypes differ: {a.dtype} vs {w.dtype}")
    if bk < 1:
        raise ValueError(f"conv2d block must be positive: {bk}")
    if a.device.type == "cpu" and w.device.type == "cpu":
        return conv2d_plain(a, w)
    cuda_lib.check_operands(a, w)
    if min(c, k, r, s) < 1:
        raise ValueError(f"conv2d kernel takes no empty dims: {(k, c, r, s)}")
    x, y = h - r + 1, wd - s + 1
    p = plan(k, c, x, y, r, s, a.element_size(),
             cuda_lib.sm_count(a.device.index), bk)
    out = torch.empty((k, x, y), dtype=a.dtype, device=a.device)
    partial = (torch.empty((p.splits, k, x, y), dtype=torch.float32,
                           device=a.device) if p.splits > 1 else out)
    rc = cuda_lib.library().hasco_conv2d(
        a.data_ptr(), w.data_ptr(), out.data_ptr(), partial.data_ptr(), c, h,
        wd, k, r, s, p.tile[0], p.splits, p.span,
        cuda_lib.dtype_code(a.dtype), torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(rc, "conv2d")
    conv2d.launches += 1
    return out


conv2d.launches = 0
