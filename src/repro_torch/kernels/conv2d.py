"""CONV2D intrinsic kernel wrapper: ``csrc/conv2d.cu`` for CUDA tensors.

Replaces the Pallas TPU kernel ``repro/kernels/conv2d.py::conv2d``: a
direct 'valid' convolution, C[k,x,y] = sum_{c,r,s} A[c,x+r,y+s] W[k,c,r,s],
with no im2col buffer (the paper's Fig. 11).  ``bk`` (output channels per
CTA) is taken as given, clamped to K as the reference does.  Where the
reference keeps the whole input resident per program, the kernel stages a
spatial tile with its halo; see the CUDA source for what bounds it.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .ref import conv2d_ref as conv2d_plain


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
    bk = min(bk, k)
    x, y = h - r + 1, wd - s + 1
    out = torch.empty((k, x, y), dtype=a.dtype, device=a.device)
    rc = cuda_lib.library().hasco_conv2d(
        a.data_ptr(), w.data_ptr(), out.data_ptr(), c, h, wd, k, r, s, bk,
        cuda_lib.dtype_code(a.dtype), torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(rc, "conv2d")
    conv2d.launches += 1
    return out


conv2d.launches = 0
