"""Plain PyTorch versions of the four intrinsic kernels (the ``ref.py``
contract of the reference package, ``repro/kernels/ref.py``).

They are the port's oracles: simple, unfused, float32 inside, with the same
dtype contracts as the reference.  The CPU tests run them, and the kernel
wrappers use them only for a tensor that lies on the CPU.  Run on the card
they go through PyTorch's own libraries; set
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False there, or the float32 product
and convolution run in TF32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[m,n] = sum_k A[m,k] B[k,n], f32 accumulation, out in A's dtype."""
    return (a.float() @ b.float()).to(a.dtype)


def gemv_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[m] = sum_k A[m,k] x[k], out in A's dtype."""
    return (a.float() @ x.float()).to(a.dtype)


def dot_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Scalar dot product, f32 accumulation, returned as shape (1, 1) f32
    whatever the input dtype."""
    return (a.float() * b.float()).sum().reshape(1, 1)


def conv2d_ref(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """C[k,x,y] = sum_{c,r,s} A[c,x+r,y+s] W[k,c,r,s] ('valid' conv, the
    paper's CONV2D intrinsic semantics); a (C,H,W), w (K,C,R,S)."""
    return F.conv2d(a[None].float(), w.float())[0].to(a.dtype)
