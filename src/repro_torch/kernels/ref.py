"""Plain PyTorch oracles of the kernels (the ``ref.py`` contract of the
reference package, ``repro/kernels/ref.py``): the four intrinsics and
attention.

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


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, softcap: float = 0.0,
                  window: int = 0, scale: float | None = None
                  ) -> torch.Tensor:
    """Multi-head attention oracle.

    q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D) with H % Hkv == 0 (GQA).
    ``softcap``: gemma2 logit soft-capping  cap*tanh(logits/cap).
    ``window``: >0 = local (sliding-window) attention of that width.
    Query i sits at position i + Skv - Sq.  A row that sees no key
    averages v over all Skv keys (a softmax of equal masked logits).
    """
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    assert h % hkv == 0
    g = h // hkv
    scale = scale if scale is not None else d ** -0.5
    qf = q.float().reshape(b, sq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)
