"""Plain PyTorch oracles of the kernels (the ``ref.py`` contract of the
reference package, ``repro/kernels/ref.py``): the four intrinsics,
attention, and the RWKV-6 and Mamba-2 recurrences.

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


def rwkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              state: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 (Finch) WKV oracle: the strict sequential recurrence.

    r/k/w: (B, T, H, Dk), w the per-channel log-decay (<= 0); v: (B, T, H,
    Dv); u: (H, Dk) bonus; state: (B, H, Dk, Dv) or None.  Returns (out
    (B, T, H, Dv) in v's dtype, final state in float32).

      o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T);  S_t = diag(e^{w_t}) S_{t-1} + k_t v_t^T
    """
    b, t, h, dk = k.shape
    dv = v.shape[-1]
    s = (torch.zeros((b, h, dk, dv), device=v.device) if state is None
         else state.float())
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    outs = []
    for i in range(t):
        kv = kf[:, i, :, :, None] * vf[:, i, :, None, :]      # (B,H,Dk,Dv)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, i], s + uf * kv))
        s = torch.exp(wf[:, i])[..., None] * s + kv
    return torch.stack(outs, dim=1).to(v.dtype), s


def mamba2_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, state: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD oracle: the sequential recurrence.

    x: (B, T, H, P) head inputs; a: (B, T, H) per-head log-decay (<= 0);
    b/c: (B, T, H, N) input/output projections; state: (B, H, N, P) or
    None.  Returns (y (B, T, H, P) in x's dtype, final state in float32).

      h_t = e^{a_t} h_{t-1} + b_t x_t^T;  y_t = c_t^T h_t
    """
    bs, t, h, p = x.shape
    n = b.shape[-1]
    s = (torch.zeros((bs, h, n, p), device=x.device) if state is None
         else state.float())
    xf, af, bf, cf = (z.float() for z in (x, a, b, c))
    ys = []
    for i in range(t):
        s = torch.exp(af[:, i])[..., None, None] * s \
            + bf[:, i, :, :, None] * xf[:, i, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", cf[:, i], s))
    return torch.stack(ys, dim=1).to(x.dtype), s
