"""Memory-efficient attention in plain PyTorch: the plain version of the
``flash_attention`` kernel (``csrc/flash_attention.cu``).

Port of the forward of ``repro/kernels/xla_attention.py``: a loop over KV
chunks with an online softmax in float32, so memory grows with S·chunk and
never with S².  Semantics match the kernel: GQA, a causal mask aligned to
the bottom right (query i sits at i + Skv - Sq), the gemma2 logit soft-cap,
a sliding window, default scale D^-0.5.  A row that sees no key comes out
as zeros (its softmax denominator stays 0).

The reference wraps this in a custom VJP with flash-style recomputation for
training; its ``torch.autograd.Function`` comes with the training slice.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, softcap: float = 0.0, window: int = 0,
              scale: float | None = None, chunk: int = 256) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D), H % Hkv == 0.  Returns
    (B, Sq, H, D) in q's dtype; float32 inside."""
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    g = h // hkv
    sc = float(scale if scale is not None else d ** -0.5)
    chunk = min(chunk, skv)
    dev = q.device
    qf = q.float().reshape(b, sq, hkv, g, d) * sc
    qpos = (torch.arange(sq, device=dev) + (skv - sq))[:, None]
    m = torch.full((b, sq, hkv, g), NEG_INF, device=dev)
    l = torch.zeros((b, sq, hkv, g), device=dev)
    acc = torch.zeros((b, sq, hkv, g, d), device=dev)
    for c0 in range(0, skv, chunk):
        kb = k[:, c0:c0 + chunk].float()
        vb = v[:, c0:c0 + chunk].float()
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kb)
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        kpos = c0 + torch.arange(kb.shape[1], device=dev)[None, :]
        mask = torch.ones((sq, kb.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (kpos <= qpos)
        if window > 0:
            mask = mask & (kpos > qpos - window)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m_new[..., None]),
                        0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p,
                                                    vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, sq, h, d).to(q.dtype)
