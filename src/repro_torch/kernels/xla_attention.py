"""Memory-efficient attention in plain PyTorch: the plain version of the
``flash_attention`` kernel (``csrc/flash_attention.cu``) and the attention
that training differentiates.

Port of ``repro/kernels/xla_attention.py``.  Forward: a loop over KV chunks
with an online softmax, so memory grows with S·chunk and never with S².
Backward: the reference's custom VJP as a ``torch.autograd.Function`` with
flash-style recomputation: only (q, k, v, out, lse) are saved (out and lse
in float32), and each chunk's probabilities are rebuilt from the
log-sum-exp in the backward loop.  Without it, autograd through the
forward loop would save every chunk's scores and probabilities: the whole
S x S matrix several times.

Semantics match the kernel: GQA (dK and dV summed over each query group),
a causal mask aligned to the bottom right (query i sits at i + Skv - Sq),
the gemma2 logit soft-cap, a sliding window, default scale D^-0.5.  A row
that sees no key comes out as zeros (its softmax denominator stays 0) and
gets zero gradients.  Float32 inside (float64 for float64 inputs).  Where
Skv is not a multiple of the chunk, the last chunk is shorter (the
reference pads it with masked keys).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
DEFAULT_CHUNK = 256      # keys a step of the loop, as in the reference


def _mask(c0: int, n: int, qpos: torch.Tensor, causal: bool,
          window: int) -> torch.Tensor | None:
    """(Sq, n) visibility of keys c0..c0+n-1, None where all are seen."""
    if not causal and window <= 0:
        return None
    kpos = c0 + torch.arange(n, device=qpos.device)[None, :]
    mask = torch.ones((qpos.shape[0], n), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    return mask


def _scores(qf, kb, softcap):
    """(raw scores after the soft-cap, tanh of the capped scores or None)."""
    s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kb)
    if softcap > 0:
        t = torch.tanh(s / softcap)
        return softcap * t, t
    return s, None


def _forward(q, k, v, causal, softcap, window, sc, chunk):
    """-> (out (B, Sq, H, D) and lse (B, Sq, Hkv, G), both in float32, or
    float64 for float64 inputs)."""
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    g = h // hkv
    ct = torch.promote_types(q.dtype, torch.float32)
    dev = q.device
    qf = q.to(ct).reshape(b, sq, hkv, g, d) * sc
    qpos = (torch.arange(sq, device=dev) + (skv - sq))[:, None]
    m = torch.full((b, sq, hkv, g), NEG_INF, dtype=ct, device=dev)
    l = torch.zeros((b, sq, hkv, g), dtype=ct, device=dev)
    acc = torch.zeros((b, sq, hkv, g, d), dtype=ct, device=dev)
    for c0 in range(0, skv, chunk):
        kb = k[:, c0:c0 + chunk].to(ct)
        vb = v[:, c0:c0 + chunk].to(ct)
        s, _ = _scores(qf, kb, softcap)
        mask = _mask(c0, kb.shape[1], qpos, causal, window)
        if mask is not None:
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m_new[..., None]),
                        0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p,
                                                    vb)
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    out = (acc / l_safe[..., None]).reshape(b, sq, h, d)
    return out, m + torch.log(l_safe)


def _backward(q, k, v, out, lse, do, causal, softcap, window, sc, chunk):
    """-> (dq, dk, dv) in q's, k's and v's dtypes."""
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    g = h // hkv
    ct = lse.dtype
    qf = q.to(ct).reshape(b, sq, hkv, g, d)
    dof = do.to(ct).reshape(b, sq, hkv, g, d)
    of = out.reshape(b, sq, hkv, g, d)
    delta = torch.sum(dof * of, dim=-1)                 # (b, sq, hkv, g)
    qpos = (torch.arange(sq, device=q.device) + (skv - sq))[:, None]
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for c0 in range(0, skv, chunk):
        kf = k[:, c0:c0 + chunk].to(ct)
        vf = v[:, c0:c0 + chunk].to(ct)
        s, t = _scores(qf * sc, kf, softcap)
        mask = _mask(c0, kf.shape[1], qpos, causal, window)
        if mask is not None:
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - lse[..., None]),
                        0.0)
        dvs.append(torch.einsum("bqhgk,bqhgd->bkhd", p, dof))
        dp = torch.einsum("bqhgd,bkhd->bqhgk", dof, vf)
        ds = p * (dp - delta[..., None])
        if t is not None:
            ds = ds * (1.0 - t * t)
        dq = dq + torch.einsum("bqhgk,bkhd->bqhgd", ds, kf) * sc
        dks.append(torch.einsum("bqhgk,bqhgd->bkhd", ds, qf) * sc)
    return (dq.reshape(b, sq, h, d).to(q.dtype),
            torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


class ChunkedAttention(torch.autograd.Function):
    """The reference's ``chunked_attention`` custom VJP: saves (q, k, v,
    out, lse) and recomputes each chunk's probabilities backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, softcap, window, sc, chunk):
        out, lse = _forward(q, k, v, causal, softcap, window, sc, chunk)
        # out is kept in float32: the reference keeps it in q's dtype, and
        # a bfloat16-rounded out in delta = sum(do * out) put bfloat16
        # gradients up to 3x further from float32 than autograd through
        # the forward loop (B 1, S 256, H 4, D 80)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, softcap, window, sc, chunk)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, do, *ctx.cfg)
        return dq, dk, dv, None, None, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, softcap: float = 0.0, window: int = 0,
              scale: float | None = None,
              chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D), H % Hkv == 0.  Returns
    (B, Sq, H, D) in q's dtype; float32 inside.  Differentiable in q, k
    and v with memory linear in S."""
    d = q.shape[-1]
    sc = float(scale if scale is not None else d ** -0.5)
    return ChunkedAttention.apply(q, k, v, causal, softcap, window, sc,
                                  min(chunk, k.shape[1]))
