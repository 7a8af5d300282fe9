"""Chunked RWKV-6 / Mamba-2 recurrences in plain PyTorch: the plain versions
of the ``rwkv6`` and ``mamba2`` kernels (``csrc/rwkv6.cu``,
``csrc/mamba2.cu``).

Port of ``repro/kernels/xla_linear.py``: the chunked math of the Pallas
kernels (formulas in ``kernels/rwkv6.py`` and ``kernels/mamba2.py``),
vectorised over (batch, heads), with a Python loop over chunks.  Float32
inside (float64 for float64 inputs: ``torch.promote_types(dtype,
float32)``, so float32 and bfloat16 inputs compute as in float32, and a
float64 run gives the readings that error is judged against); every
exponent is <= 0.

Unlike the reference, which asserts ``T % chunk == 0`` (its chunks are
min(32, T) and min(128, T), so a 40-token rwkv6 prompt raises), these take
any T >= 1: the tail is padded to a whole chunk with r = k = v = 0, w = 0
(rwkv6) or x = 0, a = 0, b = c = 0 (mamba2).  A padded step adds nothing to
any output and leaves the state as it was (its decay is e^0 = 1 and its
k v^T or b x^T is 0), so the real outputs and the final state are exact;
the padded rows are cut off the output.
"""
from __future__ import annotations

import torch


def _pad_time(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` (B, T, ...) with ``n`` zero steps appended on the time axis."""
    if n == 0:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], n, *x.shape[2:]))], dim=1)


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          w: torch.Tensor, u: torch.Tensor,
          state: torch.Tensor | None = None, *, chunk: int = 32
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV6.  r/k/w: (B, T, H, Dk), w the log-decay (<= 0); v: (B,
    T, H, Dv); u: (H, Dk); state: (B, H, Dk, Dv) or None.  Returns (out
    (B, T, H, Dv) in v's dtype, final state (B, H, Dk, Dv) in float32, or
    both in float64 for float64 inputs)."""
    b, t, h, dk = k.shape
    dv = v.shape[-1]
    ct = torch.promote_types(v.dtype, torch.float32)
    chunk = min(chunk, t)
    n = -(-t // chunk)
    pad = n * chunk - t
    rf, kf, vf, wf = (_pad_time(x.to(ct), pad) for x in (r, k, v, w))
    s = (torch.zeros((b, h, dk, dv), dtype=ct, device=v.device)
         if state is None else state.to(ct))
    uf = u.to(ct)
    strict = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=v.device).tril(-1)[None, :, :, None, None]
    outs = []
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        rb, kb, vb, wb = (x[:, sl] for x in (rf, kf, vf, wf))  # (b,L,h,d)
        lw = torch.cumsum(wb, dim=1)                           # inclusive
        aq = lw - wb                                           # exclusive
        o = torch.einsum("blhk,bhkv->blhv", rb * torch.exp(aq), s)
        expo = aq[:, :, None] - lw[:, None, :]                 # (b,L,L,h,dk)
        pair = torch.where(strict, torch.exp(torch.clamp(expo, max=0.0)),
                           0.0)
        scores = torch.einsum("btshk,bthk,bshk->bths", pair, rb, kb)
        o = o + torch.einsum("bths,bshv->bthv", scores, vb)
        o = o + torch.einsum("blhk,hk,blhk->blh", rb, uf, kb)[..., None] * vb
        lw_last = lw[:, -1:]
        kd = kb * torch.exp(lw_last - lw)
        s = torch.exp(lw_last[:, 0])[..., None] * s + \
            torch.einsum("blhk,blhv->bhkv", kd, vb)
        outs.append(o)
    out = torch.cat(outs, dim=1)[:, :t]
    return out.to(v.dtype), s


def mamba2(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           c: torch.Tensor, state: torch.Tensor | None = None, *,
           chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  x: (B, T, H, P); a: (B, T, H) log-decay (<= 0); b/c:
    (B, T, G, N) with G dividing H, head h reading group h // (H / G)
    ((B, T, H, N) possibly stride 0 over H); state: (B, H, N, P) or None.
    Returns (y (B, T, H, P) in x's dtype, final state (B, H, N, P) in
    float32, or both in float64 for float64 inputs)."""
    bs, t, h, p = x.shape
    n = b.shape[-1]
    if b.shape[2] != h:      # each group's b and c for each of its heads
        b, c = (z.repeat_interleave(h // z.shape[2], dim=2) for z in (b, c))
    ct = torch.promote_types(x.dtype, torch.float32)
    chunk = min(chunk, t)
    nc = -(-t // chunk)
    pad = nc * chunk - t
    xf, af, bf, cf = (_pad_time(z.to(ct), pad) for z in (x, a, b, c))
    s = (torch.zeros((bs, h, n, p), dtype=ct, device=x.device)
         if state is None else state.to(ct))
    incl = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()[None, :, :, None]
    ys = []
    for i in range(nc):
        sl = slice(i * chunk, (i + 1) * chunk)
        xb, ab, bb, cb = (z[:, sl] for z in (xf, af, bf, cf))
        la = torch.cumsum(ab, dim=1)                           # (b,L,h)
        y = torch.einsum("blhn,bhnp->blhp", cb * torch.exp(la)[..., None], s)
        decay = torch.where(incl, torch.exp(torch.clamp(
            la[:, :, None] - la[:, None, :], max=0.0)), 0.0)   # (b,t,s,h)
        gram = torch.einsum("bthn,bshn->btsh", cb, bb) * decay
        y = y + torch.einsum("btsh,bshp->bthp", gram, xb)
        la_last = la[:, -1:]
        bd = bb * torch.exp(la_last - la)[..., None]
        s = torch.exp(la_last[:, 0])[..., None, None] * s + \
            torch.einsum("blhn,blhp->bhnp", bd, xb)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :t]
    return y.to(x.dtype), s
