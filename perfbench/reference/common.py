"""Plain float32 building blocks of the reference models.

Straightforward PyTorch, written for this benchmark and independent of the
program under test: nothing here imports the program or the JAX package.
Every function computes in float32 whatever its inputs' type, with TF32
off (:func:`no_tf32`).

A matrix product goes through a ``Matmul`` policy so that one forward can
be run at two precisions: :func:`mm_f32` (the reference) and
:func:`mm_fp8` (the control: both operands rounded to float8 e4m3 with a
scale per row of the left and per column of the right, as an fp8 GEMM
takes them, and accumulated in float32).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
FP8_MAX = 448.0                      # largest finite float8 e4m3fn


@contextlib.contextmanager
def no_tf32():
    """Float32 matrix products in full float32 while the block runs."""
    cuda, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.float() @ b.float()


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's largest magnitude maps to 448), back in float32."""
    t = t.float()
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def mm_fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fp8_round(a, -1) @ fp8_round(b, -2)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    x = x.float()
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (S, H, D) at positions 0..S-1, the two
    halves of the head dim rotated as pairs."""
    s, d = x.shape[0], x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, block: int = 1024) -> torch.Tensor:
    """Softmax attention of q (S, H, D) over k, v (S, Hkv, D), causal,
    scale D^-0.5, query head i reading kv head i // (H / Hkv); computed a
    block of query rows at a time."""
    s, h, d = q.shape
    g = h // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1).transpose(0, 1)  # (H, S, D)
    vf = v.float().repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty((s, h, d), dtype=torch.float32, device=q.device)
    for r0 in range(0, s, block):
        r1 = min(s, r0 + block)
        qb = q[r0:r1].float().transpose(0, 1)                    # (H, b, D)
        sc = (qb @ kf[:, :r1].transpose(1, 2)) * d ** -0.5       # (H, b, r1)
        qpos = torch.arange(r0, r1, device=q.device)[:, None]
        kpos = torch.arange(r1, device=q.device)[None, :]
        sc = sc.masked_fill(kpos > qpos, float("-inf"))
        out[r0:r1] = (torch.softmax(sc, dim=-1) @ vf[:, :r1]).transpose(0, 1)
    return out


def ssd(x, a, b, c, chunk: int = 256):
    """Mamba-2 SSD, zero initial state: x (S, H, P), a (S, H) log-decay
    <= 0, b/c (S, N) shared by every head.  y_t = sum_{s<=t}
    exp(A_t - A_s) (c_t . b_s) x_s with A the running sum of a; computed a
    chunk at a time with the state carried between chunks."""
    s_len, h, p = x.shape
    n = b.shape[-1]
    x, a, b, c = x.float(), a.float(), b.float(), c.float()
    state = torch.zeros((h, n, p), device=x.device)
    y = torch.empty_like(x)
    for t0 in range(0, s_len, chunk):
        t1 = min(s_len, t0 + chunk)
        xb, ab, bb, cb = x[t0:t1], a[t0:t1], b[t0:t1], c[t0:t1]
        la = torch.cumsum(ab, dim=0)                              # (L, H)
        # from the carried state
        yb = torch.einsum("ln,hnp->lhp", cb, state) * torch.exp(la)[..., None]
        # inside the chunk
        ell = t1 - t0
        diff = la[:, None, :] - la[None, :, :]                    # (t, s, H)
        keep = torch.ones((ell, ell), dtype=torch.bool,
                          device=x.device).tril()[..., None]
        decay = torch.where(keep, torch.exp(diff.clamp(max=0.0)), 0.0)
        gram = (cb @ bb.T)[..., None] * decay                     # (t, s, H)
        yb = yb + torch.einsum("tsh,shp->thp", gram, xb)
        y[t0:t1] = yb
        last = la[-1]                                             # (H,)
        bd = torch.exp(last[None, :] - la)                        # (L, H)
        state = torch.exp(last)[:, None, None] * state + torch.einsum(
            "ln,lh,lhp->hnp", bb, bd, xb)
    return y


def wkv6(r, k, v, w, u, chunk: int = 128):
    """RWKV-6 WKV, zero initial state: r/k/w (S, H, K), v (S, H, V), u
    (H, K), w the per-channel log-decay <= 0.  o_t = r_t . (S_{t-1} +
    diag(u) k_t v_t^T), S_t = diag(exp(w_t)) S_{t-1} + k_t v_t^T; computed
    a chunk at a time with the state carried between chunks."""
    s_len, h, dk = k.shape
    dv = v.shape[-1]
    r, k, v, w, u = (z.float() for z in (r, k, v, w, u))
    state = torch.zeros((h, dk, dv), device=v.device)
    out = torch.empty((s_len, h, dv), device=v.device)
    for t0 in range(0, s_len, chunk):
        t1 = min(s_len, t0 + chunk)
        rb, kb, vb, wb = r[t0:t1], k[t0:t1], v[t0:t1], w[t0:t1]
        incl = torch.cumsum(wb, dim=0)                            # (L, H, K)
        excl = incl - wb
        ob = torch.einsum("lhk,hkv->lhv", rb * torch.exp(excl), state)
        ell = t1 - t0
        expo = excl[:, None] - incl[None, :]                      # (t, s, H, K)
        strict = torch.ones((ell, ell), dtype=torch.bool,
                            device=v.device).tril(-1)[..., None, None]
        pair = torch.where(strict, torch.exp(expo.clamp(max=0.0)), 0.0)
        scores = torch.einsum("tshk,thk,shk->ths", pair, rb, kb)
        ob = ob + torch.einsum("ths,shv->thv", scores, vb)
        ob = ob + torch.einsum("lhk,hk,lhk->lh", rb, u, kb)[..., None] * vb
        out[t0:t1] = ob
        last = incl[-1]                                           # (H, K)
        kd = kb * torch.exp(last[None] - incl)
        state = torch.exp(last)[..., None] * state + torch.einsum(
            "lhk,lhv->hkv", kd, vb)
    return out


def shift(x: torch.Tensor) -> torch.Tensor:
    """x_{t-1} for x (S, D), zeros at t = 0."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)


def causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    """Depthwise causal convolution of x (S, C) with w (K, C), then silu:
    y_t = silu(bias + sum_i w_i x_{t-K+1+i})."""
    kw = w.shape[0]
    ext = torch.cat([x.new_zeros((kw - 1, x.shape[1])), x.float()], dim=0)
    y = bias.float() + sum(ext[i:i + x.shape[0]] * w[i].float()
                           for i in range(kw))
    return F.silu(y)


def next_token_logprobs(logits: torch.Tensor, tokens: torch.Tensor):
    """log p(tokens[t+1] | tokens[..t]) for t < S-1, float32, from logits
    (S, V) over tokens (S,)."""
    lp = torch.log_softmax(logits[:-1].float(), dim=-1)
    return lp.gather(-1, tokens[1:, None].long())[:, 0]


@dataclass(frozen=True)
class Leaf:
    """One parameter of a model tree: its shape and type, how it is
    drawn (``scale`` times a standard normal, plus ``offset``; a scale of
    0 is the constant ``offset``), and how many times a token multiplies
    by it as a matrix (0: not a matrix product)."""
    shape: tuple
    dtype: str
    scale: float = 0.0
    offset: float = 0.0
    mm_calls: int = 0

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n
