"""The rwkv6 block's glue: ``csrc/rwkv6_glue.cu`` for CUDA tensors.

The elementwise and row-norm work between the block's matrix products, as
six ops, each one kernel launch (the time mix's and the channel mix's
prologues share one kernel):

  rwkv6_time_in      rms_norm(x, ln1), the token shift and the five mixes
                     r, k, v, g, w, and the carry (the last normed row)
  rwkv6_decay        the log-decay -exp(clamp(float(w0 + lora), -8, 6)) in
                     the dtype the recurrence takes
  rwkv6_head_out     the per-head RMS norm of the WKV output times
                     silu(xg @ wg)
  rwkv6_channel_in   x + att, rms_norm(., ln2), the shift and the two mixes
                     k, r, and the carry
  rwkv6_relu2        relu(h)^2 of the channel mix's hidden layer
  rwkv6_channel_out  x + sigmoid(xr @ wcr) * (hidden @ wcv)

Replaces no Pallas kernel: the JAX package leaves this glue to XLA's fusion
(``repro/models/rwkv6.py:95-122``).  Each ``*_plain`` function is the
model's expression as it was written before the kernels, verbatim; the
wrappers take CUDA tensors only (contiguous, float32 or bfloat16, the
weights in the activations' dtype, rows of whole 16-byte vectors at
16-byte-aligned addresses, as every rwkv6 config's D, F and head size
give) and raise on anything else.  Each kernel
rounds where its plain version rounds, so the elementwise ones give its
bits and the norms differ only by their sums' order (the CUDA source says
how).  Each wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib
from .glue_common import fail, rms_norm, same_dtype, stream, vectors

MAX_THREADS = 640   # the prologue kernel's block at most: one 16-byte
                    # vector a thread (csrc/rwkv6_glue.cu's MIX_THREADS)


# ---------------------------------------------------------------------------
# Plain versions: the model's expressions, on any device, under autograd
# ---------------------------------------------------------------------------

def _shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """Token shift: x_{t-1}, with ``prev`` as the carry for decode."""
    if x.shape[1] == 1 and prev is not None:
        return prev[:, None, :]
    pad = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None, :]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _mixes(x: torch.Tensor, mu: torch.Tensor, prev) -> tuple:
    xp = _shift(x, prev)
    mu = mu.to(x.dtype)
    return tuple(x + (xp - x) * mu[i] for i in range(mu.shape[0]))


def rwkv6_time_in_plain(x, ln, mu, prev=None) -> tuple:
    """x (B, T, D), ln (D), mu (5, D), prev (B, D) or None -> (xr, xk, xv,
    xg, xw, carry): the five mixes of the normed x and its last row."""
    xn = rms_norm(x, ln)
    return (*_mixes(xn, mu, prev), xn[:, -1])


def rwkv6_decay_plain(w0, lora, dtype) -> torch.Tensor:
    """w0 (HD), lora (B, T, HD) -> the log-decay (B, T, HD) in ``dtype``."""
    return (-torch.exp(torch.clamp((w0 + lora).float(), -8.0, 6.0))) \
        .to(dtype)


def rwkv6_head_out_plain(out, ln_x, g_pre) -> torch.Tensor:
    """out (B, T, H, dh) from the recurrence, ln_x (H, dh), g_pre (B, T,
    H*dh) -> the gated (B, T, H*dh)."""
    b, s, h, dh = out.shape
    return rms_norm(out, ln_x).reshape(b, s, h * dh) * F.silu(g_pre)


def rwkv6_channel_in_plain(x, att, ln, mu, prev=None) -> tuple:
    """x, att (B, T, D), ln (D), mu (2, D), prev (B, D) or None -> (x +
    att, xk, xr, carry)."""
    x = x + att
    xn = rms_norm(x, ln)
    return (x, *_mixes(xn, mu, prev), xn[:, -1])


def rwkv6_relu2_plain(h) -> torch.Tensor:
    return torch.square(F.relu(h))


def rwkv6_channel_out_plain(x, r_pre, cv) -> torch.Tensor:
    """x + sigmoid(r_pre) * cv, all (B, T, D)."""
    return x + torch.sigmoid(r_pre) * cv


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _mix_in(name, x, add, ln, mu, prev):
    """The prologue kernel: -> (x + add or None, mixes (n, B, T, D),
    carry (B, D))."""
    if x.dim() != 3:
        fail(name, f"x {tuple(x.shape)} is not (B, T, D)")
    b, t, d = x.shape
    if ln.shape != (d,) or mu.dim() != 2 or mu.shape[1] != d \
            or (prev is not None and prev.shape != (b, d)) \
            or (add is not None and add.shape != x.shape):
        fail(name, f"shapes x {tuple(x.shape)}, ln {tuple(ln.shape)}, mu "
             f"{tuple(mu.shape)}, prev "
             f"{None if prev is None else tuple(prev.shape)}")
    max_d = MAX_THREADS * 16 // x.element_size()
    if min(b, t, d) < 1 or d > max_d or b > 65535:
        fail(name, f"takes 1 <= B <= 65535, T >= 1, 1 <= D <= {max_d}: "
             f"{(b, t, d)}")
    if mu.dtype != x.dtype:
        mu = mu.to(x.dtype)
    if prev is not None and prev.dtype == torch.bfloat16 \
            and x.dtype == torch.float32:
        # a bfloat16 cache (the config's dtype) carried into float32
        # weights' activations: the plain version promotes it, exactly
        prev = prev.float()
    ts = [x, ln, mu]
    for extra in (add, prev):
        if extra is not None:
            ts.append(extra)
    code = same_dtype(name, x.dtype, *ts)
    vectors(name, d, *ts)
    cuda_lib.check_operands(*ts)
    n = mu.shape[0]
    mixes = torch.empty((n, b, t, d), dtype=x.dtype, device=x.device)
    carry = torch.empty((b, d), dtype=x.dtype, device=x.device)
    x_out = None if add is None else torch.empty_like(x)
    rc = cuda_lib.library().hasco_rwkv6_mix_in(
        x.data_ptr(), None if add is None else add.data_ptr(), ln.data_ptr(),
        mu.data_ptr(), None if prev is None else prev.data_ptr(),
        None if x_out is None else x_out.data_ptr(), mixes.data_ptr(),
        carry.data_ptr(), b, t, d, n, code, stream())
    cuda_lib.check(rc, name)
    return x_out, mixes, carry


def rwkv6_time_in(x: torch.Tensor, ln: torch.Tensor, mu: torch.Tensor,
                  prev: torch.Tensor | None = None) -> tuple:
    """The time mix's prologue: (xr, xk, xv, xg, xw, carry) as
    :func:`rwkv6_time_in_plain`, in one launch."""
    _, mixes, carry = _mix_in("rwkv6_time_in", x, None, ln, mu, prev)
    rwkv6_time_in.launches += 1
    return (*mixes.unbind(0), carry)


def rwkv6_channel_in(x: torch.Tensor, att: torch.Tensor, ln: torch.Tensor,
                     mu: torch.Tensor, prev: torch.Tensor | None = None
                     ) -> tuple:
    """The channel mix's prologue: (x + att, xk, xr, carry) as
    :func:`rwkv6_channel_in_plain`, in one launch."""
    x_out, mixes, carry = _mix_in("rwkv6_channel_in", x, att, ln, mu, prev)
    rwkv6_channel_in.launches += 1
    return (x_out, *mixes.unbind(0), carry)


def rwkv6_decay(w0: torch.Tensor, lora: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """:func:`rwkv6_decay_plain` in one launch; ``dtype`` is lora's or
    float32."""
    name = "rwkv6_decay"
    hd = lora.shape[-1]
    if w0.shape != (hd,) or lora.numel() < 1:
        fail(name, f"w0 {tuple(w0.shape)}, lora {tuple(lora.shape)}")
    if dtype not in (lora.dtype, torch.float32):
        raise TypeError(f"{name} writes {lora.dtype} or float32, not {dtype}")
    code = same_dtype(name, lora.dtype, w0, lora)
    vectors(name, hd, w0, lora)
    cuda_lib.check_operands(w0, lora)
    out = torch.empty(lora.shape, dtype=dtype, device=lora.device)
    rc = cuda_lib.library().hasco_rwkv6_decay(
        w0.data_ptr(), lora.data_ptr(), out.data_ptr(), lora.numel(), hd,
        code, cuda_lib.dtype_code(dtype), stream())
    cuda_lib.check(rc, name)
    rwkv6_decay.launches += 1
    return out


def rwkv6_head_out(out: torch.Tensor, ln_x: torch.Tensor,
                   g_pre: torch.Tensor) -> torch.Tensor:
    """:func:`rwkv6_head_out_plain` in one launch."""
    name = "rwkv6_head_out"
    if out.dim() != 4:
        fail(name, f"out {tuple(out.shape)} is not (B, T, H, dh)")
    b, t, h, dh = out.shape
    if ln_x.shape != (h, dh) or g_pre.shape != (b, t, h * dh) \
            or min(b, t, h, dh) < 1:
        fail(name, f"shapes out {tuple(out.shape)}, ln_x "
             f"{tuple(ln_x.shape)}, g_pre {tuple(g_pre.shape)}")
    code = same_dtype(name, out.dtype, out, ln_x, g_pre)
    vectors(name, dh, out, ln_x, g_pre)
    lanes = dh * out.element_size() // 16
    if lanes > 32 or lanes & (lanes - 1):
        fail(name, f"puts a head on a power of two of lanes up to 32, one "
             f"16-byte vector each: dh {dh} takes {lanes}")
    cuda_lib.check_operands(out, ln_x, g_pre)
    y = torch.empty(g_pre.shape, dtype=out.dtype, device=out.device)
    rc = cuda_lib.library().hasco_rwkv6_head_out(
        out.data_ptr(), ln_x.data_ptr(), g_pre.data_ptr(), y.data_ptr(),
        b * t * h, h, dh, code, stream())
    cuda_lib.check(rc, name)
    rwkv6_head_out.launches += 1
    return y


def rwkv6_relu2(h: torch.Tensor) -> torch.Tensor:
    """:func:`rwkv6_relu2_plain` in one launch."""
    name = "rwkv6_relu2"
    if h.dim() < 1 or h.numel() < 1:
        fail(name, f"h {tuple(h.shape)} holds no rows")
    code = cuda_lib.dtype_code(h.dtype)
    vectors(name, h.shape[-1], h)
    cuda_lib.check_operands(h)
    out = torch.empty_like(h)
    rc = cuda_lib.library().hasco_rwkv6_relu2(
        h.data_ptr(), out.data_ptr(), h.numel(), code, stream())
    cuda_lib.check(rc, name)
    rwkv6_relu2.launches += 1
    return out


def rwkv6_channel_out(x: torch.Tensor, r_pre: torch.Tensor,
                      cv: torch.Tensor) -> torch.Tensor:
    """:func:`rwkv6_channel_out_plain` in one launch."""
    name = "rwkv6_channel_out"
    if r_pre.shape != x.shape or cv.shape != x.shape or x.dim() < 1 \
            or x.numel() < 1:
        fail(name, f"shapes x {tuple(x.shape)}, r_pre "
             f"{tuple(r_pre.shape)}, cv {tuple(cv.shape)}")
    code = same_dtype(name, x.dtype, x, r_pre, cv)
    vectors(name, x.shape[-1], x, r_pre, cv)
    cuda_lib.check_operands(x, r_pre, cv)
    out = torch.empty_like(x)
    rc = cuda_lib.library().hasco_rwkv6_channel_out(
        x.data_ptr(), r_pre.data_ptr(), cv.data_ptr(), out.data_ptr(),
        x.numel(), code, stream())
    cuda_lib.check(rc, name)
    rwkv6_channel_out.launches += 1
    return out


GLUE = (rwkv6_time_in, rwkv6_decay, rwkv6_head_out, rwkv6_channel_in,
        rwkv6_relu2, rwkv6_channel_out)
for _k in GLUE:
    _k.launches = 0
