"""Mamba-2 SSD kernel wrapper: ``csrc/mamba2.cu`` for CUDA tensors.

Replaces the Pallas TPU kernel ``repro/kernels/mamba2.py::mamba2``: the
chunked SSD recurrence (chunks of 64 tokens, the log-decay's cumsum
restarting at every chunk) with the state carried in float32.  Unlike the
Pallas kernel, which asserts ``T % 64 == 0``, it takes any T >= 1.  The
kernel reads x, a, b and c in place through their batch, time and head
strides, so b and c may be ``expand`` views with a head stride of 0 (one
group shared by every head, as zamba2 has) and are never materialised per
head.  It writes a fresh output in x's dtype and a fresh float32 final
state.  What bounds it on the H100 and what the design does about it is
noted in the CUDA source.  Its plain version is ``xla_linear.mamba2``.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .xla_linear import mamba2 as mamba2_plain

MAX_N = 128


def _check_shapes(x, a, b, c, state) -> None:
    if x.dim() != 4 or a.shape != x.shape[:3] or b.dim() != 4 \
            or b.shape != c.shape or b.shape[:3] != x.shape[:3]:
        raise ValueError(f"mamba2 shapes x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}")
    bs, _, h, p = x.shape
    n = b.shape[-1]
    if state is not None and tuple(state.shape) != (bs, h, n, p):
        raise ValueError(f"mamba2 state {tuple(state.shape)} is not (B, H, "
                         f"N, P) = {(bs, h, n, p)}")
    if not x.dtype == a.dtype == b.dtype == c.dtype:
        raise TypeError(f"mamba2 dtypes differ: x {x.dtype}, a {a.dtype}, "
                        f"b {b.dtype}, c {c.dtype}")


def mamba2(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           c: torch.Tensor, state: torch.Tensor | None = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, H, P); a: (B, T, H) log-decay (<= 0); b/c: (B, T, H, N),
    possibly stride 0 over H; state: (B, H, N, P) or None (zeros).  x, a,
    b, c float32 or bfloat16, one dtype; x, b, c with a contiguous last
    dim.  Returns (y (B, T, H, P) in x's dtype, final state (B, H, N, P)
    float32).  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    _check_shapes(x, a, b, c, state)
    ts = (x, a, b, c) + (() if state is None else (state,))
    if all(t.device.type == "cpu" for t in ts):
        return mamba2_plain(x, a, b, c, state)
    # a is read through all three of its strides: only its device counts
    cuda_lib.check_operands(x, b, c, *ts[4:], a[..., None],
                            contiguous=False)
    bs, t, h, p = x.shape
    n = b.shape[-1]
    if min(bs, t, h, p, n) < 1 or n > MAX_N:
        raise ValueError(f"mamba2 kernel takes 1 <= N <= {MAX_N} and no "
                         f"empty dims: {(bs, t, h, p, n)}")
    if max(bs, h) > 65535:
        raise ValueError(f"mamba2 grid too large: B={bs}, H={h}")
    h0 = None if state is None else state.to(torch.float32).contiguous()
    y = torch.empty((bs, t, h, p), dtype=x.dtype, device=x.device)
    h_t = torch.empty((bs, h, n, p), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 15)(
        *(s for z in (x, a, b, c, y) for s in z.stride()[:3]))
    rc = cuda_lib.library().hasco_mamba2(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(), h_t.data_ptr(),
        bs, t, h, p, n, strides, cuda_lib.dtype_code(x.dtype),
        torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(rc, "mamba2")
    mamba2.launches += 1
    return y, h_t


mamba2.launches = 0
