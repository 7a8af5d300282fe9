"""RWKV-6 WKV kernel wrapper: ``csrc/rwkv6.cu`` for CUDA tensors.

Replaces the Pallas TPU kernel ``repro/kernels/rwkv6.py::rwkv6``: the
chunked recurrence (chunks of 16 tokens, the log-decay's cumsum restarting
at every chunk) with the state carried in float32.  Unlike the Pallas
kernel, which asserts ``T % 16 == 0``, it takes any T >= 1.  The kernel
reads r, k, v and w in place through their batch, time and head strides
and writes a fresh output in v's dtype and a fresh float32 final state.
What bounds it on the H100 and what the design does about it is noted in
the CUDA source.  Its plain version is ``xla_linear.rwkv6``.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .xla_linear import rwkv6 as rwkv6_plain

MAX_DK = 128


def _check_shapes(r, k, v, w, u, state) -> None:
    if r.dim() != 4 or r.shape != k.shape or r.shape != w.shape \
            or v.dim() != 4 or v.shape[:3] != r.shape[:3]:
        raise ValueError(f"rwkv6 shapes r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w "
                         f"{tuple(w.shape)}")
    b, _, h, dk = r.shape
    if tuple(u.shape) != (h, dk):
        raise ValueError(f"rwkv6 u {tuple(u.shape)} is not (H, Dk) = "
                         f"{(h, dk)}")
    if state is not None and tuple(state.shape) != (b, h, dk, v.shape[-1]):
        raise ValueError(f"rwkv6 state {tuple(state.shape)} is not (B, H, "
                         f"Dk, Dv) = {(b, h, dk, v.shape[-1])}")
    if not r.dtype == k.dtype == v.dtype == w.dtype:
        raise TypeError(f"rwkv6 dtypes differ: r {r.dtype}, k {k.dtype}, "
                        f"v {v.dtype}, w {w.dtype}")


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          w: torch.Tensor, u: torch.Tensor,
          state: torch.Tensor | None = None
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """r/k/w: (B, T, H, Dk), w the log-decay (<= 0); v: (B, T, H, Dv); u:
    (H, Dk); state: (B, H, Dk, Dv) or None (zeros).  r, k, v, w float32 or
    bfloat16, one dtype, last dim contiguous.  Returns (out (B, T, H, Dv)
    in v's dtype, final state (B, H, Dk, Dv) float32).  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    _check_shapes(r, k, v, w, u, state)
    ts = (r, k, v, w, u) + (() if state is None else (state,))
    if all(t.device.type == "cpu" for t in ts):
        return rwkv6_plain(r, k, v, w, u, state)
    cuda_lib.check_operands(*ts, contiguous=False)
    b, t, h, dk = r.shape
    dv = v.shape[-1]
    if min(b, t, h, dk, dv) < 1 or dk > MAX_DK:
        raise ValueError(f"rwkv6 kernel takes 1 <= Dk <= {MAX_DK} and no "
                         f"empty dims: {(b, t, h, dk, dv)}")
    if max(b, h) > 65535:
        raise ValueError(f"rwkv6 grid too large: B={b}, H={h}")
    u32 = u.to(torch.float32).contiguous()
    s0 = None if state is None else state.to(torch.float32).contiguous()
    out = torch.empty((b, t, h, dv), dtype=v.dtype, device=v.device)
    s_t = torch.empty((b, h, dk, dv), dtype=torch.float32, device=v.device)
    strides = (ctypes.c_longlong * 15)(
        *(s for x in (r, k, v, w, out) for s in x.stride()[:3]))
    rc = cuda_lib.library().hasco_rwkv6(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u32.data_ptr(), None if s0 is None else s0.data_ptr(),
        out.data_ptr(), s_t.data_ptr(), b, t, h, dk, dv, strides,
        cuda_lib.dtype_code(v.dtype), torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(rc, "rwkv6")
    rwkv6.launches += 1
    return out, s_t


rwkv6.launches = 0
