"""RWKV-6 WKV kernel wrapper: ``csrc/rwkv6.cu`` for CUDA tensors.

Replaces the Pallas TPU kernel ``repro/kernels/rwkv6.py::rwkv6``: the
chunked recurrence (chunks of 16 tokens, the log-decay's cumsum restarting
at every chunk) with the state carried in float32.  Unlike the Pallas
kernel, which asserts ``T % 16 == 0``, it takes any T >= 1.  The kernel
reads r, k, v and w in place through their batch, time and head strides.
It runs three passes over spans of chunks (:func:`plan`): the spans' local
states and per-channel decays in parallel, a short pass that carries the
state across the spans, and the outputs in parallel.  In bfloat16 the
state's products run on the tensor cores, the rest on float32 FMA.  It
writes a fresh output in v's dtype and a fresh float32 final state.  What
bounds it on the H100 and what the design does about it is noted in the
CUDA source.  Its plain version is ``xla_linear.rwkv6``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch import obs

from . import cuda_lib
from .xla_linear import rwkv6 as rwkv6_plain

MAX_DK = 128
CHUNK = 16              # tokens a chunk: the reference's cumsum restarts here
SPAN_CHUNKS = 16        # chunks a span at most: 256 tokens
COLUMNS = 64            # state columns (of v and out) a CTA owns
CTAS_PER_SM = 4         # CTAs a pass wants an SM: up to three are resident


class Rwkv6Plan(NamedTuple):
    route: str          # "tc" (bfloat16, tensor cores) or "simt" (float32)
    span_chunks: int    # chunks a span
    spans: int          # spans over T: the states passed between them
    col_blocks: int     # blocks of COLUMNS state columns over Dv
    ctas: int           # CTAs of passes 1 and 3
    state_bytes: int    # the span states, float32


def plan(b: int, t: int, h: int, dk: int, dv: int, bf16: bool,
         n_sm: int) -> Rwkv6Plan:
    """The kernel's geometry for r/k/w (b, t, h, dk), v (b, t, h, dv), on a
    card of ``n_sm`` SMs.  Spans of ``SPAN_CHUNKS`` chunks keep the span
    states at 10.5 MB at rwkv6-3b's 4096 tokens (640 CTAs a pass); a
    shorter T halves the span while the outputs pass would leave SMs idle
    (fewer than ``CTAS_PER_SM`` CTAs an SM: with two or three resident at
    a time, the last of too few leaves most SMs idle), or one span would
    hold every chunk of T."""
    col_blocks = -(-dv // COLUMNS)
    chunks = -(-t // CHUNK)
    k = SPAN_CHUNKS
    while k > 1 and (k >= chunks or -(-chunks // k) * h * col_blocks * b
                     < CTAS_PER_SM * n_sm):
        k //= 2
    spans = -(-chunks // k)
    return Rwkv6Plan("tc" if bf16 else "simt", k, spans, col_blocks,
                     spans * h * col_blocks * b, spans * b * h * dk * dv * 4)


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
    pl = plan(b, t, h, dk, dv, v.dtype == torch.bfloat16,
              cuda_lib.sm_count(v.device.index))
    u32 = u.to(torch.float32).contiguous()
    s0 = None if state is None else state.to(torch.float32).contiguous()
    out = torch.empty((b, t, h, dv), dtype=v.dtype, device=v.device)
    s_t = torch.empty((b, h, dk, dv), dtype=torch.float32, device=v.device)
    spans = torch.empty((b, h, pl.spans, dk, dv), dtype=torch.float32,
                        device=v.device)
    decays = torch.empty((b, h, pl.spans, dk), dtype=torch.float32,
                         device=v.device)
    strides = (ctypes.c_longlong * 15)(
        *(s for x in (r, k, v, w, out) for s in x.stride()[:3]))
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u32.data_ptr(), None if s0 is None else s0.data_ptr(),
            out.data_ptr(), s_t.data_ptr(), spans.data_ptr(),
            decays.data_ptr(), b, t, h, dk, dv, strides, pl.span_chunks,
            cuda_lib.dtype_code(v.dtype),
            torch.cuda.current_stream().cuda_stream)
    launch = cuda_lib.library().hasco_rwkv6
    obs.device_start()      # an open span times the launch, not the above
    rc = launch(*args)
    cuda_lib.check(rc, "rwkv6")
    rwkv6.launches += 1
    return out, s_t


rwkv6.launches = 0
