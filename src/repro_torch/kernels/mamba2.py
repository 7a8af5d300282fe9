"""Mamba-2 SSD kernel wrapper: ``csrc/mamba2.cu`` for CUDA tensors.

Replaces the Pallas TPU kernel ``repro/kernels/mamba2.py::mamba2``: the
chunked SSD recurrence (chunks of 64 tokens, the log-decay's cumsum
restarting at every chunk) with the state carried in float32.  Unlike the
Pallas kernel, which asserts ``T % 64 == 0``, it takes any T >= 1.  The
kernel reads x, a, b and c in place through their batch, time and head
strides.  b and c come in G groups, (B, T, G, N) with G dividing H, head h
reading group h // (H / G) (zamba2-7b: two groups of 56 heads); (B, T, H,
N) is each head's own, or one group where b and c are ``expand`` views
with a head stride of 0 (zamba2-2.7b), never materialised per head.  It
runs three passes over spans of chunks (:func:`plan`): the spans' local
states in parallel, a short pass that carries the state across the spans,
and the outputs in parallel; where a group holds several heads, the first
pass also writes each chunk's Gram once a group, which the outputs pass
reads for each of the group's heads.  In bfloat16 the state's products
run on the tensor cores, the rest on float32 FMA.  It writes a fresh
output in x's dtype and a fresh float32 final state.  What bounds it on
the H100 and what the design does about it is noted in the CUDA source.
Its plain version is ``xla_linear.mamba2``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch import obs

from . import cuda_lib
from .xla_linear import mamba2 as mamba2_plain

MAX_N = 128
CHUNK = 64              # tokens a chunk: the reference's cumsum restarts here
SPAN_CHUNKS = 4         # chunks a span at most: 256 tokens
COLUMNS = {"tc": 64, "simt": 32}   # state columns a CTA owns, per route


class Mamba2Plan(NamedTuple):
    route: str          # "tc" (bfloat16, tensor cores) or "simt" (float32)
    span_chunks: int    # chunks a span
    spans: int          # spans over T: the states passed between them
    heads_per_cta: int  # heads of a pass-3 CTA (of one group, bfloat16)
    ctas: int           # CTAs of pass 3 (pass 1: one a head)
    state_bytes: int    # the span states, float32
    gram_bytes: int     # the chunks' Grams, float32, where b/c are shared


def plan(b: int, t: int, h: int, p: int, n: int, bf16: bool, shared: bool,
         n_sm: int, groups: int = 1) -> Mamba2Plan:
    """The kernel's geometry for x (b, t, h, p), b/c in ``groups`` groups,
    on a card of ``n_sm`` SMs.  Spans of ``SPAN_CHUNKS`` chunks keep the
    span states in L2 at long T (21 MB at zamba2-2.7b's 4096 tokens, 29 MB
    at zamba2-7b's 112 heads); a shorter T halves the span while the
    outputs pass would leave SMs idle, or one span would hold every chunk
    of T.  Where a group's b and c are shared by several heads
    (``shared``), pass 1 computes each chunk's Gram once a group into a
    buffer that pass 3 reads, and a bfloat16 pass-3 CTA owns two heads
    where two consecutive heads always share a group (one group, or an
    even number of heads a group)."""
    route = "tc" if bf16 else "simt"
    pair = groups == 1 or (h // groups) % 2 == 0
    heads = 2 if (shared and bf16 and h > 1 and pair) else 1
    p_blocks = -(-p // COLUMNS[route])
    chunks = -(-t // CHUNK)
    k = SPAN_CHUNKS
    while k > 1 and (k >= chunks or
                     -(-chunks // k) * -(-h // heads) * p_blocks * b < n_sm):
        k //= 2
    spans = -(-chunks // k)
    return Mamba2Plan(route, k, spans, heads,
                      spans * -(-h // heads) * p_blocks * b,
                      spans * b * h * n * p * 4,
                      b * groups * chunks * CHUNK * CHUNK * 4 if shared
                      else 0)


def _check_shapes(x, a, b, c, state) -> None:
    if x.dim() != 4 or a.shape != x.shape[:3] or b.dim() != 4 \
            or b.shape != c.shape or b.shape[:2] != x.shape[:2] \
            or b.shape[2] < 1 or x.shape[2] % b.shape[2]:
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
    """x: (B, T, H, P); a: (B, T, H) log-decay (<= 0); b/c: (B, T, G, N)
    with G dividing H (head h reads group h // (H / G)), or (B, T, H, N)
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
    # heads a group: (B, T, H, N) stride-0 views are one group
    g = b.shape[2]
    hpg = h // g if g != h else \
        (h if b.stride(2) == 0 and c.stride(2) == 0 else 1)
    pl = plan(bs, t, h, p, n, x.dtype == torch.bfloat16, hpg > 1,
              cuda_lib.sm_count(x.device.index), h // hpg)
    h0 = None if state is None else state.to(torch.float32).contiguous()
    y = torch.empty((bs, t, h, p), dtype=x.dtype, device=x.device)
    h_t = torch.empty((bs, h, n, p), dtype=torch.float32, device=x.device)
    spans = torch.empty((bs, h, pl.spans, n, p), dtype=torch.float32,
                        device=x.device)
    decays = torch.empty((bs, h, pl.spans), dtype=torch.float32,
                         device=x.device)
    gram = (torch.empty((pl.gram_bytes // 4,), dtype=torch.float32,
                        device=x.device) if pl.gram_bytes else None)
    strides = (ctypes.c_longlong * 15)(
        *(s for z in (x, a, b, c, y) for s in z.stride()[:3]))
    args = (x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_t.data_ptr(), spans.data_ptr(), decays.data_ptr(),
            None if gram is None else gram.data_ptr(), bs, t, h, p, n, hpg,
            strides, pl.span_chunks, pl.heads_per_cta,
            cuda_lib.dtype_code(x.dtype),
            torch.cuda.current_stream().cuda_stream)
    launch = cuda_lib.library().hasco_mamba2
    obs.device_start()      # an open span times the launch, not the above
    rc = launch(*args)
    cuda_lib.check(rc, "mamba2")
    mamba2.launches += 1
    return y, h_t


mamba2.launches = 0
