"""Flash attention kernel wrapper: ``csrc/flash_attention.cu`` for CUDA
tensors.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention`` (forward): GQA, a causal mask aligned to the bottom
right, the gemma2 tanh soft-cap and a sliding window, with an online softmax
in float32 over key tiles.  The kernel reads q, k and v in place through
their strides and writes a fresh (B, Sq, H, D) tensor in q's dtype.  Its
tiles are fixed at 64 queries by 64 keys.  Each call takes one of two
kernels by a written rule (:func:`route`): the bfloat16 tensor-core kernel
(``"tc"``) or the float32 SIMT kernel (``"simt"``); no call falls back from
one to the other.  What bounds them on the H100 and what each design does
about it is noted in the CUDA source.

A row that sees no key (only when Sq > Skv) comes out as zeros, as in the
plain version ``xla_attention.attention``; the Pallas kernel and
``ref.attention_ref`` give other values there.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import obs

from . import cuda_lib
from .xla_attention import attention as flash_attention_plain

MAX_HEAD_DIM = 256
ROUTES = ("tc", "simt")


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Which kernel a CUDA call takes: ``"tc"`` (bfloat16 on the tensor
    cores) when the dtype is bfloat16, D % 16 == 0 and D <= 256, and every
    operand has a contiguous head dim, batch, sequence and head strides
    that are multiples of 8 elements and a 16-byte-aligned data pointer
    (so every row loads in 16-byte copies); ``"simt"`` otherwise, float32
    above all.  Reads only dtypes, shapes, strides and pointers."""
    d = q.shape[-1]
    if q.dtype != torch.bfloat16 or d % 16 or d > MAX_HEAD_DIM:
        return "simt"
    for t in (q, k, v):
        if (t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            return "simt"
    return "tc"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, softcap: float = 0.0,
                    window: int = 0, scale: float | None = None
                    ) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D) with H % Hkv == 0, float32
    or bfloat16, head dim contiguous.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel :func:`route` picks, or
    raises."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"attention shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv < 1 or h % hkv:
        raise ValueError(f"attention q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)} (batch, head dim, H % Hkv)")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"attention dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    kw = dict(causal=causal, softcap=softcap, window=window, scale=scale)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_plain(q, k, v, **kw)
    cuda_lib.check_operands(q, k, v, contiguous=False)
    if min(b, sq, skv, d) < 1 or d > MAX_HEAD_DIM:
        raise ValueError(f"attention kernel takes 1 <= D <= {MAX_HEAD_DIM} "
                         f"and no empty dims: {(b, sq, skv, h, d)}")
    if max(b, h) > 65535:
        raise ValueError(f"attention grid too large: B={b}, H={h}")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    sc = float(scale if scale is not None else d ** -0.5)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            skv, h, hkv, d, strides, int(bool(causal)), int(window),
            float(softcap), sc)
    stream = torch.cuda.current_stream().cuda_stream
    lib = cuda_lib.library()
    which = route(q, k, v)
    obs.device_start()      # an open span times the launch, not the above
    if which == "tc":
        rc = lib.hasco_flash_attention_tc(*args, stream)
    else:
        rc = lib.hasco_flash_attention(*args, cuda_lib.dtype_code(q.dtype),
                                       stream)
    cuda_lib.check(rc, f"flash_attention ({which})")
    flash_attention.launches += 1
    flash_attention.route_launches[which] += 1
    return out


flash_attention.launches = 0            # every launch, both routes
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
