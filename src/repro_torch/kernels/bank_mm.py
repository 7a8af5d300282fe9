"""The DQN bank's product: ``csrc/bank_mm.cu`` for CUDA tensors.

Replaces no TPU kernel: it is the one product of the port's lock-step DQN
bank (``repro_torch.core.qlearning``), whose every forward, weight and
input gradient, bias gradient and loss sum it computes.  Its one contract
is that a slot's result does not depend on how many slots share the call
(the reason for the kernel is in the CUDA source).  A CPU tensor takes the
plain version, whose CPU products keep that contract too
(``tests/test_torch_qlearning.py``).
"""
from __future__ import annotations

import torch

from . import cuda_lib


def bank_mm_plain(a: torch.Tensor, b: torch.Tensor,
                  bias: torch.Tensor | None = None,
                  relu: bool = False) -> torch.Tensor:
    """act(a @ b + bias[:, None]) per slot: a (N, M, K), b (N, K, P), bias
    (N, P) or None; (N, M, P)."""
    out = (torch.bmm(a, b) if bias is None
           else torch.baddbmm(bias[:, None], a, b))
    return torch.relu(out) if relu else out


def bank_mm(a: torch.Tensor, b: torch.Tensor,
            bias: torch.Tensor | None = None,
            relu: bool = False) -> torch.Tensor:
    """act(a @ b + bias[:, None]) per slot in float32: a (N, M, K) and b
    (N, K, P) in any strides, bias (N, P) or None; returns a contiguous
    (N, M, P).  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"bank_mm shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    n, m, k = a.shape
    p = b.shape[2]
    if bias is not None and bias.shape != (n, p):
        raise ValueError(f"bank_mm bias {tuple(bias.shape)}, not {(n, p)}")
    ts = (a, b) if bias is None else (a, b, bias)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"bank_mm takes float32, not "
                        f"{[str(t.dtype) for t in ts]}")
    if all(t.device.type == "cpu" for t in ts):
        return bank_mm_plain(a, b, bias, relu)
    if any(t.device.type != "cuda" or t.device != a.device for t in ts):
        raise ValueError(f"bank_mm operands must all be CUDA tensors on one "
                         f"card, got {[str(t.device) for t in ts]}")
    if bias is not None and not bias.is_contiguous():
        raise ValueError("bank_mm bias must be contiguous")
    out = torch.empty((n, m, p), dtype=torch.float32, device=a.device)
    if min(n, m, p) == 0:                 # nothing to compute
        return out
    if k < 1:
        raise ValueError(f"bank_mm kernel takes no empty sum: {(n, m, k, p)}")
    rc = cuda_lib.library().hasco_bank_mm(
        a.data_ptr(), b.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), n, m, p, k, *a.stride(), *b.stride(), int(relu),
        torch.cuda.current_stream(a.device).cuda_stream)
    cuda_lib.check(rc, "bank_mm")
    bank_mm.launches += 1
    return out


bank_mm.launches = 0
