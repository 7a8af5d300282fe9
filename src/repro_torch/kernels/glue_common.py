"""What the fused glue ops (``rwkv6_glue``, ``mamba2_glue``) share: the
plain RMS norm their plain versions compute, the wrappers' checks of their
operands, and the rule their norm kernels are held to."""
from __future__ import annotations

import torch

from . import cuda_lib


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``models/layers.py::rms_norm`` (no ``plus_one``), which the other
    families keep."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * w.float()).to(x.dtype)


def fail(name: str, msg: str):
    raise ValueError(f"{name}: {msg}")


def same_dtype(name: str, dtype, *ts) -> int:
    for t in ts:
        if t.dtype != dtype:
            raise TypeError(f"{name} takes its operands in one dtype, got "
                            f"{[str(x.dtype) for x in ts]} and {dtype}")
    return cuda_lib.dtype_code(dtype)


def vectors(name: str, row: int, *ts) -> None:
    """The kernels move 16-byte vectors only: each operand's rows (``row``
    values) must be whole vectors, at 16-byte-aligned addresses."""
    vec = 16 // ts[0].element_size()
    if row % vec or any(t.data_ptr() % 16 for t in ts):
        fail(name, f"takes rows of a multiple of {vec} values at 16-byte "
             f"aligned addresses, got rows of {row} at "
             f"{[t.data_ptr() % 16 for t in ts]} bytes past 16")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def one_inv_a_row(got, pre, w, eps, groups=1, ulps=16) -> bool:
    """Whether each (row, group) of a norm kernel's output ``got`` is
    bf16((pre * inv) * w) for one float32 inv within ``ulps`` of the plain
    norm's, ``pre`` the plain version's values before the norm: then the
    kernel's elementwise part gives the plain bits and its norm differs by
    its sum's order only."""
    f = pre.float().reshape(-1, groups, pre.shape[-1] // groups)
    got = got.reshape(f.shape)
    wf = w.float().reshape(groups, -1)
    inv = torch.rsqrt(torch.mean(f * f, dim=-1, keepdim=True) + eps)
    ok = torch.zeros(f.shape[:2], dtype=torch.bool, device=f.device)
    for toward in (0.0, float("inf")):
        c = inv
        for _ in range(ulps + 1):
            ok |= (((f * c) * wf).to(got.dtype) == got).all(-1)
            if bool(ok.all()):
                return True
            c = torch.nextafter(c, torch.full_like(c, toward))
    return False
