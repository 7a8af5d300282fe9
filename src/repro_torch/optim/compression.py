"""Gradient compression with error feedback, in PyTorch.

Port of ``repro/optim/compression.py``: ``ef_compress`` is int8
block-quantization with a float32 error-feedback accumulator.  Quantize-
dequantize happens before the update; the residual is carried to the next
step, so the scheme is unbiased in the long run (classic EF-SGD).
``torch.round`` rounds half to even, as ``jnp.round`` does, so the int8
codes are the reference's on the same float32 input.
"""
from __future__ import annotations

import torch

from repro_torch.models.tree import tree_map


def _quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def ef_compress(grads, ef_state):
    """Error-feedback int8 compression.

    grads/ef_state: matching trees (ef_state float32, zeros at step 0).
    Returns (compressed_grads, new_ef_state).
    """
    def one(g, e):
        gf = g.float() + e
        q, scale = _quantize_int8(gf)
        deq = q.float() * scale
        return deq.to(g.dtype), gf - deq

    pairs = tree_map(one, grads, ef_state)
    return (tree_map(lambda pr: pr[0], pairs),
            tree_map(lambda pr: pr[1], pairs))


def ef_init(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
