"""AdamW in PyTorch with float32 moments over (possibly bfloat16) params,
global-norm clipping and a warmup + cosine schedule.

Port of ``repro/optim/adamw.py`` with its order of operations (so the
updated params match the reference's to float32 rounding): ``b1 ** step``,
the learning rate and the clip scale are float32 tensors, as ``jnp``
computes them.  ``update`` works in place, the counterpart of the
reference's donated buffers: the params and moments are overwritten and
returned.  It walks each leaf in flat slices of ``SLICE`` elements, so its
float32 temporaries stay small whatever the leaf (a layer-stacked leaf of a
full-width model holds gigabytes); the arithmetic is elementwise, so the
result is the same as over the whole leaf.

Sharded optimizer state (``init_specs``, the reference's ZeRO layout) is
not ported yet (ROADMAP A.8).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.models.layers import deferred
from repro_torch.models.tree import leaves, tree_map

Params = Any

# elements of one slice of a leaf in ``update`` and ``global_norm``: float32
# temporaries of 64 MB each
SLICE = 1 << 24


@dataclass
class OptState:
    step: torch.Tensor      # int32, 0-d
    m: Params
    v: Params


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak_lr * torch.clamp(step / max(1, warmup), max=1.0)
        frac = torch.clamp((step - warmup) / max(1, total - warmup), 0.0,
                           1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


def _slices(*ts: torch.Tensor):
    """Matching flat slices of same-shaped tensors, as views (a slice
    written in place writes the tensor)."""
    flat = [t.view(-1) for t in ts]
    n = flat[0].numel()
    for i in range(0, n, SLICE):
        yield tuple(f[i:i + SLICE] for f in flat)


@torch.no_grad()
def global_norm(tree: Params) -> torch.Tensor:
    total = None
    for x in leaves(tree):
        for (c,) in _slices(x.contiguous()):
            s = torch.sum(torch.square(c.float()))
            total = s if total is None else total + s
    return torch.sqrt(total)


class AdamW:
    def __init__(self, lr: float | Callable = 3e-4, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
        self.lr = lr if callable(lr) else (
            lambda step: torch.tensor(lr, dtype=torch.float32,
                                      device=step.device))
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm

    def init(self, params: Params) -> OptState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        dev = next(iter(leaves(params))).device
        return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                        tree_map(zeros, params), tree_map(zeros, params))

    init_specs = staticmethod(deferred(
        "A.8", "optimizer-state sharding specs for a device mesh"))

    @torch.no_grad()
    def update(self, grads: Params, state: OptState, params: Params
               ) -> tuple[Params, OptState, torch.Tensor]:
        """One AdamW step over ``params`` (and ``state``'s moments), in
        place; returns (params, the new state, the grads' global norm
        before clipping)."""
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0) \
            if self.clip_norm > 0 else torch.ones((), device=gnorm.device)
        step = state.step + 1
        lr = self.lr(step)
        b1, b2 = self.b1, self.b2
        c1 = 1.0 - torch.pow(b1, step.to(torch.float32))
        c2 = 1.0 - torch.pow(b2, step.to(torch.float32))

        def upd(p, g, m, v):
            g = g.float() * scale
            m2 = b1 * m + (1 - b1) * g
            v2 = b2 * v + (1 - b2) * g * g
            update = (m2 / c1) / (torch.sqrt(v2 / c2) + self.eps)
            update = update + self.weight_decay * p.float()
            p.copy_(p.float() - lr * update)      # cast to p's dtype
            m.copy_(m2)
            v.copy_(v2)

        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state.m), leaves(state.v)):
            if not p.is_contiguous():
                raise ValueError("AdamW.update updates params in place "
                                 "and needs contiguous leaves")
            for sl in _slices(p, g.contiguous(), m, v):
                upd(*sl)
        return params, OptState(step, state.m, state.v), gnorm
