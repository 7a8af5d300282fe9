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

On a mesh (:meth:`AdamW.shard`) the optimizer takes one of two layouts.
ZeRO-1: the params are each rank's compute view (``distributed.local``;
replicated over 'data'), the moments this view's slice over 'data' along
the dim the param's spec shards over 'data' (``init_specs``: the moments
keep the params' full specs, the params take ``zero1_specs``); each rank
updates its slice of every param and the slices are all-gathered over
'data'.  FSDP (``fsdp=True``, the reference's training layout): the params
are each rank's shard by the full specs, the moments the same shard, and
the update is local.  The grads' global norm sums each leaf's squares over
the ranks that split it ('model', and under FSDP 'data'), once where the
leaf is replicated.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.distributed import local
from repro_torch.distributed.sharding import P, mesh_dims_of, prune_specs
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


class _Leaf:
    """How one param leaf lies on the mesh: the dim of its compute view
    that ZeRO-1 slices over 'data' for this rank's moments (``dim``;
    None: the moments are whole), whether FSDP cuts it over 'data'
    (``fsdp_split``), and which of its elements are split over 'model'
    (for the global norm): ``split`` True/False, or ``seg``, the (length,
    split) segments of one dim."""

    def __init__(self, spec, seg, mesh, fsdp: bool):
        names = tuple(mesh.mesh_dim_names)
        self.data = local.mesh_axis(mesh, "data")
        self.model = local.mesh_axis(mesh, "model")
        dims = mesh_dims_of(prune_specs(spec, ("data",)), names)
        self.dim = None if fsdp else next(
            (d for d, m in enumerate(dims) if m), None)
        self.fsdp_split = fsdp and local.fsdp_dim(spec, mesh) is not None
        self.seg = seg if self.model is not None else None
        self.split = self.model is not None and any(
            mesh_dims_of(prune_specs(spec, ("model",)), names))

    def slice(self, t: torch.Tensor):
        """(dim, start, length) of this rank's ZeRO-1 slice of the
        compute-view leaf ``t``; None where the moments are the param's
        shape (whole, or FSDP)."""
        if self.dim is None or self.data is None:
            return None
        self.length = t.shape[self.dim]
        start, n = local.chunk(self.length, self.data.size, self.data.rank)
        return self.dim, start, n

    def gather(self, mine: torch.Tensor) -> torch.Tensor:
        """The compute-view leaf from each rank's slice ``mine``."""
        if self.dim is None or self.data is None:
            return mine
        sizes = [local.chunk(self.length, self.data.size, i)[1]
                 for i in range(self.data.size)]
        return local.all_gather(mine, self.data.group, self.dim, sizes)

    def sq_parts(self, g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(sum of squares over the 'model'-split elements, over the
        replicated ones)."""
        sq = lambda x: torch.sum(torch.square(x.float()))
        zero = torch.zeros((), device=g.device)
        if self.seg is None:
            return (sq(g), zero) if self.split else (zero, sq(g))
        dim, segs = self.seg
        split, rep, at = zero, zero, 0
        for length, is_split in segs:
            n = length // self.model.size if is_split else length
            part = sq(g.narrow(dim % g.dim(), at, n))
            split, rep = (split + part, rep) if is_split else (split,
                                                              rep + part)
            at += n
        return split, rep


class AdamW:
    def __init__(self, lr: float | Callable = 3e-4, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
        # a constant rate is a fill on the step's device: no upload
        self.lr = lr if callable(lr) else (
            lambda step: torch.full_like(step, lr, dtype=torch.float32))
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.mesh = None
        self.specs = None
        self.fsdp = False
        self._leaves: dict[tuple, _Leaf] = {}

    def shard(self, mesh, param_specs, segments: dict | None = None,
              fsdp: bool = False) -> "AdamW":
        """Make this optimizer ZeRO-1 on ``mesh`` (or with ``fsdp`` FSDP:
        the params each rank's shard by the specs) for params laid out by
        ``param_specs`` (the family's full specs; ``segments`` its
        ``compute_segments``).  Returns self."""
        segments = segments or {}
        self.mesh, self.specs, self.fsdp = mesh, param_specs, fsdp
        self._leaves = {}

        def note(_spec, spec, path):
            key = tuple(k for k in path if isinstance(k, str))
            self._leaves[path] = _Leaf(spec, segments.get(key), mesh, fsdp)
            return spec
        local.zip_specs(note, param_specs, param_specs)
        return self

    def _lays(self, tree) -> list[_Leaf]:
        """The :class:`_Leaf` of each leaf of a params-shaped ``tree``, in
        ``leaves(tree)`` order."""
        out = []
        local.zip_specs(lambda t, s, path: out.append(self._leaves[path]),
                        tree, self.specs)
        return out

    def init(self, params: Params) -> OptState:
        """Zero moments: on a mesh, this rank's slice of each."""
        def zeros(p, lay=None):
            sl = None if lay is None else lay.slice(p)
            shape = list(p.shape)
            if sl is not None:
                shape[sl[0]] = sl[2]
            return torch.zeros(shape, dtype=torch.float32, device=p.device)
        dev = next(iter(leaves(params))).device
        if self.specs is None:
            m, v = tree_map(zeros, params), tree_map(zeros, params)
        else:
            lays = iter(self._lays(params))
            m = tree_map(lambda p: zeros(p, next(lays)), params)
            lays = iter(self._lays(params))
            v = tree_map(lambda p: zeros(p, next(lays)), params)
        return OptState(torch.zeros((), dtype=torch.int32, device=dev), m, v)

    def scatter_moments(self, tree: Params) -> Params:
        """This rank's ZeRO-1 slices of a compute-view moment tree."""
        lays = iter(self._lays(tree))

        def mine(t):
            sl = next(lays).slice(t)
            return t if sl is None else t.narrow(*sl).contiguous()
        return tree_map(mine, tree)

    def gather_moments(self, tree: Params) -> Params:
        """The compute-view moment tree from each rank's slices (after
        :meth:`init` or :meth:`scatter_moments` on this layout)."""
        lays = iter(self._lays(tree))
        return tree_map(lambda t: next(lays).gather(t), tree)

    @staticmethod
    def init_specs(param_specs: Params) -> OptState:
        """Specs of :meth:`init`'s state: the moments keep the params'
        full (FSDP) specs, which is ZeRO-1 where the params take
        ``zero1_specs``."""
        return OptState(P(), param_specs, param_specs)

    def _global_norm(self, grads: Params) -> torch.Tensor:
        if self.specs is None:
            return global_norm(grads)
        # sums of squares: [over 'model', replicated] of the leaves whole
        # over 'data', then of those FSDP cuts over 'data'
        sums = [None, None, None, None]
        for g, lay in zip(leaves(grads), self._lays(grads)):
            at = 2 if lay.fsdp_split else 0
            for i, x in enumerate(lay.sq_parts(g)):
                sums[at + i] = x if sums[at + i] is None else sums[at + i] + x
        split, rep = sums[:2]
        if sums[2] is not None:
            cut = local.all_reduce(torch.stack(sums[2:]),
                                   local.mesh_axis(self.mesh, "data").group)
            split = cut[0] if split is None else split + cut[0]
            rep = cut[1] if rep is None else rep + cut[1]
        model = local.mesh_axis(self.mesh, "model")
        if model is not None:
            split = local.all_reduce(split, model.group)
        return torch.sqrt(split + rep)

    @torch.no_grad()
    def update(self, grads: Params, state: OptState, params: Params
               ) -> tuple[Params, OptState, torch.Tensor]:
        """One AdamW step over ``params`` (and ``state``'s moments), in
        place; returns (params, the new state, the grads' global norm
        before clipping)."""
        gnorm = self._global_norm(grads)
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

        lays = (self._lays(params) if self.specs is not None
                else [None] * len(list(leaves(params))))
        for p, g, m, v, lay in zip(leaves(params), leaves(grads),
                                   leaves(state.m), leaves(state.v), lays):
            if not p.is_contiguous():
                raise ValueError("AdamW.update updates params in place "
                                 "and needs contiguous leaves")
            sl = None if lay is None else lay.slice(p)
            if sl is None:
                for part in _slices(p, g.contiguous(), m, v):
                    upd(*part)
                continue
            # ZeRO-1: update this rank's slice, then gather the slices
            dim, start, n = sl
            mine = p.narrow(dim, start, n).contiguous()
            for part in _slices(mine, g.narrow(dim, start, n).contiguous(),
                                m, v):
                upd(*part)
            p.copy_(lay.gather(mine))
        return params, OptState(step, state.m, state.v), gnorm
