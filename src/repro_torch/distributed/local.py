"""The local (per-rank) view of sharded trees, and the collectives between
ranks.  The reference leaves all of this to GSPMD: its arrays are global
and the compiler partitions the compute.  The port's kernels are bound
through ``ctypes``, which DTensor cannot see through, so the port splits
the two:

* **Layout** (params, caches, optimizer state, checkpoints): each leaf is
  laid out by its spec (``sharding.named``), as a DTensor
  (:func:`distribute`) or as this rank's shard of it (:func:`local_shard`).
  A dim split over mesh axes ``(a, b)`` is cut into chunks over ``a``,
  each chunk into chunks over ``b`` (DTensor's rule: ``ceil(n / k)`` rows
  a chunk, the last ones shorter or empty).
* **Compute** runs on each rank's *compute view* (:func:`local_params`):
  every leaf is whole over every axis but 'model' (a leaf sharded over
  'data' is gathered before use), and over 'model' it is this rank's
  shard -- with one exception, below.  The model code adds the
  collectives over the ambient mesh's 'model' axis
  (``context.use_mesh``): column-parallel products (:func:`column_in`),
  row-parallel ones (:func:`row_out`), the vocab-parallel embedding and
  head, experts over 'model'.

**The rule for concatenated dims.**  A contiguous shard of a dim that
concatenates segments is not a head-aligned shard: zamba2's ``in_proj``
columns are ``[z | x | B | C | dt]`` (``hp, hp, n, n, h``) and its
``conv_w``/``conv_b`` run over ``[x | B | C]``.  A model names such dims
in ``compute_segments(cfg, tp)``: for each leaf, the dim and its segments
as ``(length, split)``.  The compute view of such a leaf takes, segment by
segment, this rank's ``1/T`` of a split segment (z, x and dt: whole heads)
and the whole of a replicated one (B and C: one group that every head
reads), concatenated in segment order.  Its layout stays the spec's
contiguous shard, so checkpoints and the spec trees are the reference's.

**Collectives under autograd** are the Megatron pairs, written as
``torch.autograd.Function`` s here: ``torch.distributed.nn.functional``'s
``all_reduce`` sums the incoming gradients over the ranks in its backward,
which is right where each rank owns a different loss and wrong here, where
every 'model' rank computes the same loss.  So a column-parallel input is
the identity forward and an all-reduce backward (:func:`copy_to_model`),
a row-parallel output an all-reduce forward and the identity backward
(:func:`row_out`), and so on.

Gloo has no reduce-scatter: the port's reduce-scatter is an all-reduce and
this rank's slice (the same values).  Two ranks cannot share one card
under NCCL, so two ranks on one card run gloo, which takes the CUDA
tensors of all three collectives used here (all-reduce, all-gather,
broadcast) as they are.
"""
from __future__ import annotations

import contextlib
import functools
import time
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from . import context
from .sharding import P, axis_names, mesh_dims_of

Params = Any


# ---------------------------------------------------------------------------
# Axes of the ambient mesh
# ---------------------------------------------------------------------------

class Axis(NamedTuple):
    """One mesh axis as this rank sees it: its process group, this rank's
    index along it and its size."""
    group: Any
    rank: int
    size: int


def mesh_axis(mesh, name: str) -> Axis | None:
    """``name`` of ``mesh`` as an :class:`Axis`; None where the mesh has no
    such axis or it has one rank."""
    if mesh is None or name not in axis_names(mesh):
        return None
    size = mesh.size(axis_names(mesh).index(name))
    if size == 1:
        return None
    return Axis(mesh.get_group(name), mesh.get_local_rank(name), size)


def tp_group() -> Axis | None:
    """The ambient mesh's 'model' axis (None: no tensor parallelism)."""
    return mesh_axis(context.current_mesh(), "model")


def tp_degree() -> int:
    ax = tp_group()
    return 1 if ax is None else ax.size


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

#: per collective: [calls, seconds of host wall time, the wait for the
#: slowest rank included], counted by :func:`_timed`
STATS: dict[str, list] = {}


def _timed(name: str):
    """Count the calls of collective ``name`` and their wall time in
    :data:`STATS` (a CUDA tensor's collective waits for the card first, so
    the time is the collective's own)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(x, *args, **kwargs):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            t0 = time.perf_counter()
            out = fn(x, *args, **kwargs)
            if out.is_cuda:
                torch.cuda.synchronize(out.device)
            entry = STATS.setdefault(name, [0, 0.0])
            entry[0] += 1
            entry[1] += time.perf_counter() - t0
            return out
        return run
    return wrap


@_timed("all_reduce")
def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group``, as a new tensor.  A bfloat16 or
    float16 ``x`` is summed in float32 and rounded once, as one product
    over the whole reduction dim would be."""
    low = x.dtype in (torch.bfloat16, torch.float16)
    y = x.detach().float() if low else x.detach().clone()
    y = y.contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


@_timed("all_gather")
def all_gather(x: torch.Tensor, group, dim: int,
               sizes: list[int] | None = None) -> torch.Tensor:
    """The ranks' ``x`` concatenated on ``dim`` in rank order.  ``sizes``
    (each rank's length on ``dim``) allows uneven shards: each is padded
    to the longest for the transfer and trimmed after."""
    n = dist.get_world_size(group)
    dim = dim % x.dim()
    longest = max(sizes) if sizes else x.shape[dim]
    src = x.detach()
    if src.shape[dim] < longest:
        pad = list(src.shape)
        pad[dim] = longest - src.shape[dim]
        src = torch.cat([src, src.new_zeros(pad)], dim=dim)
    src = src.contiguous()
    outs = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(outs, src, group=group)
    if sizes:
        outs = [o.narrow(dim, 0, s) for o, s in zip(outs, sizes)]
    return torch.cat(outs, dim=dim)


@_timed("broadcast")
def broadcast(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``x`` of global rank ``src`` on every rank of ``group``, in place."""
    dist.broadcast(x, src, group=group)
    return x


def _my_chunk(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    n = x.shape[dim] // ax.size
    return x.narrow(dim, ax.rank * n, n)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.ax.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return all_reduce(x, ax.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReducePartial(torch.autograd.Function):
    """Sum over 'model' of a tensor whose sum each rank reads only in
    part (a norm's sum of squares over a split dim): the backward sums the
    ranks' partial gradients too."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return all_reduce(x, ax.group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.ax.group), None


class _GatherFromModel(torch.autograd.Function):
    """All-gather on ``dim`` forward; this rank's slice backward (every
    rank holds the same gradient of the gathered tensor)."""

    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return all_gather(x, ax.group, dim)

    @staticmethod
    def backward(ctx, g):
        return _my_chunk(g, ctx.ax, ctx.dim).contiguous(), None, None


class _ReduceScatter(torch.autograd.Function):
    """Sum over 'model', keep this rank's slice of ``dim`` forward;
    all-gather backward (sequence parallelism's row-parallel output)."""

    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _my_chunk(all_reduce(x, ax.group), ax, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.ax.group, ctx.dim), None, None


class _GatherSeq(torch.autograd.Function):
    """All-gather on ``dim`` forward; reduce-scatter backward (sequence
    parallelism's column-parallel input: each rank's gradient is partial)."""

    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return all_gather(x, ax.group, dim)

    @staticmethod
    def backward(ctx, g):
        return _my_chunk(all_reduce(g, ctx.ax.group), ctx.ax,
                         ctx.dim).contiguous(), None, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    ax = tp_group()
    return x if ax is None else _CopyToModel.apply(x, ax)


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    ax = tp_group()
    return x if ax is None else _GatherFromModel.apply(x, ax, dim % x.dim())


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    ax = tp_group()
    return x if ax is None else _ReducePartial.apply(x, ax)


def seq_param(w: torch.Tensor) -> torch.Tensor:
    """A replicated weight applied to the residual stream: where the stream
    is sequence-sharded each rank sees its own tokens, so the weight's
    gradient is summed over 'model'."""
    ax = tp_group()
    return w if ax is None or not _SP["on"] else _CopyToModel.apply(w, ax)


def gather_partial(x: torch.Tensor, dim: int) -> torch.Tensor:
    """All-gather on ``dim`` of a tensor whose gathered whole each rank
    reads only in part (MoE router logits): the backward sums the ranks'
    partial gradients, then keeps this rank's slice."""
    ax = tp_group()
    return x if ax is None else _GatherSeq.apply(x, ax, dim % x.dim())


# -- the residual stream: replicated, or sequence-sharded over 'model' ----

_SP = {"on": False}


@contextlib.contextmanager
def residual_layout(seq_len: int):
    """For the body, lay the (B, S, D) residual stream out as the
    activation context says (``context.sequence_parallel``): sharded over
    'model' on the sequence, or replicated."""
    prev = _SP["on"]
    _SP["on"] = context.sequence_parallel(seq_len)
    try:
        yield
    finally:
        _SP["on"] = prev


def column_in(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel product: the whole sequence on every
    'model' rank (all-gathered where the stream is sequence-sharded)."""
    ax = tp_group()
    if ax is None:
        return x
    if _SP["on"]:
        return _GatherSeq.apply(x, ax, 1)
    return _CopyToModel.apply(x, ax)


def row_out(y: torch.Tensor) -> torch.Tensor:
    """The output of a row-parallel product, summed over 'model': the
    whole stream, or this rank's sequence slice of it."""
    ax = tp_group()
    if ax is None:
        return y
    if _SP["on"]:
        return _ReduceScatter.apply(y, ax, 1)
    return _ReduceFromModel.apply(y, ax)


# ---------------------------------------------------------------------------
# Layout: shards of a leaf by its spec
# ---------------------------------------------------------------------------

def chunk(n: int, parts: int, i: int) -> tuple[int, int]:
    """(start, length) of chunk ``i`` of ``n`` rows cut in ``parts``."""
    full = -(-n // parts)
    start = min(i * full, n)
    return start, max(0, min(n, start + full) - start)


def _coords(mesh) -> list[int]:
    return list(mesh.get_coordinate())


def shard_slices(shape, spec: P, mesh, coords=None) -> list[slice]:
    """The slice of each dim that the rank at mesh ``coords`` (default:
    this rank) holds of a leaf of ``shape`` laid out by ``spec``."""
    names = axis_names(mesh)
    coords = _coords(mesh) if coords is None else coords
    out = []
    for n, mdims in zip(shape, mesh_dims_of(spec, names)):
        start, length = 0, n
        for m in mdims:
            s, length = chunk(length, mesh.size(m), coords[m])
            start += s
        out.append(slice(start, start + length))
    return out + [slice(None)] * (len(shape) - len(out))


def local_shard(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t``, a contiguous copy."""
    return t[tuple(shard_slices(t.shape, spec, mesh))].contiguous()


def distribute(tree: Params, specs, mesh) -> Params:
    """Whole tensors -> DTensors laid out by ``specs`` on ``mesh`` (the
    ``jax.device_put(tree, named(specs, mesh))`` counterpart).  Every rank
    passes the same whole tensors (made from one seed, or restored) and
    keeps its shard; nothing is sent."""
    from torch.distributed.tensor import DTensor

    from .sharding import placements

    def one(t, spec, _path):
        return DTensor.from_local(local_shard(t, spec, mesh), mesh,
                                  placements(spec, mesh), run_check=False,
                                  shape=t.shape, stride=t.contiguous().stride())
    return zip_specs(one, tree, specs)


def zip_specs(fn, tree, specs, path=()):
    """``fn(leaf, spec, path)`` over a tree and its same-shaped spec tree;
    ``path`` is the tuple of keys (and indices) down to the leaf."""
    if isinstance(tree, dict):
        return {k: zip_specs(fn, v, specs[k], path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        return type(tree)(zip_specs(fn, v, s, path + (i,))
                          for i, (v, s) in enumerate(zip(tree, specs)))
    if hasattr(tree, "__dataclass_fields__"):
        return type(tree)(*(zip_specs(fn, getattr(tree, f),
                                       getattr(specs, f), path + (f,))
                            for f in tree.__dataclass_fields__))
    return fn(tree, specs, path)


def gather_full(local: torch.Tensor, shape, spec: P, mesh) -> torch.Tensor:
    """The whole tensor of ``shape`` from each rank's shard ``local`` laid
    out by ``spec`` (every rank gets it)."""
    names = axis_names(mesh)
    coords = _coords(mesh)
    x = local
    for dim, mdims in enumerate(mesh_dims_of(spec, names)):
        # lengths of the chunks at each nesting level, innermost gathered
        # first: the chunk this rank's outer coordinates select
        lengths = [shape[dim]]
        for m in mdims[:-1]:
            lengths.append(chunk(lengths[-1], mesh.size(m), coords[m])[1])
        for m, n in zip(reversed(mdims), reversed(lengths)):
            if mesh.size(m) == 1:       # the whole already: nothing to send
                continue
            sizes = [chunk(n, mesh.size(m), i)[1] for i in range(mesh.size(m))]
            x = all_gather(x, mesh.get_group(names[m]), dim, sizes)
    return x


def full_tensor(leaf) -> torch.Tensor:
    """A DTensor (or a plain tensor, returned as it is) as the whole
    tensor on every rank, gathered by :func:`gather_full`."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(leaf, DTensor):
        return leaf
    mesh = leaf.device_mesh
    names = axis_names(mesh)
    per_dim: dict[int, list[str]] = {}
    for m, pl in enumerate(leaf.placements):
        if isinstance(pl, Shard):
            per_dim.setdefault(pl.dim, []).append(names[m])
    spec = P(*(tuple(per_dim[d]) if len(per_dim.get(d, [])) > 1
               else (per_dim[d][0] if d in per_dim else None)
               for d in range(leaf.dim())))
    return gather_full(leaf.to_local(), leaf.shape, spec, mesh)


# ---------------------------------------------------------------------------
# The compute view
# ---------------------------------------------------------------------------

def _model_only(spec: P) -> P:
    """``spec`` with every axis but 'model' dropped."""
    from .sharding import _filter_axes
    return P(*(_filter_axes(e, ("model",)) for e in spec))


def _segmented(full: torch.Tensor, dim: int, segs, ax: Axis,
               inverse: bool = False) -> torch.Tensor:
    """The compute view of a concatenated dim (module docstring), or with
    ``inverse`` the whole dim from the ranks' compute views."""
    dim = dim % full.dim()
    parts, at = [], 0
    for length, split in segs:
        if inverse:
            n = length // ax.size if split else length
            piece = full.narrow(dim, at, n)
            if split:
                piece = all_gather(piece, ax.group, dim)
            at += n
        else:
            piece = full.narrow(dim, at, length)
            if split:
                piece = _my_chunk(piece, ax, dim)
            at += length
        parts.append(piece)
    return torch.cat(parts, dim=dim).contiguous()


def local_params(tree: Params, specs, mesh, segments: dict | None = None
                 ) -> Params:
    """The compute view of ``tree`` (whole tensors, or DTensors laid out by
    ``specs``) on this rank: whole over every axis but 'model', this
    rank's shard over 'model', concatenated dims by ``segments`` (the
    model's ``compute_segments``)."""
    from torch.distributed.tensor import DTensor

    ax = mesh_axis(mesh, "model")
    segments = segments or {}

    def one(t, spec, path):
        if isinstance(t, DTensor):
            t = full_tensor(t)
        seg = segments.get(tuple(k for k in path if isinstance(k, str)))
        if seg is not None and ax is not None:
            return _segmented(t, seg[0], seg[1], ax)
        return local_shard(t, _model_only(spec), mesh)
    return zip_specs(one, tree, specs)


def full_params(tree: Params, specs, mesh, shapes,
                segments: dict | None = None) -> Params:
    """The whole tensors of a compute-view ``tree`` (the inverse of
    :func:`local_params`), on every rank; ``shapes`` is a tree of the
    whole shapes (tensors or meta tensors)."""
    ax = mesh_axis(mesh, "model")
    segments = segments or {}
    flat_shapes = {}

    def note(s, _spec, path):
        flat_shapes[path] = s.shape
        return s
    zip_specs(note, shapes, specs)

    def one(t, spec, path):
        seg = segments.get(tuple(k for k in path if isinstance(k, str)))
        if seg is not None and ax is not None:
            return _segmented(t, seg[0], seg[1], ax, inverse=True)
        return gather_full(t, flat_shapes[path], _model_only(spec), mesh)
    return zip_specs(one, tree, specs)


def local_zeros(like: Params, specs, mesh, device,
                segments: dict | None = None) -> Params:
    """Zeros of the compute-view shapes of ``like`` (meta tensors will
    do) on ``device``: a rank's cache, allocated without its whole."""
    ax = mesh_axis(mesh, "model")
    segments = segments or {}

    def one(t, spec, path):
        seg = segments.get(tuple(k for k in path if isinstance(k, str)))
        if seg is not None and ax is not None:
            shape = list(t.shape)
            shape[seg[0]] = sum(n // ax.size if split else n
                                for n, split in seg[1])
        else:
            sl = shard_slices(t.shape, _model_only(spec), mesh)
            shape = [len(range(*s.indices(n))) for s, n in zip(sl, t.shape)]
        return torch.zeros(shape, dtype=t.dtype, device=device)
    return zip_specs(one, like, specs)
