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
  over 'model' every leaf is this rank's shard (with one exception,
  below); over 'data' it is whole (ZeRO-1 and serving: a leaf sharded
  over 'data' is gathered once, up front) or, with ``fsdp=True``, this
  rank's shard, as the reference trains (FSDP, below).  The model code
  adds the collectives over the ambient mesh's 'model' axis
  (``context.use_mesh``): column-parallel products (:func:`column_in`),
  row-parallel ones (:func:`row_out`), the vocab-parallel embedding and
  head, experts over 'model'.
* **FSDP** (:class:`Fsdp`, :func:`take`): the model reads each layer's
  weights through :func:`take`, which inside an :func:`fsdp_scope`
  all-gathers the layer's 'data' shards on the spec's dim where the layer
  runs and reduce-scatters their gradient in the backward.  The scope's
  saved-tensor hooks keep no gathered weight for the backward: each is
  gathered again where the backward reads it, so one layer's weights are
  whole at a time.  Outside a scope :func:`take` is plain indexing.

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
import weakref
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

#: per collective: [calls, seconds of host wall time (the wait for the
#: slowest rank included), bytes, group size, ranks], counted by
#: :func:`_timed`.  ``bytes`` sums the results' bytes (an all-gather's
#: whole gathered buffer, an all-reduce's summed tensor in the dtype it was
#: sent in): what the ring model of ``launch.op_analysis`` reads.  ``group
#: size`` and ``ranks`` are those of the largest group the collective ran
#: over (``ranks`` its global ranks, which say what fabric it crosses).
STATS: dict[str, list] = {}


def _group_ranks(group) -> tuple[int, ...]:
    if group is None:
        return tuple(range(dist.get_world_size()))
    return tuple(dist.get_process_group_ranks(group))


def _timed(name: str, group_of, wire_itemsize=lambda t: t.element_size()):
    """Count the calls of collective ``name``, their wall time, bytes and
    group (``group_of(args, kwargs)``) in :data:`STATS` (a CUDA tensor's
    collective waits for the card first, so the time is the collective's
    own).  ``wire_itemsize(out)`` is the bytes an element of the result
    took on the wire."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(x, *args, **kwargs):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            t0 = time.perf_counter()
            out = fn(x, *args, **kwargs)
            if out.is_cuda:
                torch.cuda.synchronize(out.device)
            dt = time.perf_counter() - t0
            group = group_of(args, kwargs)
            entry = STATS.setdefault(name, [0, 0.0, 0, 0, ()])
            entry[0] += 1
            entry[1] += dt
            entry[2] += out.numel() * wire_itemsize(out)
            n = dist.get_world_size(group)
            if n > entry[3]:
                entry[3], entry[4] = n, _group_ranks(group)
            return out
        return run
    return wrap


def _summed_itemsize(t: torch.Tensor) -> int:
    """A bfloat16 or float16 sum travels in float32 (:func:`all_reduce`)."""
    return 4 if t.dtype in (torch.bfloat16, torch.float16) \
        else t.element_size()


@_timed("all_reduce", lambda a, k: a[0], _summed_itemsize)
def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group``, as a new tensor.  A bfloat16 or
    float16 ``x`` is summed in float32 and rounded once, as one product
    over the whole reduction dim would be."""
    low = x.dtype in (torch.bfloat16, torch.float16)
    y = x.detach().float() if low else x.detach().clone()
    y = y.contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


@_timed("all_gather", lambda a, k: a[0])
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


@_timed("broadcast",
        lambda a, k: k.get("group", a[1] if len(a) > 1 else None))
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

def _only(spec: P, axis: str) -> P:
    """``spec`` with every axis but ``axis`` dropped."""
    from .sharding import _filter_axes
    return P(*(_filter_axes(e, (axis,)) for e in spec))


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


def fsdp_dim(spec: P, mesh) -> int | None:
    """The dim ``spec`` shards over 'data' on ``mesh`` (None: none, or
    the mesh has no 'data' axis of more than one rank).  The dim may name
    no other axis of more than one rank: a rank's 'model' shard of it
    would not be a slice of the dim gathered over 'data'."""
    if mesh_axis(mesh, "data") is None:
        return None
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        if "data" in axes:
            others = [a for a in axes if a != "data"
                      and mesh_axis(mesh, a) is not None]
            if others:
                raise ValueError(f"{spec}: FSDP over 'data' on a dim also "
                                 f"split over {others}")
            return d
    return None


def _key(path) -> tuple:
    return tuple(k for k in path if isinstance(k, str))


def local_params(tree: Params, specs, mesh, segments: dict | None = None,
                 fsdp: bool = False) -> Params:
    """The compute view of ``tree`` (whole tensors, or DTensors laid out by
    ``specs``) on this rank: this rank's shard over 'model', concatenated
    dims by ``segments`` (the model's ``compute_segments``); whole over
    every other axis, or with ``fsdp`` this rank's shard over 'data' too
    (:func:`fsdp_dim`)."""
    from torch.distributed.tensor import DTensor

    ax = mesh_axis(mesh, "model")
    segments = segments or {}

    def one(t, spec, path):
        if isinstance(t, DTensor):
            t = full_tensor(t)
        if fsdp and fsdp_dim(spec, mesh) is not None:
            t = local_shard(t, _only(spec, "data"), mesh)
        seg = segments.get(_key(path))
        if seg is not None and ax is not None:
            return _segmented(t, seg[0], seg[1], ax)
        return local_shard(t, _only(spec, "model"), mesh)
    return zip_specs(one, tree, specs)


def full_params(tree: Params, specs, mesh, shapes,
                segments: dict | None = None, fsdp: bool = False) -> Params:
    """The whole tensors of a compute-view ``tree`` (the inverse of
    :func:`local_params`, ``fsdp`` as there), on every rank; ``shapes``
    is a tree of the whole shapes (tensors or meta tensors)."""
    ax = mesh_axis(mesh, "model")
    segments = segments or {}
    flat_shapes = {}

    def note(s, _spec, path):
        flat_shapes[path] = s.shape
        return s
    zip_specs(note, shapes, specs)

    def one(t, spec, path):
        shape = flat_shapes[path]
        d = fsdp_dim(spec, mesh) if fsdp else None
        if d is not None:       # over 'data' first: the dim is not 'model''s
            whole_d = list(t.shape)
            whole_d[d] = shape[d]
            t = gather_full(t, whole_d, _only(spec, "data"), mesh)
        seg = segments.get(_key(path))
        if seg is not None and ax is not None:
            return _segmented(t, seg[0], seg[1], ax, inverse=True)
        return gather_full(t, shape, _only(spec, "model"), mesh)
    return zip_specs(one, tree, specs)


def local_zeros(like: Params, specs, mesh, device,
                segments: dict | None = None, fsdp: bool = False) -> Params:
    """Zeros of the compute-view shapes of ``like`` (meta tensors will
    do) on ``device``, ``fsdp`` as in :func:`local_params`: a rank's
    cache or state, allocated without its whole."""
    ax = mesh_axis(mesh, "model")
    segments = segments or {}

    def one(t, spec, path):
        shape = list(t.shape)
        d = fsdp_dim(spec, mesh) if fsdp else None
        if d is not None:
            data = mesh_axis(mesh, "data")
            shape[d] = chunk(shape[d], data.size, data.rank)[1]
        seg = segments.get(_key(path))
        if seg is not None and ax is not None:
            shape[seg[0]] = sum(n // ax.size if split else n
                                for n, split in seg[1])
        else:
            sl = shard_slices(shape, _only(spec, "model"), mesh)
            shape = [len(range(*s.indices(n))) for s, n in zip(sl, shape)]
        return torch.zeros(shape, dtype=t.dtype, device=device)
    return zip_specs(one, like, specs)


# ---------------------------------------------------------------------------
# FSDP: a layer's weights gathered over 'data' where it runs
# ---------------------------------------------------------------------------

class _Part(NamedTuple):
    """How one leaf is cut over 'data': the dim of the (stacked) leaf,
    each rank's length on it, and this rank's start."""
    dim: int
    sizes: list
    start: int

    def gather(self, x: torch.Tensor, ax: Axis, lead: int) -> torch.Tensor:
        """The ranks' shards ``x`` of a leaf indexed on ``lead`` leading
        dims, joined on the part's dim."""
        return all_gather(x, ax.group, self.dim - lead, self.sizes)

    def scatter(self, g: torch.Tensor, ax: Axis, lead: int) -> torch.Tensor:
        """The sum over 'data' of the gathered gradient ``g``, this rank's
        slice of it (the reduce-scatter; gloo has none)."""
        return all_reduce(g, ax.group).narrow(
            self.dim - lead, self.start,
            self.sizes[ax.rank]).contiguous()


class Fsdp:
    """The FSDP layout of a param tree on ``mesh``: for each leaf (by its
    key path) the :class:`_Part` cut over 'data' by ``specs``, or None
    where the leaf is replicated over 'data'.  ``shapes`` is a tree of
    the whole leaves (meta or fake tensors will do)."""

    def __init__(self, specs, mesh, shapes):
        self.specs = specs
        self.data = mesh_axis(mesh, "data")
        self.parts: dict[tuple, _Part | None] = {}

        def note(s, spec, path):
            d = fsdp_dim(spec, mesh)
            part = None
            if d is not None:
                n, k = s.shape[d], self.data.size
                part = _Part(d, [chunk(n, k, i)[1] for i in range(k)],
                             chunk(n, k, self.data.rank)[0])
            self.parts[_key(path)] = part
            return s
        zip_specs(note, shapes, specs)

    def map(self, fn, tree) -> Params:
        """``fn(leaf, part)`` over a params-shaped tree."""
        return zip_specs(lambda t, _s, path: fn(t, self.parts[_key(path)]),
                         tree, self.specs)


class _Acc:
    """The gradient of a stacked leaf, written a layer at a time by its
    :class:`_Take` s and handed on by the last of them to run."""

    def __init__(self, stack: torch.Tensor):
        self.shape, self.buf, self.pending = stack.shape, None, 0


class _Take(torch.autograd.Function):
    """Layer ``idx`` of the stacked shard ``stack`` (the shard itself
    where ``idx`` is ()), gathered over 'data' where ``part`` says:
    forward an all-gather, backward a reduce-scatter (each rank's
    gradient is its own rows' part of the sum).  A stacked leaf's layers
    write their gradients into one buffer (``acc``) that the last to run
    hands on: no stack-sized zeros a layer, as indexing's backward has."""

    @staticmethod
    def forward(ctx, stack, idx, part, ax, acc):
        ctx.idx, ctx.part, ctx.ax, ctx.acc = idx, part, ax, acc
        if acc is not None:
            acc.pending += 1
        x = stack[idx] if idx else stack
        return x.clone() if part is None else part.gather(x, ax, len(idx))

    @staticmethod
    def backward(ctx, g):
        if ctx.part is not None:
            g = ctx.part.scatter(g, ctx.ax, len(ctx.idx))
        acc = ctx.acc
        if acc is None:
            return g, None, None, None, None
        if acc.buf is None:
            acc.buf = g.new_zeros(acc.shape)
        acc.buf[ctx.idx] = g
        acc.pending -= 1
        return (acc.buf if acc.pending == 0 else None), None, None, None, \
            None


class _Regather(NamedTuple):
    """A saved gathered weight, kept as the recipe to gather it again."""
    stack: torch.Tensor
    idx: tuple
    part: _Part
    view: tuple            # size, stride, storage offset


class _Scope:
    def __init__(self, layout: Fsdp):
        self.layout = layout
        self.acc: dict[int, _Acc] = {}
        # storage of each gathered weight alive -> how to gather it again
        self.gathered: dict[int, tuple] = {}

    def take(self, sub, path: tuple, idx: tuple):
        ax = self.layout.data

        def one(t, sub_path):
            if isinstance(t, dict):
                return {k: one(v, sub_path + (k,)) for k, v in t.items()}
            part = self.layout.parts[path + sub_path]
            if part is None and not idx:
                return t
            acc = None
            if idx:
                acc = self.acc.get(id(t))
                if acc is None:
                    acc = self.acc[id(t)] = _Acc(t)
            y = _Take.apply(t, idx, part, ax, acc)
            if part is not None:
                key = y.untyped_storage()._cdata
                self.gathered[key] = (t, idx, part)
                weakref.finalize(y, self.gathered.pop, key, None)
            return y
        return one(sub, ())

    def pack(self, t: torch.Tensor):
        recipe = self.gathered.get(t.untyped_storage()._cdata)
        if recipe is None:
            return t
        return _Regather(*recipe, (t.size(), t.stride(), t.storage_offset()))

    def unpack(self, saved):
        if not isinstance(saved, _Regather):
            return saved
        x = saved.stack[saved.idx] if saved.idx else saved.stack
        whole = saved.part.gather(x.detach(), self.layout.data,
                                  len(saved.idx))
        return whole.as_strided(*saved.view)


_SCOPE: dict[str, _Scope | None] = {"now": None}


@contextlib.contextmanager
def fsdp_scope(layout: Fsdp | None):
    """Run a forward and its backward with ``layout``'s weights gathered
    by :func:`take` (nothing changes with None, or on a mesh whose 'data'
    axis has one rank)."""
    if layout is None or layout.data is None:
        yield
        return
    prev, scope = _SCOPE["now"], _Scope(layout)
    _SCOPE["now"] = scope
    try:
        with torch.autograd.graph.saved_tensors_hooks(scope.pack,
                                                      scope.unpack):
            yield
    finally:
        _SCOPE["now"] = prev


def take(params: Params, path: tuple, idx: tuple = ()) -> Params:
    """The subtree of ``params`` at ``path``, at layer ``idx`` of its
    stacked leading dims: views of the stack; inside an
    :func:`fsdp_scope`, each leaf gathered over 'data' (:class:`_Take`)."""
    sub = params
    for k in path:
        sub = sub[k]
    scope = _SCOPE["now"]
    if scope is not None:
        return scope.take(sub, tuple(path), tuple(idx))

    def index(t):
        if isinstance(t, dict):
            return {k: index(v) for k, v in t.items()}
        return t[tuple(idx)] if idx else t
    return index(sub)
