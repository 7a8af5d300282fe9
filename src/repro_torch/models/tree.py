"""Parameter and cache trees shared by every family: nested dicts of
tensors with the reference's names and layouts (its pytrees).  Layers are
stacked on leading axes (one for the transformer and rwkv6, two for
zamba2's groups), so a model walks them by index and gets views."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

Params = dict[str, Any]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same-keyed leaves of the
    trees ``rest``), as a tree of the results."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def leaves(tree):
    """Leaves of a tree, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def arrays(tree):
    """The tensor and numpy-array leaves of a tree of dicts, lists, tuples
    (named ones too) and dataclasses, in order; other leaves are skipped."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from arrays(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from arrays(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from arrays(getattr(tree, f.name))


def layer(tree, *idx: int):
    """The entry at ``idx`` of a stacked tree's leading axes, as views
    (in-place writes land in the stack)."""
    return tree_map(lambda t: t[idx], tree)


def stacked_init(shape: tuple[int, ...],
                 make_block: Callable[[], Params]) -> Params:
    """``prod(shape)`` blocks from ``make_block``, stacked on leading axes
    ``shape`` in row-major order, drawn one by one into the stack (no
    second copy of the weights is ever held)."""
    n = math.prod(shape)
    first = make_block()
    stack = tree_map(lambda t: t.new_empty((*shape, *t.shape)), first)
    for i in range(n):
        block = first if i == 0 else make_block()
        for dst, src in zip(leaves(stack), leaves(block)):
            dst.view(n, *src.shape)[i].copy_(src)
    return stack


def params_from_numpy(tree, device="cuda") -> Params:
    """A tree of numpy arrays (the reference's params or caches after
    ``np.asarray`` on each leaf) as the port's tensors on ``device``,
    copied.  bfloat16 arrays (numpy's ``ml_dtypes`` extension type) keep
    their bits."""
    def conv(a):
        a = np.array(a)             # a copy: never alias the caller's buffer
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(a).to(device)
    return tree_map(conv, tree)


def pad_rows(leaf: torch.Tensor, target: int) -> torch.Tensor:
    """``leaf`` right-padded with zeros to ``target`` rows on axis 2, the
    sequence axis of a layer-stacked KV cache."""
    if leaf.shape[2] == target:
        return leaf
    out = leaf.new_zeros((*leaf.shape[:2], target, *leaf.shape[3:]))
    out[:, :, :leaf.shape[2]] = leaf
    return out
