"""Model weights made by the benchmark from ``--seed``, on the device.

A reference module's ``param_tree`` gives every leaf's shape, type and
initial scale (``reference.common.Leaf``).  The drawn leaves of one type
are views into one buffer filled by one ``torch.randn`` call of a
``torch.Generator`` on the device, each view then scaled in place; the
constant leaves (norms, biases) are fills.  The same seed gives the same
tensors, so the reference can draw them again after the program has run.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from perfbench.reference.common import Leaf


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of draws of a run."""
    ss = np.random.SeedSequence([seed % 2**64, zlib.crc32(stream.encode())])
    hi, lo = (int(x) for x in ss.generate_state(2, np.uint32))
    return ((hi << 32) | lo) & (2**63 - 1)


def leaves(tree, path=()):
    """(path, leaf) pairs of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    else:
        yield path, tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def count(spec) -> int:
    return sum(leaf.numel for _, leaf in leaves(spec))


def matmul_params(spec) -> int:
    """Weights a token multiplies by, each counted once for each call."""
    return sum(leaf.numel * leaf.mm_calls for _, leaf in leaves(spec))


def make(spec, seed: int, device) -> dict:
    """The tree of tensors for ``spec`` drawn from ``seed`` on
    ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights"))
    drawn: dict[str, list[tuple[tuple, Leaf]]] = {}
    for path, leaf in leaves(spec):
        if leaf.scale:
            drawn.setdefault(leaf.dtype, []).append((path, leaf))
    views = {}
    for dtype, group in drawn.items():
        total = sum(leaf.numel for _, leaf in group)
        buf = torch.randn(total, generator=gen, dtype=getattr(torch, dtype),
                          device=device)
        at = 0
        for path, leaf in group:
            v = buf[at:at + leaf.numel].view(leaf.shape)
            v.mul_(leaf.scale)
            if leaf.offset:
                v.add_(leaf.offset)
            views[path] = v
            at += leaf.numel

    def build(tree, path=()):
        if isinstance(tree, dict):
            return {k: build(v, path + (k,)) for k, v in tree.items()}
        if path in views:
            return views[path]
        return torch.full(tree.shape, tree.offset,
                          dtype=getattr(torch, tree.dtype), device=device)
    return build(spec)
