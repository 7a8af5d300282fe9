"""Tensor syntax trees (TSTs) — HASCO's unified HW/SW IR (paper §IV-B).

A TST abstracts the loop and tensor structure of a tensor computation's
right-hand side.  Internal nodes are operations (``sum``, ``mul``, ``add``,
``access``/``[]``, ``affine``/``+`` inside one access dimension); leaves are
loop-index occurrences.  The tree for ``C[k,x,y] = sum A[c,x+r,y+s]*B[k,c,r,s]``
has nine leaves (c,x,r,y,s under the A access and k,c,r,s under the B access).

Two TSTs exist per tensorize decision: the *compute* tree (the workload) and
the *intrinsic* tree (what the accelerator's hardware intrinsic implements).
``repro.core.matching`` performs the paper's two-step matching over them.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Iterator

# ---------------------------------------------------------------------------
# Node kinds
# ---------------------------------------------------------------------------

SUM = "sum"        # reduction over one or more indices
MUL = "mul"        # n-ary product
ADD = "add"        # n-ary sum of sub-expressions
ACCESS = "access"  # tensor indexing node ``[]``
AFFINE = "affine"  # ``+`` of loops inside a single access dimension
LOOP = "loop"      # leaf: one occurrence of a loop index


@dataclass(frozen=True)
class Node:
    """One TST node.  ``children`` is a tuple of Nodes; leaves have none.

    ``label`` carries the loop index for LOOP leaves and the tensor name for
    ACCESS nodes; it is empty for pure operator nodes.
    """

    kind: str
    children: tuple["Node", ...] = ()
    label: str = ""

    def __post_init__(self) -> None:
        if self.kind == LOOP and self.children:
            raise ValueError("loop leaves cannot have children")
        if self.kind not in (SUM, MUL, ADD, ACCESS, AFFINE, LOOP):
            raise ValueError(f"unknown node kind {self.kind!r}")

    # -- convenience constructors ------------------------------------------
    @staticmethod
    def loop(index: str) -> "Node":
        return Node(LOOP, (), index)

    @staticmethod
    def access(tensor: str, dims: tuple[tuple[str, ...], ...]) -> "Node":
        """``dims`` is one tuple of loop indices per tensor dimension; a
        dimension with >1 index becomes an AFFINE node (e.g. ``x+r``)."""
        children = []
        for dim in dims:
            if len(dim) == 1:
                children.append(Node.loop(dim[0]))
            else:
                children.append(Node(AFFINE, tuple(Node.loop(i) for i in dim)))
        return Node(ACCESS, tuple(children), tensor)

    def __repr__(self) -> str:  # compact, deterministic
        if self.kind == LOOP:
            return self.label
        if self.kind == ACCESS:
            return f"{self.label}[{','.join(map(repr, self.children))}]"
        sep = {MUL: "*", ADD: " + ", AFFINE: "+"}.get(self.kind)
        if sep is not None:
            return "(" + sep.join(map(repr, self.children)) + ")"
        return f"sum({self.children[0]!r})"


@dataclass(frozen=True)
class Leaf:
    """A leaf occurrence: which index, where in the tree, inside which tensor."""

    index: str
    path: tuple[int, ...]  # child positions from the root
    tensor: str            # enclosing ACCESS label ('' if none)
    dim: int               # dimension position within the access (-1 if none)


@dataclass
class TensorExpr:
    """A full tensor computation ``out[out_indices] = sum_{reduced} body``.

    ``extents`` maps every loop index to its trip count.  ``reduced`` is the
    set of indices not appearing in the output (inferred by the parser).
    """

    name: str
    output: str
    out_indices: tuple[str, ...]
    body: Node
    extents: dict[str, int]
    reduced: frozenset[str] = field(default_factory=frozenset)

    def __post_init__(self) -> None:
        indices = {leaf.index for leaf in leaves(self.body)}
        missing = indices - set(self.extents)
        if missing:
            raise ValueError(f"{self.name}: extents missing for {sorted(missing)}")
        if not self.reduced:
            self.reduced = frozenset(indices - set(self.out_indices))

    # FLOP count for the computation (2 flops per multiply-accumulate, and
    # each extra product factor adds one multiply per point).
    def flops(self) -> int:
        n_factors = len(self.body.children) if self.body.kind == MUL else 1
        pts = 1
        for e in self.extents.values():
            pts *= e
        return pts * max(2, 2 * (n_factors - 1))

    def all_indices(self) -> tuple[str, ...]:
        seen: list[str] = []
        for leaf in leaves(self.body):
            if leaf.index not in seen:
                seen.append(leaf.index)
        return tuple(seen)

    def tensors(self) -> dict[str, tuple[tuple[str, ...], ...]]:
        """tensor name -> per-dimension index tuples (input operands only)."""
        out: dict[str, tuple[tuple[str, ...], ...]] = {}
        for node, _ in walk(self.body):
            if node.kind == ACCESS:
                dims = []
                for ch in node.children:
                    if ch.kind == LOOP:
                        dims.append((ch.label,))
                    else:
                        dims.append(tuple(g.label for g in ch.children))
                out[node.label] = tuple(dims)
        return out

    def tensor_shape(self, tensor: str) -> tuple[int, ...]:
        dims = self.tensors()[tensor]
        # affine dims (x+r) size ~ sum of extents - (#terms - 1)
        return tuple(sum(self.extents[i] for i in d) - (len(d) - 1) for d in dims)


# ---------------------------------------------------------------------------
# Traversal helpers
# ---------------------------------------------------------------------------

def walk(root: Node) -> Iterator[tuple[Node, tuple[int, ...]]]:
    stack: list[tuple[Node, tuple[int, ...]]] = [(root, ())]
    while stack:
        node, path = stack.pop()
        yield node, path
        for i, ch in enumerate(node.children):
            stack.append((ch, path + (i,)))


def leaves(root: Node) -> list[Leaf]:
    out: list[Leaf] = []

    def rec(node: Node, path: tuple[int, ...], tensor: str, dim: int) -> None:
        if node.kind == LOOP:
            out.append(Leaf(node.label, path, tensor, dim))
            return
        for i, ch in enumerate(node.children):
            if node.kind == ACCESS:
                rec(ch, path + (i,), node.label, i)
            else:
                rec(ch, path + (i,), tensor, dim)

    rec(root, (), "", -1)
    out.sort(key=lambda l: l.path)
    return out


def node_at(root: Node, path: tuple[int, ...]) -> Node:
    node = root
    for i in path:
        node = node.children[i]
    return node


def lca_kind(root: Node, a: tuple[int, ...], b: tuple[int, ...]) -> str:
    """Operation kind of the lowest common ancestor of two leaf paths."""
    k = 0
    while k < min(len(a), len(b)) and a[k] == b[k]:
        k += 1
    return node_at(root, a[:k]).kind


def count_nodes(root: Node) -> int:
    return sum(1 for _ in walk(root))


# ---------------------------------------------------------------------------
# Parser:  "C[k,x,y] = A[c,x+r,y+s] * B[k,c,r,s]"   (reduction inferred)
# ---------------------------------------------------------------------------

_ACCESS_RE = re.compile(r"([A-Za-z_]\w*)\s*\[([^\]]*)\]")


def _parse_access(text: str) -> Node:
    m = _ACCESS_RE.fullmatch(text.strip())
    if not m:
        raise ValueError(f"cannot parse tensor access {text!r}")
    tensor, idx = m.group(1), m.group(2)
    dims = tuple(tuple(p.strip() for p in d.split("+")) for d in idx.split(","))
    return Node.access(tensor, dims)


def parse(notation: str, extents: dict[str, int], name: str = "") -> TensorExpr:
    """Parse ``Out[i,j] = A[i,k] * B[k,j]`` (products of accesses, affine
    dims allowed).  Reduction indices are those absent from the output."""
    lhs, rhs = notation.split("=", 1)
    out = _ACCESS_RE.fullmatch(lhs.strip())
    if not out:
        raise ValueError(f"cannot parse output {lhs!r}")
    output, out_idx = out.group(1), tuple(i.strip() for i in out.group(2).split(","))
    factors = [f for f in rhs.split("*") if f.strip()]
    accesses = tuple(_parse_access(f) for f in factors)
    body = accesses[0] if len(accesses) == 1 else Node(MUL, accesses)
    indices = {l.index for l in leaves(body)}
    reduced = frozenset(indices - set(out_idx))
    if reduced:
        body = Node(SUM, (body,))
    return TensorExpr(name or output, output, out_idx, body, dict(extents), reduced)
