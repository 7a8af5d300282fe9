"""Software primitives and schedules (paper §VI-A, Fig. 5(c)).

A *schedule* concretizes one tensorize choice: ``split`` factors pick the
interface-level sub-workload size for each mapped loop, ``reorder`` fixes the
outer software loop order, ``fuse`` collapses outermost loops, ``tensorize``
marks the HW/SW boundary.  We keep the declarative form (tiles + order) as
the canonical representation and provide the primitive-sequence view for
fidelity with the paper's Fig. 5(c).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from .matching import TensorizeChoice
from .tst import TensorExpr


@dataclass(frozen=True)
class Primitive:
    """One schedule primitive: split/reorder/fuse/tensorize."""

    kind: str                 # 'split' | 'reorder' | 'fuse' | 'tensorize'
    args: tuple = ()

    def __repr__(self) -> str:
        return f"{self.kind}{self.args}"


@dataclass(frozen=True)
class Schedule:
    """A concrete software optimization for one workload on one accelerator.

    ``tiles`` maps each *mapped* compute loop to its interface tile (the
    sub-workload extent handled by one tensorize-interface call).  ``order``
    is the outer software loop order, outermost first, over ALL compute loops
    (mapped loops appear via their outer counter).  ``fuse_outer`` fuses the
    n outermost loops into one (launch-overhead reduction).
    """

    choice: TensorizeChoice
    tiles: tuple[tuple[str, int], ...]
    order: tuple[str, ...]
    fuse_outer: int = 0

    @property
    def tile_map(self) -> dict[str, int]:
        return dict(self.tiles)

    def with_tile(self, loop: str, value: int) -> "Schedule":
        tiles = tuple((l, value if l == loop else v) for l, v in self.tiles)
        return replace(self, tiles=tiles)

    def with_order(self, order: tuple[str, ...]) -> "Schedule":
        return replace(self, order=tuple(order))

    def to_primitives(self, workload: TensorExpr) -> list[Primitive]:
        """The Fig. 5(c) view: [split..., reorder, fuse, tensorize]."""
        seq: list[Primitive] = []
        for loop, t in self.tiles:
            if t < workload.extents[loop]:
                seq.append(Primitive("split", (loop, t)))
        seq.append(Primitive("reorder", tuple(self.order)))
        if self.fuse_outer > 1:
            seq.append(Primitive("fuse", (self.fuse_outer,)))
        seq.append(Primitive("tensorize",
                             (self.choice.intrinsic_name,
                              tuple(c for _, c in self.choice.index_map))))
        return seq

    def describe(self) -> str:
        t = ", ".join(f"{l}={v}" for l, v in self.tiles)
        return (f"[{self.choice.intrinsic_name}] tiles({t}) "
                f"order({'>'.join(self.order)}) fuse={self.fuse_outer}")


def schedule_from_primitives(workload: TensorExpr, choice: TensorizeChoice,
                             seq: list[Primitive]) -> Schedule:
    """Build a Schedule by *applying* a primitive sequence (paper-style API).

    Unlisted mapped loops default to full-extent tiles; the reorder primitive
    must mention every loop it keeps outer.
    """
    mapped = set(choice.mapped_compute_indices)
    tiles = {l: workload.extents[l] for l in mapped}
    order = tuple(workload.all_indices())
    fuse = 0
    for p in seq:
        if p.kind == "split":
            loop, t = p.args
            if loop in mapped:
                tiles[loop] = int(t)
        elif p.kind == "reorder":
            order = tuple(p.args[0]) if len(p.args) == 1 else tuple(p.args)
        elif p.kind == "fuse":
            fuse = int(p.args[0])
        elif p.kind == "tensorize":
            pass  # boundary marker; the choice is already given
        else:
            raise ValueError(f"unknown primitive {p.kind}")
    return Schedule(choice, tuple(sorted(tiles.items())), order, fuse)
