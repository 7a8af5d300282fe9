"""Per-device FLOPs and collective bytes of one step: the port's
counterpart of ``repro/launch/hlo_analysis.py`` (DESIGN.md §7).

The reference parses the partitioned HLO text, because XLA's own cost
analysis counts a scanned layer stack's body once.  The port has no HLO:
it counts what the dispatcher runs.  Eager code runs every layer, so
there is no scan-once problem to reconstruct around:

  * FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``
    (matmuls, batched matmuls, convolutions and attention; elementwise ops
    excluded, as the reference's dot count excludes them);
  * collectives come from ``distributed.local.STATS``, which counts every
    explicit collective of the port with the bytes of its result and its
    group (exact: the port's collectives are all explicit);
  * :meth:`OpReport.wire_bytes` is the reference's ring model, copied.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from torch.utils._python_dispatch import TorchDispatchMode

#: the port's collective names -> the reference's kinds
KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
         "broadcast": "broadcast"}


@dataclass
class OpReport:
    dot_flops: float
    collective_bytes: dict[str, float]      # per kind, raw output bytes
    group_sizes: dict[str, int]
    n_collectives: dict[str, int]
    # per kind: the global ranks of its largest group (its fabric)
    group_ranks: dict[str, tuple[int, ...]] = field(default_factory=dict)
    n_ops: int = 0

    def wire_bytes(self) -> float:
        """ICI wire traffic per device: ring-model multipliers —
        all-reduce 2·(g−1)/g · size; all-gather/reduce-scatter (g−1)/g of
        full buffer (output/input resp., both = parsed size here for AG;
        RS parsed size is the small output → ×(g−1)); others 1×."""
        total = 0.0
        for kind, size in self.collective_bytes.items():
            total += self.kind_wire_bytes(kind, size)
        return total

    def kind_wire_bytes(self, kind: str, size: float | None = None) -> float:
        """:meth:`wire_bytes` of one kind."""
        size = self.collective_bytes[kind] if size is None else size
        if kind.endswith(":group"):
            return 0.0
        g = max(2, self.group_sizes.get(kind, 2))
        if kind == "all-reduce":
            return 2.0 * size * (g - 1) / g
        if kind == "all-gather":
            return size * (g - 1) / g
        if kind == "reduce-scatter":
            return size * (g - 1)
        return size


def from_stats(stats: dict, dot_flops: float = 0.0,
               n_ops: int = 0) -> OpReport:
    """An :class:`OpReport` of ``local.STATS`` (``[calls, seconds, bytes,
    group size, ranks]`` a collective) and a FLOP count."""
    rep = OpReport(float(dot_flops), {}, {}, {}, {}, n_ops)
    for name, (calls, _sec, nbytes, group, ranks) in stats.items():
        kind = KINDS.get(name, name)
        rep.collective_bytes[kind] = float(nbytes)
        rep.group_sizes[kind] = int(group)
        rep.n_collectives[kind] = int(calls)
        rep.group_ranks[kind] = tuple(ranks)
    return rep


class OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched (the program's size, where the
    reference records its HLO text's)."""
    n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def analyze(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` counting its FLOPs, its dispatched ops
    and its collectives (``local.STATS`` is reset first); returns (its
    output, an :class:`OpReport`)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed import local

    local.STATS.clear()
    counter = FlopCounterMode(display=False)
    ops = OpCount()
    with counter, ops:
        out = fn(*args, **kwargs)
    return out, from_stats(local.STATS, counter.get_total_flops(), ops.n)
