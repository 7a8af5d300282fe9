"""Software design space per (workload × accelerator) (paper §VI-A/B).

The space is the set of legal Schedules: a tensorize choice from the
partition space, power-of-two interface tiles per mapped loop, an outer loop
order, and a fuse factor.  The space exposes the *revision choices* (moves)
the Q-learning agent selects among, and a fixed-size feature embedding of a
schedule for the DQN.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property

import numpy as np

from .cost_model import EvalCache, evaluate, evaluate_batch, evaluate_batch_reports
from .hw_primitives import HWConfig
from .matching import TensorizeChoice
from .sw_primitives import Schedule
from .tst import TensorExpr

MAX_LOOPS = 8          # feature/action slots (>= loops of any Table-I workload)


@dataclass(frozen=True)
class Move:
    kind: str            # 'grow' | 'shrink' | 'sink' | 'swap_outer' | 'switch'
    slot: int = -1

    def describe(self) -> str:
        return f"{self.kind}({self.slot})" if self.slot >= 0 else self.kind


def _pow2_down(x: int) -> int:
    return 1 << max(0, int(math.floor(math.log2(max(1, x)))))


class SoftwareSpace:
    """Legal schedules for one workload on one accelerator instance."""

    def __init__(self, workload: TensorExpr, choices: list[TensorizeChoice],
                 hw: HWConfig, target: str = "spatial",
                 cache: EvalCache | None = None):
        if not choices:
            raise ValueError(f"no tensorize choices for {workload.name}")
        self.workload = workload
        self.choices = [c for c in choices if c.intrinsic_name == hw.intrinsic]
        if not self.choices:
            raise ValueError(
                f"no {hw.intrinsic} choices for {workload.name}")
        self.hw = hw
        self.target = target
        self.cache = cache
        self.loops = list(workload.all_indices())

        # the action table (paper: "change the combination of the primitive
        # sequence or change one primitive factor")
        self.moves: list[Move] = []
        for s in range(MAX_LOOPS):
            self.moves.append(Move("grow", s))
            self.moves.append(Move("shrink", s))
        for s in range(MAX_LOOPS):
            self.moves.append(Move("sink", s))     # move loop s innermost
        self.moves.append(Move("swap_outer"))
        self.moves.append(Move("switch"))          # next tensorize choice

    # -- construction -----------------------------------------------------------
    @cached_property
    def _draws(self) -> list[tuple]:
        """random_schedule's draws per choice: (loop, number of
        power-of-two tiles up to the loop's extent, extent) for each mapped
        loop."""
        ext = self.workload.extents
        return [(c, tuple((i, _pow2_down(ext[i]).bit_length(), ext[i])
                          for i in c.mapped_compute_indices))
                for c in self.choices]

    def random_schedule(self, rng: np.random.Generator) -> Schedule:
        """A uniform draw: a tensorize choice, a power-of-two tile up to
        each mapped loop's extent (clipped to it), a shuffled loop order
        and a fuse factor, drawn in that order from ``rng``."""
        ints = rng.integers
        choice, mapped = self._draws[int(ints(len(self._draws)))]
        tiles = [(c, min(1 << int(ints(top)), e)) for c, top, e in mapped]
        order = list(self.loops)
        rng.shuffle(order)
        return Schedule(choice, tuple(sorted(tiles)), tuple(order),
                        int(ints(3)))

    def default_schedule(self) -> Schedule:
        """A library-style untuned mapping: intrinsic-sized tiles, source
        loop order (the paper's 'directly calling the intrinsic')."""
        choice = self.choices[0]
        block = self.hw.intrinsic_dims()
        tiles = tuple(sorted(
            (c, min(self.workload.extents[c], max(1, block[q])))
            for q, c in choice.index_map))
        return Schedule(choice, tiles, tuple(self.loops), 0)

    # -- evaluation ---------------------------------------------------------------
    def latency(self, s: Schedule) -> float:
        return evaluate(self.workload, s, self.hw, self.target,
                        cache=self.cache).latency_s

    def report(self, s: Schedule):
        return evaluate(self.workload, s, self.hw, self.target,
                        cache=self.cache)

    def latency_batch(self, schedules: list[Schedule]) -> np.ndarray:
        """Latencies of a whole candidate population in one vectorized pass
        (the DSE hot path — DESIGN.md §4.3)."""
        return evaluate_batch(self.workload, self.hw, schedules, self.target,
                              cache=self.cache)[:, 0]

    def report_batch(self, schedules: list[Schedule]):
        return evaluate_batch_reports(self.workload, self.hw, schedules,
                                      self.target, cache=self.cache)

    # -- moves ---------------------------------------------------------------------
    def apply(self, s: Schedule, move: Move,
              rng: np.random.Generator | None = None) -> Schedule:
        ext = self.workload.extents
        tiles = list(s.tiles)
        if move.kind in ("grow", "shrink"):
            if move.slot >= len(tiles):
                return s
            loop, t = tiles[move.slot]
            t = min(ext[loop], t * 2) if move.kind == "grow" else max(1, t // 2)
            return s.with_tile(loop, t)
        if move.kind == "sink":
            if move.slot >= len(s.order):
                return s
            order = list(s.order)
            order.append(order.pop(move.slot))
            return s.with_order(tuple(order))
        if move.kind == "swap_outer":
            if len(s.order) < 2:
                return s
            order = list(s.order)
            order[0], order[1] = order[1], order[0]
            return s.with_order(tuple(order))
        if move.kind == "switch":
            k = self.choices.index(s.choice) if s.choice in self.choices else 0
            nxt = self.choices[(k + 1) % len(self.choices)]
            tiles_map = s.tile_map
            new_tiles = tuple(sorted(
                (c, min(ext[c], tiles_map.get(c, ext[c])))
                for c in nxt.mapped_compute_indices))
            return Schedule(nxt, new_tiles, s.order, s.fuse_outer)
        raise ValueError(move.kind)

    # -- features for the DQN ---------------------------------------------------------
    @property
    def n_features(self) -> int:
        return MAX_LOOPS * 3 + 4

    def features(self, s: Schedule, rep=None) -> np.ndarray:
        """Fixed-size DQN embedding of one schedule.  ``rep`` may supply the
        schedule's CostReport (e.g. from a batched pass) so no extra
        cost-model evaluation is needed."""
        ext = self.workload.extents
        f = np.zeros(self.n_features, dtype=np.float32)
        tile_map = s.tile_map
        for k, loop in enumerate(self.loops[:MAX_LOOPS]):
            f[k] = math.log2(max(1, tile_map.get(loop, 0) or 1)) / 16.0
            f[MAX_LOOPS + k] = (s.order.index(loop) / max(1, len(s.order) - 1)
                                if loop in s.order else 0.0)
            f[2 * MAX_LOOPS + k] = math.log2(ext[loop]) / 16.0
        if rep is None:
            rep = self.report(s)
        f[3 * MAX_LOOPS + 0] = min(1.0, rep.vmem_bytes / self.hw.vmem_bytes) \
            if rep.vmem_bytes else 0.0
        f[3 * MAX_LOOPS + 1] = rep.utilization if rep.legal else 0.0
        f[3 * MAX_LOOPS + 2] = self.choices.index(s.choice) / max(
            1, len(self.choices) - 1) if s.choice in self.choices else 0.0
        f[3 * MAX_LOOPS + 3] = 1.0 if rep.legal else 0.0
        return f

    def features_batch(self, schedules: list[Schedule],
                       reports=None) -> np.ndarray:
        """Feature rows for a whole frontier, (n, n_features): the report-
        derived entries come from ONE batched cost-model pass (or from
        ``reports`` when the caller already has them), not n scalar
        evaluations."""
        if not schedules:
            return np.zeros((0, self.n_features), dtype=np.float32)
        if reports is None:
            reports = self.report_batch(schedules)
        return np.stack([self.features(s, rep)
                         for s, rep in zip(schedules, reports)])
