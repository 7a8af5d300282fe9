"""The hardware design space (paper §V-A) and its encoding for DSE.

Each knob is an ordinal axis; a design point encodes to a normalized vector in
[0,1]^d for the GP surrogate and to an index tuple for NSGA-II crossover /
mutation.  Legality prunes points whose minimal working set cannot fit the
declared VMEM budget (the paper's scratchpad constraint).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .hw_primitives import DATAFLOWS, HWConfig

# ordinal axes of the space (TPU-aligned values; DESIGN.md §2)
AXES: dict[str, tuple] = {
    "pe_rows": (8, 16, 32, 64, 128, 256, 512),
    "pe_cols": (8, 16, 32, 64, 128, 256, 512),
    "pe_depth": (8, 16, 32, 64, 128, 256, 512, 1024, 2048),
    "vmem_kib": (128, 256, 512, 1024, 2048, 4096, 8192, 12288, 16384),
    "banks": (1, 2, 3, 4),
    "local_accum_kib": (0, 64, 256, 1024),
    "burst_bytes": (256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536),
    "dataflow": DATAFLOWS,
}
_AXIS_NAMES = tuple(AXES)

#: Opt-in tensor-parallelism axis: pass ``codesign(...,
#: space_axes=PARALLELISM_AXES)`` to let MOBO explore (chip config × TP
#: degree) jointly — the cost model charges the per-call all-reduce over
#: ``Target.link_gbps`` and scales area/static power by the chip count.
#: Kept out of the default AXES so seeded single-chip searches (and their
#: goldens) are untouched.
PARALLELISM_AXES: dict[str, tuple] = {"tp": (1, 2, 4, 8)}


@dataclass
class HWSpace:
    """Legal hardware design space for one intrinsic."""

    intrinsic: str = "GEMM"
    axes: dict[str, tuple] = field(default_factory=lambda: dict(AXES))

    def __post_init__(self) -> None:
        self.intrinsic = self.intrinsic.upper()
        self._names = tuple(self.axes)
        self._sizes = tuple(len(self.axes[n]) for n in self._names)

    # -- size / enumeration ---------------------------------------------------
    @property
    def size(self) -> int:
        n = 1
        for s in self._sizes:
            n *= s
        return n

    def config(self, idx: tuple[int, ...]) -> HWConfig:
        kw = {n: self.axes[n][i] for n, i in zip(self._names, idx)}
        return HWConfig(intrinsic=self.intrinsic, **kw)

    def index_of(self, hw: HWConfig) -> tuple[int, ...]:
        return tuple(self.axes[n].index(getattr(hw, n)) for n in self._names)

    def legal(self, hw: HWConfig) -> bool:
        """Minimal working set (one intrinsic tile per operand, double
        buffered per bank policy) must fit the scratchpad."""
        dt = 2  # bf16
        if hw.intrinsic == "GEMM":
            tile = (hw.pe_rows * hw.pe_depth + hw.pe_depth * hw.pe_cols
                    + hw.pe_rows * hw.pe_cols * 2)  # f32 accumulator
        elif hw.intrinsic == "GEMV":
            tile = hw.pe_rows * hw.pe_depth + hw.pe_depth + hw.pe_rows * 2
        elif hw.intrinsic == "DOT":
            tile = 2 * hw.pe_depth + 2
        else:  # CONV2D: 3x3 window halo on an rows x depth input tile
            tile = (hw.pe_depth * (hw.pe_rows + 2) * 3
                    + hw.pe_cols * hw.pe_depth * 9
                    + hw.pe_rows * hw.pe_cols * 2)
        need = tile * dt * max(1, min(hw.banks, 2))
        if need > hw.vmem_bytes:
            return False
        if hw.local_accum_kib * 1024 > hw.vmem_bytes // 4:
            return False
        return True

    # -- sampling & encoding ---------------------------------------------------
    def sample(self, rng: np.random.Generator, n: int,
               exclude: set[tuple] | None = None) -> list[HWConfig]:
        exclude = exclude or set()
        out: list[HWConfig] = []
        seen: set[tuple] = set()
        attempts = 0
        while len(out) < n and attempts < 200 * n:
            attempts += 1
            idx = tuple(int(rng.integers(s)) for s in self._sizes)
            if idx in seen:
                continue
            seen.add(idx)
            hw = self.config(idx)
            if hw.encode() in exclude or not self.legal(hw):
                continue
            out.append(hw)
        return out

    def encode01(self, hw: HWConfig) -> np.ndarray:
        """Normalized [0,1]^d vector for the GP (ordinal axes scaled)."""
        idx = self.index_of(hw)
        return np.array([i / max(1, s - 1) for i, s in zip(idx, self._sizes)],
                        dtype=float)

    def mutate(self, hw: HWConfig, rng: np.random.Generator,
               p: float = 0.25) -> HWConfig:
        idx = list(self.index_of(hw))
        for k, s in enumerate(self._sizes):
            if rng.random() < p:
                step = int(rng.integers(1, 3)) * (1 if rng.random() < 0.5 else -1)
                idx[k] = int(np.clip(idx[k] + step, 0, s - 1))
        cand = self.config(tuple(idx))
        return cand if self.legal(cand) else hw

    def crossover(self, a: HWConfig, b: HWConfig,
                  rng: np.random.Generator) -> HWConfig:
        ia, ib = self.index_of(a), self.index_of(b)
        idx = tuple(ia[k] if rng.random() < 0.5 else ib[k]
                    for k in range(len(ia)))
        cand = self.config(idx)
        return cand if self.legal(cand) else a
