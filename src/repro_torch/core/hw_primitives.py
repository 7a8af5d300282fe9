"""Hardware primitives (paper §V-A, Fig. 6) adapted to the TPU target.

The paper's primitives describe an FPGA/ASIC spatial accelerator; on TPU the
"accelerator instance" is a Pallas kernel resource envelope (DESIGN.md §2):

  reshapeArray([m, n])    -> MXU block shape (pe_rows, pe_cols); pe_depth is
                             the contraction block (the paper's intrinsic size
                             along the reduction).
  linkPEs(pattern)        -> fixed 'systolic' on TPU (the MXU); kept for API
                             fidelity, rejects anything else.
  addCache(kib)           -> VMEM budget the kernel's BlockSpecs may claim.
  partitionBanks(n)       -> pipeline depth: 1 = no overlap, 2 = double
                             buffering, 3 = triple.
  distributeCache(kib)    -> accumulator tile kept PE-local (VREG/VMEM
                             accumulator); enables output-stationary reuse.
  burstTransfer(bytes)    -> HBM->VMEM DMA granularity (innermost contiguous
                             block extent in bytes).

A primitive sequence builds an immutable :class:`HWConfig` — one point of the
hardware design space.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

DATAFLOWS = ("OS", "WS", "IS")  # output- / weight- / input-stationary


@dataclass(frozen=True)
class HWConfig:
    """One accelerator instance (= one Pallas kernel configuration)."""

    intrinsic: str = "GEMM"       # DOT | GEMV | GEMM | CONV2D
    pe_rows: int = 128            # MXU block M
    pe_cols: int = 128            # MXU block N
    pe_depth: int = 128           # contraction block K
    link_pattern: str = "systolic"
    vmem_kib: int = 8192          # scratchpad budget (<= 16 MiB/core on v5e)
    banks: int = 2                # pipeline depth (double buffering)
    local_accum_kib: int = 0      # PE-local accumulator (0 = none)
    burst_bytes: int = 4096       # DMA burst granularity
    dataflow: str = "OS"
    tp: int = 1                   # tensor-parallel degree (replicated chips)

    def __post_init__(self) -> None:
        if self.link_pattern != "systolic":
            raise ValueError("TPU MXU interconnect is fixed systolic "
                             "(DESIGN.md §2: linkPEs degenerates on TPU)")
        if self.dataflow not in DATAFLOWS:
            raise ValueError(f"dataflow must be one of {DATAFLOWS}")
        if not isinstance(self.tp, int) or self.tp < 1:
            raise ValueError(f"tp must be a positive int, got {self.tp!r}")

    # -- derived quantities --------------------------------------------------
    @property
    def n_pes(self) -> int:
        """PE count analogue: MXU lanes engaged by the block shape."""
        if self.intrinsic == "DOT":
            return self.pe_depth
        if self.intrinsic == "GEMV":
            return self.pe_rows * min(self.pe_depth, 128) // 128 * 8
        return self.pe_rows * self.pe_cols // 128

    @property
    def vmem_bytes(self) -> int:
        return self.vmem_kib * 1024

    def intrinsic_dims(self) -> dict[str, int]:
        """Logical intrinsic shape per intrinsic index (paper's fixed size)."""
        from .intrinsics import BINDINGS
        return BINDINGS[self.intrinsic].intrinsic_shape(self)

    def encode(self) -> tuple:
        return (self.intrinsic, self.pe_rows, self.pe_cols, self.pe_depth,
                self.vmem_kib, self.banks, self.local_accum_kib,
                self.burst_bytes, self.dataflow, self.tp)


class HWBuilder:
    """Fluent primitive API mirroring the paper's Listing 2.

    >>> hw = (HWBuilder("GEMM").reshapeArray([256, 256]).linkPEs("systolic")
    ...       .addCache(8192).partitionBanks(2).burstTransfer(4096).build())
    """

    def __init__(self, intrinsic: str = "GEMM"):
        self._cfg = HWConfig(intrinsic=intrinsic.upper())

    def reshapeArray(self, shape, depth: int | None = None) -> "HWBuilder":
        rows, cols = (shape if len(shape) == 2 else (shape[0], shape[0]))
        self._cfg = replace(self._cfg, pe_rows=int(rows), pe_cols=int(cols),
                            pe_depth=int(depth or self._cfg.pe_depth))
        return self

    def linkPEs(self, pattern: str) -> "HWBuilder":
        self._cfg = replace(self._cfg, link_pattern=pattern)
        return self

    def addCache(self, kib: int) -> "HWBuilder":
        self._cfg = replace(self._cfg, vmem_kib=int(kib))
        return self

    def partitionBanks(self, n: int) -> "HWBuilder":
        self._cfg = replace(self._cfg, banks=int(n))
        return self

    def distributeCache(self, kib: int) -> "HWBuilder":
        self._cfg = replace(self._cfg, local_accum_kib=int(kib))
        return self

    def burstTransfer(self, nbytes: int) -> "HWBuilder":
        self._cfg = replace(self._cfg, burst_bytes=int(nbytes))
        return self

    def dataflow(self, df: str) -> "HWBuilder":
        self._cfg = replace(self._cfg, dataflow=df.upper())
        return self

    def parallelize(self, tp: int) -> "HWBuilder":
        """Replicate the chip ``tp``-way (tensor parallelism): the weights
        and compute shard across ``tp`` identical instances joined by the
        target's inter-chip link (cost_model charges the per-call
        all-reduce)."""
        self._cfg = replace(self._cfg, tp=int(tp))
        return self

    def build(self) -> HWConfig:
        return self._cfg
