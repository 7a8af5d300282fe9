"""Analytical accelerator cost model — the Maestro analogue (paper §III,
§VII-A "Metrics"; DESIGN.md §4).

Estimates (latency, power, area) for running one workload under a schedule on
one accelerator instance.  Two evaluation paths share one set of formulas:

  * ``evaluate``       — scalar: one (schedule, hw) pair -> CostReport.  A
    thin memo-aware wrapper over the scalar core.
  * ``evaluate_batch`` — the DSE hot path (DESIGN.md §4.3): N candidate
    (hw, schedule) pairs -> an (N, 3) objectives array in one vectorized
    pass.  Candidates are grouped by tensorize choice; within a group the
    reuse/stationarity analysis runs structure-of-arrays over NumPy (tile
    sizes as (N, M) integer arrays, loop orders as permutation indices).
    An optional :class:`EvalCache` memoizes full reports keyed by
    (workload, schedule, hw, target) so repeated probes across MOBO
    iterations and Step-2/Step-3 of the co-design flow are free.

Two targets share the same machinery:

  * ``spatial`` — paper-faithful: the accelerator's peak is 2·PEs·freq, PE
    arrays may be small (8×8 …), exactly the regime of the paper's FPGA/ASIC
    prototypes.  Used to reproduce Fig. 7 / Table II / Table III.
  * ``tpu``     — v5e-class constants (197 TFLOP/s bf16, 819 GB/s HBM) where
    the "PE array" is the Pallas block shape and utilization includes MXU
    (128-lane) alignment.  Used for kernel tuning and the roofline bridge.

The reuse model is the classic stationarity-from-loop-order analysis: an
operand is re-fetched from DRAM/HBM each time the innermost loop that indexes
it advances; loops strictly inner to that reuse the scratchpad-resident tile.
This is what makes p1-vs-p2-style loop-order effects (paper Fig. 2) visible.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .hw_primitives import HWConfig
from .matching import TensorizeChoice
from .sw_primitives import Schedule
from .tst import TensorExpr

DTYPE_BYTES = 2       # bf16 operands
ACC_BYTES = 4         # f32 accumulation

# -- target constants ---------------------------------------------------------


@dataclass(frozen=True)
class Target:
    name: str
    freq_hz: float            # PE MAC rate (spatial) / MXU clock (tpu)
    hbm_gbps: float           # off-chip bandwidth
    dma_overhead_bytes: int   # per-descriptor fixed cost (burst model)
    mxu_aligned: bool         # apply 128-lane alignment penalties
    startup_s: float          # kernel/interface launch overhead
    # energy constants (pJ)
    e_mac_pj: float
    e_sram_pj_b: float
    e_dram_pj_b: float
    # area constants (um^2)
    a_pe_um2: float
    a_mem_um2_b: float
    static_w_per_norm: float  # static power at full resource envelope
    # inter-chip link bandwidth (GB/s per chip) — the tensor-parallel
    # all-reduce term; only read when hw.tp > 1
    link_gbps: float = 100.0


SPATIAL = Target("spatial", freq_hz=940e6, hbm_gbps=32.0,
                 dma_overhead_bytes=64, mxu_aligned=False, startup_s=2e-7,
                 # dma_overhead 64B ~ AXI4 burst setup on FPGA DDR,
                 # startup = instruction-issue cost of one tensorize-interface
                 # invocation (the paper's interfaces are accelerator
                 # instruction sequences, not host launches)
                 e_mac_pj=0.6, e_sram_pj_b=1.0, e_dram_pj_b=30.0,
                 a_pe_um2=1.0e5, a_mem_um2_b=120.0, static_w_per_norm=2.0,
                 # board-to-board serial links: far below HBM, the reason
                 # TP only pays off once a chip is bandwidth-bound
                 link_gbps=16.0)

TPU_V5E = Target("tpu", freq_hz=940e6, hbm_gbps=819.0,
                 dma_overhead_bytes=512, mxu_aligned=True, startup_s=1e-6,
                 e_mac_pj=0.25, e_sram_pj_b=0.6, e_dram_pj_b=15.0,
                 a_pe_um2=1.0e5, a_mem_um2_b=120.0, static_w_per_norm=4.0,
                 link_gbps=200.0)   # ICI, per chip

TARGETS = {"spatial": SPATIAL, "tpu": TPU_V5E}


@dataclass(frozen=True)
class CostReport:
    latency_s: float
    energy_j: float
    power_w: float
    area_um2: float
    flops: float              # padded (actually executed) flops
    useful_flops: float       # the workload's mathematical flops
    hbm_bytes: float
    compute_s: float
    memory_s: float
    calls: int                # tensorize-interface invocations
    vmem_bytes: int           # scratchpad working set claimed
    legal: bool
    why_illegal: str = ""

    @property
    def objectives(self) -> tuple[float, float, float]:
        """(latency, power, area) — all minimized (paper's Table II axes)."""
        return (self.latency_s, self.power_w, self.area_um2)

    @property
    def utilization(self) -> float:
        return self.useful_flops / max(self.flops, 1.0)


ILLEGAL = CostReport(math.inf, math.inf, math.inf, math.inf, 0, 0, 0,
                     math.inf, math.inf, 0, 0, False)


def n_pes(hw: HWConfig) -> int:
    """PE count per intrinsic family (paper Fig. 7 fixes a PE *budget*)."""
    if hw.intrinsic in ("GEMM", "CONV2D"):
        return hw.pe_rows * hw.pe_cols
    if hw.intrinsic == "GEMV":
        return hw.pe_rows * min(hw.pe_depth, 128)
    return min(hw.pe_depth, 4096)  # DOT: a reduction lane


def accelerator_area(hw: HWConfig, target: Target) -> float:
    mem = hw.vmem_bytes + hw.local_accum_kib * 1024
    return (target.a_pe_um2 * n_pes(hw)
            + target.a_mem_um2_b * mem
            * (1.0 + 0.05 * (hw.banks - 1))) * hw.tp


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _mxu_eff(dim: int, lanes: int) -> float:
    """Fraction of the 128-lane MXU filled by a block dim (tpu target)."""
    return dim / (_ceil(dim, lanes) * lanes) if dim else 1.0


def _evaluate_reference(workload: TensorExpr, schedule: Schedule, hw: HWConfig,
                        target: Target | str = "spatial") -> CostReport:
    """Scalar reference implementation of the cost model.

    This is the original pure-Python evaluation the vectorized batch path
    must agree with elementwise (tests/test_batched_eval.py asserts it on
    random populations).  Production callers use :func:`evaluate` /
    :func:`evaluate_batch` instead.
    """
    tgt = TARGETS[target] if isinstance(target, str) else target
    choice = schedule.choice
    if choice.intrinsic_name != hw.intrinsic:
        return ILLEGAL

    ext = workload.extents
    tiles = schedule.tile_map
    mapped = dict(choice.index_map)                # intrinsic idx -> compute idx
    inv_mapped = {c: q for q, c in mapped.items()}
    block = hw.intrinsic_dims()                    # intrinsic idx -> block extent

    # --- interface tile per mapped loop, padded to the intrinsic block -------
    tile: dict[str, int] = {}
    ptile: dict[str, int] = {}
    align_eff = 1.0
    for q, c in mapped.items():
        t = max(1, min(tiles.get(c, ext[c]), ext[c]))
        b = max(1, block[q])
        pt = _ceil(t, b) * b
        tile[c] = t
        ptile[c] = pt
        align_eff *= t / pt
    if align_eff <= 0:
        return ILLEGAL

    # --- outer software loops (trip counts use the LOGICAL tile: padding is
    # waste inside each call, not fewer calls) --------------------------------
    all_loops = list(workload.all_indices())
    trips = {l: (_ceil(ext[l], tile[l]) if l in inv_mapped else ext[l])
             for l in all_loops}
    order = [l for l in schedule.order if l in trips]
    order += [l for l in all_loops if l not in order]      # robustness
    calls = 1
    for l in all_loops:
        calls *= trips[l]

    # --- per-call footprints (bytes) -------------------------------------------
    tensors = workload.tensors()
    foot: dict[str, int] = {}
    contig: dict[str, int] = {}
    for tname, dims in tensors.items():
        sz = 1
        for dim in dims:
            contrib = sum(ptile.get(i, 1) for i in dim) - (len(dim) - 1)
            sz *= max(1, contrib)
        foot[tname] = sz * DTYPE_BYTES
        last = dims[-1]
        contig[tname] = max(1, sum(ptile.get(i, 1) for i in last)
                            - (len(last) - 1)) * DTYPE_BYTES
    out_foot = 1
    for i in workload.out_indices:
        out_foot *= ptile.get(i, 1)
    out_bytes = out_foot * ACC_BYTES
    out_contig = ptile.get(workload.out_indices[-1], 1) * ACC_BYTES

    # --- scratchpad legality ----------------------------------------------------
    buffered = 2 if hw.banks >= 2 else 1
    local = hw.local_accum_kib * 1024
    out_in_vmem = out_bytes if out_bytes > local else 0
    working = sum(foot.values()) * buffered + out_in_vmem
    if working > hw.vmem_bytes:
        return CostReport(math.inf, math.inf, math.inf,
                          accelerator_area(hw, tgt), 0, 0, 0, math.inf,
                          math.inf, calls, working, False,
                          f"working set {working}B > vmem {hw.vmem_bytes}B")

    # --- compute time --------------------------------------------------------
    # tp > 1 replicates the chip: peak compute and aggregate HBM scale with
    # tp, weights/outputs shard, and every call pays a ring all-reduce of
    # its partial outputs over the inter-chip link (the interconnect term)
    pes = n_pes(hw)
    peak = 2.0 * pes * tgt.freq_hz * hw.tp
    eff = 1.0
    if tgt.mxu_aligned:
        eff *= _mxu_eff(hw.pe_rows, 8) * _mxu_eff(hw.pe_cols, 128)
        if hw.intrinsic in ("GEMV", "DOT"):
            eff *= 0.5  # rank-deficient MXU issue
    # dataflow consistency (paper: order must match the accelerator dataflow)
    stationary = {"OS": "__out__", "WS": list(tensors)[-1],
                  "IS": list(tensors)[0]}[hw.dataflow]
    innermost = order[-1] if order else all_loops[-1]
    idx_of = {t: {i for dim in dims for i in dim} for t, dims in tensors.items()}
    idx_of["__out__"] = set(workload.out_indices)
    if innermost in idx_of.get(stationary, set()):
        eff *= 0.85  # stationary operand thrashes: pipeline drain per call
    flops_call = 2.0
    for c in mapped.values():
        flops_call *= ptile[c]
    # unmapped loops run outside the intrinsic — one call covers mapped dims
    total_flops = flops_call * calls
    compute_s = total_flops / (peak * max(eff, 1e-6)) + tgt.startup_s * calls

    # --- memory traffic with loop-order reuse ----------------------------------
    pos = {l: k for k, l in enumerate(order)}

    def fetches(index_set: set[str]) -> int:
        inner = max((pos[l] for l in order if l in index_set), default=-1)
        f = 1
        for l in order[: inner + 1]:
            f *= trips[l]
        return f

    hbm_bytes = 0.0
    mem_s = 0.0
    bw = tgt.hbm_gbps * 1e9 * hw.tp
    for tname in tensors:
        n_fetch = fetches(idx_of[tname])
        burst = min(hw.burst_bytes, contig[tname])
        dma_eff = burst / (burst + tgt.dma_overhead_bytes)
        tb = n_fetch * foot[tname]
        hbm_bytes += tb
        mem_s += tb / (bw * dma_eff)
    # output: revisit when a reduced loop is outer to the O-resident span
    p_out = max((pos[l] for l in order if l in idx_of["__out__"]), default=-1)
    revisit = any(l in workload.reduced for l in order[: p_out + 1]
                  if l not in idx_of["__out__"])
    n_out = fetches(idx_of["__out__"])
    out_total = n_out * out_bytes * (2 if revisit else 1)
    burst = min(hw.burst_bytes, out_contig)
    dma_eff = burst / (burst + tgt.dma_overhead_bytes)
    hbm_bytes += out_total
    mem_s += out_total / (bw * dma_eff)

    # --- combine ----------------------------------------------------------------
    if hw.banks >= 2:
        latency = max(compute_s, mem_s) + min(compute_s, mem_s) / max(calls, 1)
    else:
        latency = compute_s + mem_s

    # --- interconnect (tensor parallelism) ----------------------------------
    # ring all-reduce of each call's partial outputs: 2(t-1)/t of the output
    # bytes cross every chip's link; exactly zero at tp=1
    ic_bytes = calls * out_bytes * (2.0 * (hw.tp - 1) / hw.tp)
    latency += ic_bytes / (tgt.link_gbps * 1e9)

    # --- energy / power / area ---------------------------------------------------
    macs = total_flops / 2.0
    sram_bytes = 3.0 * macs * DTYPE_BYTES / max(1, min(hw.pe_rows, 128))
    area = accelerator_area(hw, tgt)
    area_norm = ((tgt.a_pe_um2 * pes) / (tgt.a_pe_um2 * 4096)
                 + (hw.vmem_bytes * tgt.a_mem_um2_b)
                 / (16384 * 1024 * tgt.a_mem_um2_b)) * hw.tp
    energy = (macs * tgt.e_mac_pj + sram_bytes * tgt.e_sram_pj_b
              + hbm_bytes * tgt.e_dram_pj_b
              + ic_bytes * tgt.e_dram_pj_b) * 1e-12 \
        + tgt.static_w_per_norm * area_norm * latency
    power = energy / max(latency, 1e-12)

    return CostReport(latency, energy, power, area, total_flops,
                      float(workload.flops()), hbm_bytes, compute_s, mem_s,
                      calls, int(working), True)


# ---------------------------------------------------------------------------
# Batched evaluation (DESIGN.md §4.3): the DSE hot path
# ---------------------------------------------------------------------------


class EvalCache:
    """Keyed memo of full CostReports over (workload, schedule, hw, target).

    One cache instance is threaded through a whole co-design run (Step 2's
    hardware DSE, its inner software DSE, and Step 3's refinement), so any
    (hw, schedule) pair probed twice — across MOBO iterations, across
    explorers, across budget tiers — is evaluated once.
    """

    def __init__(self, maxsize: int = 1 << 20):
        self._data: dict = {}
        self._maxsize = maxsize
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._data)

    def key(self, workload: TensorExpr, schedule: Schedule, hw: HWConfig,
            tgt: Target) -> tuple:
        return (_fingerprint(workload), tgt.name, hw.encode(), schedule)

    def get(self, key: tuple) -> CostReport | None:
        rep = self._data.get(key)
        if rep is None:
            self.misses += 1
        else:
            self.hits += 1
        return rep

    def put(self, key: tuple, rep: CostReport) -> None:
        if len(self._data) < self._maxsize:
            self._data[key] = rep

    @property
    def hit_rate(self) -> float:
        """Fraction of lookups served from the cache (0.0 when untouched)."""
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def stats(self) -> dict:
        return {"entries": len(self._data), "hits": self.hits,
                "misses": self.misses, "hit_rate": self.hit_rate}


def _fingerprint(workload: TensorExpr) -> tuple:
    """Stable identity of a workload for cache/prep keys (TensorExpr is a
    mutable dataclass, so it cannot key a dict itself)."""
    fp = getattr(workload, "_cm_fingerprint", None)
    if fp is None:
        fp = (workload.name, workload.output, tuple(workload.out_indices),
              tuple(sorted(workload.extents.items())), repr(workload.body))
        workload._cm_fingerprint = fp
    return fp


class _Prep:
    """Static per-workload metadata for the batched path.

    Everything that does NOT vary across candidates — loop lists, tensor
    index structure, stationarity membership masks — is derived once here;
    per-candidate state reduces to integer arrays over these.  Per
    tensorize-choice metadata (which loops the intrinsic covers and which
    hardware knob sizes each block dim) is cached in :meth:`choice_meta`, so
    one vectorized pass handles a population that mixes tensorize choices:
    an *unmapped* loop is exactly a mapped loop with tile = block = 1 (its
    trip count is the full extent and it contributes nothing to padding or
    per-call flops), which lets every candidate share full-width arrays.
    """

    __slots__ = ("loops", "loop_id", "loop_set", "ext", "tensor_names",
                 "tensor_dims", "tensor_masks", "out_ids", "out_mask",
                 "out_last_id", "red_not_out", "df_masks", "n_loops",
                 "useful_flops", "_choice_meta")

    def __init__(self, workload: TensorExpr):
        self.loops = list(workload.all_indices())
        self.n_loops = len(self.loops)
        self.loop_id = {l: k for k, l in enumerate(self.loops)}
        self.loop_set = frozenset(self.loops)
        self.ext = np.array([workload.extents[l] for l in self.loops],
                            dtype=np.int64)
        self._choice_meta: dict[int, tuple] = {}

        tensors = workload.tensors()
        self.tensor_names = list(tensors)
        self.tensor_dims = [tuple(tuple(self.loop_id[i] for i in dim)
                                  for dim in dims)
                            for dims in tensors.values()]
        self.tensor_masks = []
        for dims in tensors.values():
            m = np.zeros(self.n_loops, dtype=bool)
            for dim in dims:
                for i in dim:
                    m[self.loop_id[i]] = True
            self.tensor_masks.append(m)

        self.out_ids = [self.loop_id[i] for i in workload.out_indices
                        if i in self.loop_id]
        self.out_mask = np.zeros(self.n_loops, dtype=bool)
        self.out_mask[self.out_ids] = True
        last = workload.out_indices[-1]
        self.out_last_id = self.loop_id.get(last, -1)
        self.red_not_out = np.array(
            [l in workload.reduced and not self.out_mask[k]
             for k, l in enumerate(self.loops)], dtype=bool)

        # stationary-operand membership by dataflow code (OS=0, WS=1, IS=2)
        self.df_masks = np.stack([
            self.out_mask,
            self.tensor_masks[-1],
            self.tensor_masks[0],
        ])
        self.useful_flops = float(workload.flops())

    def choice_meta(self, choice: TensorizeChoice) -> tuple:
        """(intrinsic, icode, tile_sig, cols_list, cols_np, srcs) for one
        tensorize choice; keyed by object identity (the stored reference
        pins the id).  ``tile_sig`` is the sorted mapped-loop-name tuple —
        the order Schedule.tiles uses — and ``cols_*`` are the loop columns
        each sorted slot scatters into.  ``srcs`` names the hardware knob
        (or fixed constant) sizing each slot's intrinsic block dim."""
        meta = self._choice_meta.get(id(choice))
        if meta is None:
            from .intrinsics import BINDINGS

            binding = BINDINGS[choice.intrinsic_name]
            knobs = dict(binding.shape_knobs)
            fixed = dict(binding.fixed_dims)
            src_of = {}
            for q, c in choice.index_map:
                src_of[c] = (("const", fixed[q]) if q in fixed
                             else ("knob", knobs[q]))
            tile_sig = tuple(sorted(src_of))
            cols_list = [self.loop_id[c] for c in tile_sig]
            icode = {"GEMV": 1, "DOT": 2}.get(choice.intrinsic_name, 0)
            meta = (choice, choice.intrinsic_name, icode, tile_sig,
                    cols_list, np.array(cols_list, dtype=np.int64),
                    [src_of[c] for c in tile_sig])
            self._choice_meta[id(choice)] = meta
        return meta


_PREP_CACHE: dict[tuple, _Prep] = {}
_DF_CODE = {"OS": 0, "WS": 1, "IS": 2}


def _get_prep(workload: TensorExpr) -> _Prep:
    key = _fingerprint(workload)
    prep = _PREP_CACHE.get(key)
    if prep is None:
        prep = _Prep(workload)
        if len(_PREP_CACHE) < 4096:
            _PREP_CACHE[key] = prep
    return prep


def _order_perm_row(prep: _Prep, order: tuple[str, ...]) -> np.ndarray:
    """Robust (slow-path) order row: positions for known loops in first-seen
    order, unknown loops dropped, missing loops appended in source order —
    matching the scalar path's robustness append."""
    L = prep.n_loops
    prow = np.full(L, -1, dtype=np.int64)
    p = 0
    for l in order:
        i = prep.loop_id.get(l)
        if i is not None and prow[i] < 0:
            prow[i] = p
            p += 1
    for i in range(L):
        if prow[i] < 0:
            prow[i] = p
            p += 1
    return np.argsort(prow).astype(np.int64)


def _assemble(prep: _Prep, schedules: Sequence[Schedule],
              hws: Sequence[HWConfig], single_hw: bool) -> tuple:
    """Structure-of-arrays candidate state, full loop width:

      tiles/block (n, L) — interface tile and intrinsic block per loop,
        1 on loops a candidate's tensorize choice leaves unmapped;
      perm/pos (n, L)    — loop order as permutation indices + inverse;
      icode (n,)         — intrinsic family (0 GEMM/CONV2D, 1 GEMV, 2 DOT);
      mismatch (n,)      — choice intrinsic != hw intrinsic (illegal).

    The common case (tiles sorted over exactly the mapped loops, order a
    permutation of all loops) is assembled with a tight loop; irregular
    schedules fall back to the robust path per row.
    """
    n = len(schedules)
    L = prep.n_loops
    loop_id = prep.loop_id
    tiles = np.ones((n, L), dtype=np.int64)
    block = np.ones((n, L), dtype=np.int64)
    perm = np.empty((n, L), dtype=np.int64)
    icode = np.empty(n, dtype=np.int64)
    mismatch = np.zeros(n, dtype=bool)
    order_rows: dict[tuple, np.ndarray] = {}
    block_rows: dict[int, np.ndarray] = {}
    hw0 = hws[0] if hws else None
    for r, s in enumerate(schedules):
        choice = s.choice
        _, intr, ic, tile_sig, cols_list, cols_np, srcs = \
            prep.choice_meta(choice)
        h = hw0 if single_hw else hws[r]
        icode[r] = ic
        if h.intrinsic != intr:
            mismatch[r] = True
        st = s.tiles
        M = len(tile_sig)
        ok = len(st) == M
        if ok:
            trow = tiles[r]
            for j in range(M):
                lname, v = st[j]
                if lname != tile_sig[j]:
                    ok = False
                    break
                trow[cols_list[j]] = v
        if not ok:  # irregular tile tuple: robust per-row path
            tm = s.tile_map
            trow = tiles[r]
            trow[:] = 1
            for j, lname in enumerate(tile_sig):
                trow[cols_list[j]] = tm.get(lname, prep.ext[cols_list[j]])
        if single_hw:
            vals = block_rows.get(id(choice))
            if vals is None:
                vals = np.array([v if kind == "const" else getattr(h, v)
                                 for kind, v in srcs], dtype=np.int64)
                block_rows[id(choice)] = vals
            block[r, cols_np] = vals
        else:
            brow = block[r]
            for j, (kind, v) in enumerate(srcs):
                brow[cols_list[j]] = v if kind == "const" else getattr(h, v)
        o = s.order
        row_o = order_rows.get(o)
        if row_o is None:
            if len(o) == L and prep.loop_set.issuperset(o) and len(set(o)) == L:
                row_o = np.fromiter((loop_id[l] for l in o), np.int64, L)
            else:
                row_o = _order_perm_row(prep, o)
            order_rows[o] = row_o
        perm[r] = row_o
    pos = np.empty((n, L), dtype=np.int64)
    np.put_along_axis(pos, perm,
                      np.broadcast_to(np.arange(L, dtype=np.int64), (n, L)),
                      axis=1)
    return tiles, block, perm, pos, icode, mismatch


def _batch_group(prep: _Prep, tgt: Target, hws: Sequence[HWConfig],
                 schedules: Sequence[Schedule]) -> dict[str, np.ndarray]:
    """Vectorized cost model over N candidates of one workload (tensorize
    choices may differ per candidate).

    Mirrors ``_evaluate_reference`` formula-for-formula; returns all
    CostReport fields as (N,) arrays.
    """
    n = len(schedules)
    L = prep.n_loops

    # --- structure-of-arrays candidate state --------------------------------
    single_hw = all(h is hws[0] for h in hws)
    def hw_arr(attr):
        if single_hw:
            return np.full(n, getattr(hws[0], attr))
        return np.array([getattr(h, attr) for h in hws])

    pe_rows = hw_arr("pe_rows").astype(np.int64)
    pe_cols = hw_arr("pe_cols").astype(np.int64)
    pe_depth = hw_arr("pe_depth").astype(np.int64)
    vmem = hw_arr("vmem_kib").astype(np.int64) * 1024
    banks = hw_arr("banks").astype(np.int64)
    local_kib = hw_arr("local_accum_kib").astype(np.int64)
    burst_cap = hw_arr("burst_bytes").astype(np.int64)
    tp = hw_arr("tp").astype(np.int64)
    if single_hw:
        df_code = np.full(n, _DF_CODE[hws[0].dataflow], dtype=np.int64)
    else:
        df_code = np.array([_DF_CODE[h.dataflow] for h in hws], dtype=np.int64)

    tiles, block, perm, pos, icode, mismatch = \
        _assemble(prep, schedules, hws, single_hw)

    # --- interface tile per mapped loop, padded to the intrinsic block ------
    # (full loop width: unmapped loops carry tile = block = 1, so they pad
    # nothing and their trip count below is the full extent)
    t = np.clip(tiles, 1, prep.ext[None, :])
    pt = -(-t // block) * block
    align_eff = np.prod(t / pt, axis=1)

    # --- outer software loops (logical-tile trip counts) --------------------
    trips = (-(-prep.ext[None, :] // t)).astype(np.float64)
    calls = np.prod(trips, axis=1)
    ptile = pt

    # --- per-call footprints (bytes) ----------------------------------------
    foot = []
    contig = []
    for dims in prep.tensor_dims:
        sz = np.ones(n, dtype=np.int64)
        for dim in dims:
            contrib = ptile[:, list(dim)].sum(axis=1) - (len(dim) - 1)
            sz *= np.maximum(1, contrib)
        foot.append(sz * DTYPE_BYTES)
        last = dims[-1]
        contig.append(np.maximum(
            1, ptile[:, list(last)].sum(axis=1) - (len(last) - 1))
            * DTYPE_BYTES)
    if prep.out_ids:
        out_foot = np.prod(ptile[:, prep.out_ids], axis=1)
    else:
        out_foot = np.ones(n, dtype=np.int64)
    out_bytes = out_foot * ACC_BYTES
    out_contig = (ptile[:, prep.out_last_id] if prep.out_last_id >= 0
                  else np.ones(n, dtype=np.int64)) * ACC_BYTES

    # --- scratchpad legality ------------------------------------------------
    buffered = np.where(banks >= 2, 2, 1)
    local = local_kib * 1024
    out_in_vmem = np.where(out_bytes > local, out_bytes, 0)
    working = sum(foot) * buffered + out_in_vmem
    overflow = working > vmem

    # --- compute time -------------------------------------------------------
    pes = np.where(icode == 0, pe_rows * pe_cols,
                   np.where(icode == 1, pe_rows * np.minimum(pe_depth, 128),
                            np.minimum(pe_depth, 4096)))
    peak = 2.0 * pes * tgt.freq_hz * tp
    eff = np.ones(n)
    if tgt.mxu_aligned:
        eff = (pe_rows / (-(-pe_rows // 8) * 8)
               * (pe_cols / (-(-pe_cols // 128) * 128)))
        eff = np.where(icode >= 1, eff * 0.5, eff)  # GEMV/DOT: rank-deficient
    # dataflow consistency: stationary operand indexed by the innermost loop
    innermost = perm[:, L - 1]
    thrash = prep.df_masks[df_code, innermost]
    eff = np.where(thrash, eff * 0.85, eff)
    flops_call = 2.0 * np.prod(pt.astype(np.float64), axis=1)
    total_flops = flops_call * calls
    compute_s = (total_flops / (peak * np.maximum(eff, 1e-6))
                 + tgt.startup_s * calls)

    # --- memory traffic with loop-order reuse -------------------------------
    rows = np.arange(n)
    trips_in_order = np.take_along_axis(trips, perm, axis=1)
    cp = np.cumprod(trips_in_order, axis=1)              # prefix trip products

    def fetches(mask: np.ndarray) -> np.ndarray:
        ids = np.flatnonzero(mask)
        if len(ids) == 0:
            return np.ones(n)
        inner = pos[:, ids].max(axis=1)
        return cp[rows, inner]

    hbm_bytes = np.zeros(n)
    mem_s = np.zeros(n)
    bw = tgt.hbm_gbps * 1e9 * tp
    for mask, ft, cg in zip(prep.tensor_masks, foot, contig):
        n_fetch = fetches(mask)
        burst = np.minimum(burst_cap, cg)
        dma_eff = burst / (burst + tgt.dma_overhead_bytes)
        tb = n_fetch * ft
        hbm_bytes += tb
        mem_s += tb / (bw * dma_eff)
    # output: revisit when a reduced loop is outer to the O-resident span
    if prep.out_ids:
        p_out = pos[:, prep.out_ids].max(axis=1)
        n_out = cp[rows, p_out]
        reduced_outer = np.cumsum(prep.red_not_out[perm], axis=1)
        revisit = reduced_outer[rows, p_out] > 0
    else:
        n_out = np.ones(n)
        revisit = np.zeros(n, dtype=bool)
    out_total = n_out * out_bytes * np.where(revisit, 2, 1)
    burst = np.minimum(burst_cap, out_contig)
    dma_eff = burst / (burst + tgt.dma_overhead_bytes)
    hbm_bytes = hbm_bytes + out_total
    mem_s = mem_s + out_total / (bw * dma_eff)

    # --- combine ------------------------------------------------------------
    overlap = (np.maximum(compute_s, mem_s)
               + np.minimum(compute_s, mem_s) / np.maximum(calls, 1))
    latency = np.where(banks >= 2, overlap, compute_s + mem_s)

    # --- interconnect (tensor parallelism): per-call output all-reduce ------
    ic_bytes = calls * out_bytes * (2.0 * (tp - 1) / tp)
    latency = latency + ic_bytes / (tgt.link_gbps * 1e9)

    # --- energy / power / area ----------------------------------------------
    macs = total_flops / 2.0
    sram_bytes = (3.0 * macs * DTYPE_BYTES
                  / np.maximum(1, np.minimum(pe_rows, 128)))
    mem_bytes_cfg = vmem + local_kib * 1024
    area = (tgt.a_pe_um2 * pes
            + tgt.a_mem_um2_b * mem_bytes_cfg
            * (1.0 + 0.05 * (banks - 1))) * tp
    area_norm = ((tgt.a_pe_um2 * pes) / (tgt.a_pe_um2 * 4096)
                 + (vmem * tgt.a_mem_um2_b)
                 / (16384 * 1024 * tgt.a_mem_um2_b)) * tp
    energy = ((macs * tgt.e_mac_pj + sram_bytes * tgt.e_sram_pj_b
               + hbm_bytes * tgt.e_dram_pj_b
               + ic_bytes * tgt.e_dram_pj_b) * 1e-12
              + tgt.static_w_per_norm * area_norm * latency)
    power = energy / np.maximum(latency, 1e-12)

    # --- legality overlays --------------------------------------------------
    legal = ~(mismatch | overflow | (align_eff <= 0))
    bad = overflow & ~mismatch
    for arr in (latency, energy, power, compute_s, mem_s):
        arr[bad] = math.inf
    for arr in (total_flops, hbm_bytes):
        arr[bad] = 0.0
    if mismatch.any() or (align_eff <= 0).any():
        dead = mismatch | (align_eff <= 0)
        for arr in (latency, energy, power, area, compute_s, mem_s):
            arr[dead] = math.inf
        for arr in (total_flops, hbm_bytes, calls, working):
            arr[dead] = 0

    return {"latency_s": latency, "energy_j": energy, "power_w": power,
            "area_um2": area, "flops": total_flops, "hbm_bytes": hbm_bytes,
            "compute_s": compute_s, "memory_s": mem_s, "calls": calls,
            "vmem_bytes": working, "legal": legal, "overflow": bad,
            "vmem_cap": vmem}


def _reports(prep: _Prep, out: dict[str, np.ndarray]) -> list[CostReport]:
    """Every CostReport row of the batch arrays.  Each column is read back
    as Python numbers once (``tolist`` gives each element's ``float()`` /
    ``int()`` / ``bool()``), not element by element."""
    c = {key: col.tolist() for key, col in out.items()}
    reps = []
    for i, legal in enumerate(c["legal"]):
        if not legal and not math.isfinite(c["area_um2"][i]):
            reps.append(ILLEGAL)
            continue
        why = ""
        if c["overflow"][i]:
            why = (f"working set {int(c['vmem_bytes'][i])}B "
                   f"> vmem {int(c['vmem_cap'][i])}B")
        reps.append(CostReport(
            c["latency_s"][i], c["energy_j"][i], c["power_w"][i],
            c["area_um2"][i], c["flops"][i],
            prep.useful_flops if legal else 0.0, c["hbm_bytes"][i],
            c["compute_s"][i], c["memory_s"][i], int(c["calls"][i]),
            int(c["vmem_bytes"][i]), legal, why))
    return reps


def _broadcast_hws(hw_configs, n: int) -> list[HWConfig]:
    if isinstance(hw_configs, HWConfig):
        return [hw_configs] * n
    hws = list(hw_configs)
    if len(hws) == 1 and n > 1:
        return hws * n
    if len(hws) != n:
        raise ValueError(f"{len(hws)} hw configs for {n} schedules")
    return hws


def evaluate_batch(workload: TensorExpr,
                   hw_configs: HWConfig | Sequence[HWConfig],
                   schedules: Sequence[Schedule],
                   target: Target | str = "spatial",
                   cache: EvalCache | None = None) -> np.ndarray:
    """Score N candidate (hw, schedule) pairs in one vectorized pass.

    Returns an (N, 3) float array of minimized objectives
    (latency_s, power_w, area_um2) — the paper's Table II axes.  Rows of an
    illegal candidate are +inf in latency/power (area stays finite for a
    scratchpad overflow, matching the scalar path).  ``hw_configs`` may be a
    single config (broadcast over all schedules) or one per schedule.  With
    ``cache``, previously seen candidates are served from the memo and new
    ones are added to it.
    """
    schedules = list(schedules)
    n = len(schedules)
    if n == 0:
        return np.empty((0, 3))
    tgt = TARGETS[target] if isinstance(target, str) else target
    hws = _broadcast_hws(hw_configs, n)

    if cache is not None:
        reports = evaluate_batch_reports(workload, hws, schedules, tgt, cache)
        ys = np.empty((n, 3))
        for i, rep in enumerate(reports):
            ys[i] = rep.objectives
        return ys

    # cache-free fast path: arrays only, no CostReport materialization
    prep = _get_prep(workload)
    out = _batch_group(prep, tgt, hws, schedules)
    return np.stack([out["latency_s"], out["power_w"], out["area_um2"]],
                    axis=1)


def evaluate_batch_reports(workload: TensorExpr,
                           hw_configs: HWConfig | Sequence[HWConfig],
                           schedules: Sequence[Schedule],
                           target: Target | str = "spatial",
                           cache: EvalCache | None = None) -> list[CostReport]:
    """Like :func:`evaluate_batch` but returns full CostReports."""
    schedules = list(schedules)
    n = len(schedules)
    tgt = TARGETS[target] if isinstance(target, str) else target
    hws = _broadcast_hws(hw_configs, n)

    reports: list[CostReport | None] = [None] * n
    keys: list[tuple | None] = [None] * n
    todo: list[int] = []
    if cache is not None:
        for i in range(n):
            keys[i] = cache.key(workload, schedules[i], hws[i], tgt)
            reports[i] = cache.get(keys[i])
            if reports[i] is None:
                todo.append(i)
    else:
        todo = list(range(n))

    if todo:
        prep = _get_prep(workload)
        out = _batch_group(prep, tgt, [hws[i] for i in todo],
                           [schedules[i] for i in todo])
        for i, rep in zip(todo, _reports(prep, out)):
            reports[i] = rep
            if cache is not None:
                cache.put(keys[i], rep)
    return reports  # type: ignore[return-value]


def evaluate(workload: TensorExpr, schedule: Schedule, hw: HWConfig,
             target: Target | str = "spatial",
             cache: EvalCache | None = None) -> CostReport:
    """Latency/power/area of running ``workload`` with ``schedule`` on ``hw``.

    Thin memo-aware wrapper over the scalar core: a cache hit (including one
    populated by :func:`evaluate_batch`) is free; a miss computes one
    CostReport and stores it.  Agrees elementwise with ``evaluate_batch``
    (asserted by tests/test_batched_eval.py).
    """
    if cache is None:
        return _evaluate_reference(workload, schedule, hw, target)
    tgt = TARGETS[target] if isinstance(target, str) else target
    key = cache.key(workload, schedule, hw, tgt)
    rep = cache.get(key)
    if rep is None:
        rep = _evaluate_reference(workload, schedule, hw, tgt)
        cache.put(key, rep)
    return rep
