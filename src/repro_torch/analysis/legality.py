"""Static legality verifier for (HWConfig, Schedule, TensorizeChoice)
triples (DESIGN.md §16.2).

Re-checks, *without* evaluating or lowering anything, every constraint the
runtime pipeline enforces dynamically:

  * ``cost_model._evaluate_reference`` — intrinsic agreement and the
    scratchpad working-set bound.  The formulas here are mirrored line for
    line (tile clamp, block padding, per-tensor footprints, the
    double-buffer factor, the local-accumulator carve-out), so an
    error-severity ``legality/*`` finding implies the cost model returns
    ILLEGAL for the same triple and vice versa — the zero-false-positive
    contract ``tests/test_analysis_legality.py`` asserts on random
    populations.
  * ``hw_space.HWSpace.legal`` — the hardware point itself must live inside
    the legal design space (minimal intrinsic tile fits VMEM, the PE-local
    accumulator does not eat the scratchpad).
  * ``matching`` rule ②'' and the accumulation flag — a choice whose
    index map sends an intrinsic-reduced index to a compute-free index has
    summed away data the workload still needs; a mis-set accumulation flag
    silently drops partial sums.
  * ``tuner.measure`` — the padded block-volume cap a lowering would trip
    (reported as a warning: the measurement layer owns that failure mode
    and its ValueError capture is load-bearing for the tuning DB).

Pure ``core``-level module: no jax, importable from the tuner's measurement
hot path at zero cost.
"""
from __future__ import annotations

from repro_torch.core.hw_primitives import HWConfig
from repro_torch.core.hw_space import AXES, PARALLELISM_AXES, HWSpace
from repro_torch.core.intrinsics import ALL_INTRINSICS, BINDINGS
from repro_torch.core.sw_primitives import Schedule
from repro_torch.core.tst import TensorExpr

from .findings import Finding, errors, rule

DTYPE_BYTES = 2   # bf16 operands   (cost_model.DTYPE_BYTES)
ACC_BYTES = 4     # f32 accumulator (cost_model.ACC_BYTES)

R_INTRINSIC_MISMATCH = rule(
    "legality/intrinsic-mismatch",
    "schedule's tensorize choice targets a different intrinsic than the "
    "hardware point implements")
R_UNKNOWN_INTRINSIC = rule(
    "legality/unknown-intrinsic",
    "hardware intrinsic has no binding/TST (not one of DOT/GEMV/GEMM/CONV2D)")
R_WORKLOAD_MISMATCH = rule(
    "legality/choice-workload-mismatch",
    "tensorize choice was matched against a different workload")
R_UNKNOWN_LOOP = rule(
    "legality/unknown-loop",
    "index map references a loop the workload does not have")
R_UNBOUND_INDEX = rule(
    "legality/unbound-intrinsic-index",
    "index map references an intrinsic index the binding does not size")
R_REDUCTION_UNSOUND = rule(
    "legality/reduction-unsound",
    "intrinsic-reduced index mapped to a compute-free index (matching ②''): "
    "the intrinsic sums away data the workload still needs")
R_ACCUM_FLAG = rule(
    "legality/accumulation-flag",
    "choice.accumulation disagrees with the matching rules: partial sums "
    "would be dropped (or spuriously accumulated) at runtime")
R_VMEM_OVERFLOW = rule(
    "legality/vmem-overflow",
    "per-call working set (double-buffered operand tiles + accumulator "
    "spill) exceeds the configured VMEM budget")
R_MIN_TILE = rule(
    "legality/min-tile-overflow",
    "hardware point is outside the legal design space: one minimal "
    "intrinsic tile cannot fit its own VMEM (hw_space.legal)")
R_LOCAL_ACCUM = rule(
    "legality/local-accum-oversized",
    "hardware point is outside the legal design space: the PE-local "
    "accumulator claims more than a quarter of VMEM (hw_space.legal)")
R_TILE_CLAMPED = rule(
    "legality/tile-clamped",
    "schedule tile is non-positive or exceeds the loop extent; the "
    "evaluator clamps it, so the stated tile is not what runs")
R_TILE_MISALIGNED = rule(
    "legality/tile-misaligned",
    "interface tile is not a multiple of the intrinsic block: the padded "
    "call wastes the stated fraction of its compute")
R_TILE_UNMAPPED = rule(
    "legality/tile-unmapped-loop",
    "schedule carries a split factor for a loop the tensorize choice does "
    "not map (ignored by the interface, but it still inflates the padded "
    "block volume a lowering would allocate)")
R_KNOB_RANGE = rule(
    "legality/knob-out-of-range",
    "hardware knob value is not an ordinal of the design-space axis "
    "(hw_space.AXES): no DSE flow can have produced this point")
R_KNOB_POW2 = rule(
    "legality/knob-not-pow2",
    "PE-array knob is not a power of two: MXU block mapping pads it")
R_BLOCK_VOLUME = rule(
    "legality/block-volume",
    "padded tile volume exceeds the measurement layer's max_block_elems "
    "cap: lowering this candidate would be refused")

_POW2_KNOBS = ("pe_rows", "pe_cols", "pe_depth")


def _is_pow2(v: int) -> bool:
    return v > 0 and (v & (v - 1)) == 0


def verify_hw(hw: HWConfig, *, site: str | None = None) -> list[Finding]:
    """Design-space legality of a hardware point alone."""
    site = site or f"hw[{hw.intrinsic}]"
    out: list[Finding] = []
    if hw.intrinsic not in BINDINGS:
        out.append(Finding("error", R_UNKNOWN_INTRINSIC, site,
                           f"intrinsic {hw.intrinsic!r} has no binding"))
        return out
    for name, values in AXES.items():
        v = getattr(hw, name)
        if v not in values:
            out.append(Finding("warning", R_KNOB_RANGE, site,
                               f"{name}={v} is not an ordinal of "
                               f"hw_space.AXES[{name!r}]"))
    if hw.tp not in PARALLELISM_AXES["tp"]:
        out.append(Finding("warning", R_KNOB_RANGE, site,
                           f"tp={hw.tp} is not an ordinal of "
                           f"PARALLELISM_AXES['tp']"))
    for name in _POW2_KNOBS:
        v = getattr(hw, name)
        if not _is_pow2(v):
            out.append(Finding("warning", R_KNOB_POW2, site,
                               f"{name}={v} is not a power of two"))
    # hw_space.HWSpace.legal, split into its two constituent rules
    space = HWSpace(hw.intrinsic)
    if hw.local_accum_kib * 1024 > hw.vmem_bytes // 4:
        out.append(Finding("error", R_LOCAL_ACCUM, site,
                           f"local_accum {hw.local_accum_kib}KiB > "
                           f"vmem/4 ({hw.vmem_bytes // 4}B)"))
    elif not space.legal(hw):
        out.append(Finding("error", R_MIN_TILE, site,
                           f"one minimal {hw.intrinsic} tile (double-"
                           f"buffered) exceeds vmem {hw.vmem_bytes}B"))
    return out


def _expected_accumulation(choice, workload: TensorExpr) -> bool:
    """Mirror of matching._emit's accumulation rule."""
    intr = ALL_INTRINSICS[choice.intrinsic_name]
    sigma = dict(choice.index_map)
    software = [i for i in workload.all_indices() if i not in sigma.values()]
    return any(i in workload.reduced for i in software) or any(
        ci in workload.reduced and qi not in intr.reduced
        for qi, ci in sigma.items())


def verify_candidate(workload: TensorExpr, schedule: Schedule, hw: HWConfig,
                     *, max_block_elems: int | None = 1 << 24,
                     site: str | None = None) -> list[Finding]:
    """Full static legality of one (workload, schedule, hw) triple.

    Error-severity findings are exactly the candidates the dynamic pipeline
    would reject (cost model ILLEGAL, design-space-illegal hardware, or a
    semantically broken choice); :func:`is_legal` folds them to a bool.
    """
    choice = schedule.choice
    site = site or (f"{workload.name}|{hw.intrinsic}|{schedule.describe()}")
    out: list[Finding] = list(verify_hw(hw, site=site))
    if any(f.rule == R_UNKNOWN_INTRINSIC for f in out):
        return out

    if choice.workload_name != workload.name:
        out.append(Finding("error", R_WORKLOAD_MISMATCH, site,
                           f"choice was matched against "
                           f"{choice.workload_name!r}, verifying against "
                           f"{workload.name!r}"))
        return out
    if choice.intrinsic_name != hw.intrinsic:
        # cost_model._evaluate_reference returns ILLEGAL outright here
        out.append(Finding("error", R_INTRINSIC_MISMATCH, site,
                           f"choice targets {choice.intrinsic_name}, "
                           f"hw implements {hw.intrinsic}"))
        return out

    ext = workload.extents
    block = hw.intrinsic_dims()
    mapped = dict(choice.index_map)
    bad_map = False
    for q, c in mapped.items():
        if c not in ext:
            out.append(Finding("error", R_UNKNOWN_LOOP, site,
                               f"index map sends {q!r} to unknown loop "
                               f"{c!r}"))
            bad_map = True
        if q not in block:
            out.append(Finding("error", R_UNBOUND_INDEX, site,
                               f"intrinsic index {q!r} is not sized by the "
                               f"{hw.intrinsic} binding"))
            bad_map = True
    if bad_map:
        return out

    # -- matching soundness (②'' + the accumulation flag) --------------------
    intr = ALL_INTRINSICS[choice.intrinsic_name]
    for q, c in mapped.items():
        if q in intr.reduced and c not in workload.reduced:
            out.append(Finding("error", R_REDUCTION_UNSOUND, site,
                               f"intrinsic-reduced {q!r} maps to compute-"
                               f"free {c!r} (matching ②'')"))
    want_accum = _expected_accumulation(choice, workload)
    if choice.accumulation != want_accum:
        out.append(Finding("error", R_ACCUM_FLAG, site,
                           f"accumulation={choice.accumulation} but the "
                           f"matching rules require {want_accum}"))

    # -- tiles: clamp, block padding, stray splits ---------------------------
    tiles = schedule.tile_map
    ptile: dict[str, int] = {}
    for q, c in mapped.items():
        raw = tiles.get(c, ext[c])
        t = max(1, min(raw, ext[c]))
        if raw != t:
            out.append(Finding("warning", R_TILE_CLAMPED, site,
                               f"tile {c}={raw} clamped to {t} "
                               f"(extent {ext[c]})"))
        b = max(1, block[q])
        pt = -(-t // b) * b
        ptile[c] = pt
        if pt != t:
            out.append(Finding(
                "warning", R_TILE_MISALIGNED, site,
                f"tile {c}={t} pads to {pt} (block {q}={b}): "
                f"{100.0 * (1.0 - t / pt):.0f}% of each call is padding"))
    for loop in tiles:
        if loop not in mapped.values():
            out.append(Finding("warning", R_TILE_UNMAPPED, site,
                               f"split factor for unmapped loop {loop!r} "
                               f"is ignored by the interface"))

    # -- scratchpad working set (cost_model._evaluate_reference, verbatim) ---
    foot_total = 0
    for _, dims in workload.tensors().items():
        sz = 1
        for dim in dims:
            contrib = sum(ptile.get(i, 1) for i in dim) - (len(dim) - 1)
            sz *= max(1, contrib)
        foot_total += sz * DTYPE_BYTES
    out_foot = 1
    for i in workload.out_indices:
        out_foot *= ptile.get(i, 1)
    out_bytes = out_foot * ACC_BYTES
    buffered = 2 if hw.banks >= 2 else 1
    local = hw.local_accum_kib * 1024
    out_in_vmem = out_bytes if out_bytes > local else 0
    working = foot_total * buffered + out_in_vmem
    if working > hw.vmem_bytes:
        out.append(Finding("error", R_VMEM_OVERFLOW, site,
                           f"working set {working}B > vmem "
                           f"{hw.vmem_bytes}B"))

    # -- measurement block-volume cap (tuner.measure.padded_tiles/lower) -----
    if max_block_elems is not None:
        vol = 1
        for loop in workload.all_indices():
            if loop in ptile:
                vol *= ptile[loop]
            else:
                vol *= max(1, min(tiles.get(loop, ext[loop]), ext[loop]))
        if vol > max_block_elems:
            out.append(Finding("warning", R_BLOCK_VOLUME, site,
                               f"padded tile volume {vol} exceeds "
                               f"max_block_elems={max_block_elems}"))
    return out


def is_legal(workload: TensorExpr, schedule: Schedule, hw: HWConfig) -> bool:
    """True iff :func:`verify_candidate` raises no error-severity finding."""
    return not errors(verify_candidate(workload, schedule, hw))
