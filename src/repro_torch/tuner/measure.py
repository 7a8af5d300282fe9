"""Measurement backend: run candidate (HWConfig, Schedule) points as the
hand-written CUDA kernels and time them (DESIGN.md §8.1).

The analytical cost model (``core/cost_model.py``) explores at nanosecond
cost but predicts accelerator-model behaviour; this module closes the loop
by *lowering* a candidate to the concrete kernel the dispatch layer would
run (``kernels/ops.py``) and timing that invocation with warmup/repeat/
median discipline — the AutoTVM-style "measure" half of the tuner.

Lowering rules (DESIGN.md §2: the co-designed accelerator IS a kernel
resource envelope):

  * the workload's tensor structure picks the kernel family (gemm / gemv /
    dot / conv2d) — NOT the tensorize choice, because measurement runs what
    the runtime would actually dispatch;
  * block shapes are the schedule's interface tiles padded to the hardware
    intrinsic block (the cost model's ``ptile``), so measurement is
    sensitive to both the schedule's split factors and the accelerator's
    array shape; the kernels take any positive block as given;
  * ``backend='cuda'`` runs the kernels on the card (inputs built there);
    ``backend='torch'`` runs the plain PyTorch versions on the CPU, which
    keeps the flow testable without a card but times nothing of the
    device.

Failures (unloweable workload, shape/compile errors, kernel crashes) are
*captured*: a failed candidate yields ``MeasureResult(latency_s=inf,
error=...)`` instead of aborting the whole population — invalid points are
data for the explorer, not exceptions.  Robustness (DESIGN.md §14): kernel
*timing* failures — transient by nature, unlike structural lowering errors —
are retried with capped exponential backoff, and candidates quarantined by
the tuning DB's failure history are skipped without burning wall clock.

Statically-illegal candidates (DESIGN.md §16.2) never reach lowering at
all: the ``repro.analysis`` legality verifier runs ahead of ``lower`` and
candidates it rejects come back as ``error_type="Illegal"`` — never timed,
never retried, never quarantined (they carry no kernel point), so the
measurement budget goes only to candidates that can work.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.core.hw_primitives import HWConfig
from repro_torch.core.sw_primitives import Schedule
from repro_torch.core.tst import TensorExpr
from repro_torch.ft import inject

KERNEL_OPS = ("gemm", "gemv", "dot", "conv2d")


@dataclass(frozen=True)
class KernelPoint:
    """The concrete kernel invocation a candidate lowers to — also the
    tuning-database key (op, shape, dtype, backend) plus its block shape."""

    op: str                       # one of KERNEL_OPS
    shape: tuple[int, ...]        # canonical problem shape (see _classify)
    dtype: str
    backend: str                  # 'cuda' | 'torch'
    blocks: tuple[tuple[str, int], ...]   # sorted (name, value) pairs

    @property
    def block_map(self) -> dict[str, int]:
        return dict(self.blocks)


def quarantine_key(point: KernelPoint) -> str:
    """Stable identity of a concrete kernel invocation for the tuning DB's
    quarantine section: the DB record key plus the block shapes (a candidate
    is quarantined per block config, not per problem shape)."""
    blocks = ",".join(f"{k}={v}" for k, v in point.blocks)
    return "|".join([point.op, "x".join(str(v) for v in point.shape),
                     point.dtype, point.backend, blocks])


@dataclass(frozen=True)
class MeasureResult:
    """Timed outcome of one candidate.  ``latency_s`` is the median over
    ``times_s``; a failed lowering/run carries +inf and the error string.
    ``elapsed_s`` is the wall clock the *attempt* cost (lower + warmup +
    repeats, or however far a failure got) and ``error_type`` the exception
    class name — together they make failure populations analyzable from the
    tuning DB (which schedules fail, how, and how much time they burn)."""

    latency_s: float
    times_s: tuple[float, ...] = ()
    point: KernelPoint | None = None
    error: str = ""
    elapsed_s: float = 0.0
    error_type: str = ""

    @property
    def ok(self) -> bool:
        return math.isfinite(self.latency_s)


@dataclass
class MeasureOptions:
    backend: str = "cuda"
    dtype: str = "float32"
    warmup: int = 2
    repeats: int = 5
    # optional cap on the padded-tile volume a candidate may claim.  The
    # reference caps it at 1 << 24 because its interpret mode allocates the
    # padded block; the CUDA kernels walk any block in fixed sub-tiles and
    # allocate only the workload's own operands, so the port sets no cap
    max_block_elems: int | None = None
    # bounded retry for kernel-timing failures (transient crashes / flaky
    # backends); lowering errors are structural and never retried
    max_retries: int = 2
    retry_backoff_s: float = 0.05
    retry_backoff_cap_s: float = 1.0


# ---------------------------------------------------------------------------
# Workload classification: which kernel family implements this TensorExpr?
# ---------------------------------------------------------------------------


def classify(workload: TensorExpr) -> tuple[str, dict[str, str]] | None:
    """-> (op, role->loop) for kernel-loweable workloads, else None.

    Roles are kernel-block axes: gemm (m, n, k); gemv (m, k); dot (k,);
    conv2d (k, c, x, y, r, s).  Classification is structural (tensor index
    patterns), so it works for any loop naming.
    """
    tensors = workload.tensors()
    if len(tensors) != 2:
        return None
    dims = list(tensors.values())
    out = workload.out_indices
    red = [l for l in workload.all_indices() if l in workload.reduced]

    flat = [tuple(i for d in ds for i in d) for ds in dims]
    ranks = sorted(len(f) for f in flat)

    # DOT: two 1-D operands over one shared reduced index
    if ranks == [1, 1] and len(red) == 1 and all(f == (red[0],) for f in flat):
        return "dot", {"k": red[0]}

    # GEMV: A[m, k] and x[k] -> y[m]
    if ranks == [1, 2] and len(red) == 1 and len(out) == 1:
        mat = flat[0] if len(flat[0]) == 2 else flat[1]
        if set(mat) == {out[0], red[0]}:
            return "gemv", {"m": out[0], "k": red[0]}

    # GEMM: A[m, k] and B[k, n] -> C[m, n]
    if ranks == [2, 2] and len(red) == 1 and len(out) == 2:
        m, n, k = out[0], out[1], red[0]
        sets = [set(f) for f in flat]
        if {m, k} in sets and {k, n} in sets:
            return "gemm", {"m": m, "n": n, "k": k}

    # CONV2D: A[c, x+r, y+s] and W[k, c, r, s] -> C[k, x, y] ('valid')
    if len(out) == 3 and len(red) == 3:
        a = next((ds for ds in dims
                  if len(ds) == 3 and any(len(d) == 2 for d in ds)), None)
        w = next((ds for ds in dims if len(ds) == 4), None)
        if a is not None and w is not None and len(a[0]) == 1:
            (c,), (x, r), (y, s) = a[0], a[1], a[2]
            if (workload.out_indices == (out[0], x, y)
                    and {c, r, s} == set(red)):
                return "conv2d", {"k": out[0], "c": c, "x": x, "y": y,
                                  "r": r, "s": s}
    return None


def padded_tiles(workload: TensorExpr, hw: HWConfig,
                 schedule: Schedule) -> dict[str, int]:
    """Per-loop padded interface tile (the cost model's ``ptile``): the
    schedule's split factor clamped to the extent and rounded up to the
    intrinsic block dim its tensorize choice maps it onto."""
    ext = workload.extents
    block = hw.intrinsic_dims()
    mapped = dict(schedule.choice.index_map)
    tiles = schedule.tile_map
    pt: dict[str, int] = {}
    for loop in workload.all_indices():
        t = max(1, min(tiles.get(loop, ext[loop]), ext[loop]))
        b = 1
        for q, c in mapped.items():
            if c == loop:
                b = max(1, block[q])
                break
        pt[loop] = -(-t // b) * b
    return pt


# ---------------------------------------------------------------------------
# Lowering: (workload, hw, schedule) -> a timeable kernel invocation
# ---------------------------------------------------------------------------


def lower(workload: TensorExpr, hw: HWConfig, schedule: Schedule,
          opts: MeasureOptions) -> tuple[KernelPoint, Callable]:
    """-> (point, thunk) where ``thunk()`` runs the kernel once and waits
    for the device (``torch.cuda.synchronize``).

    Inputs come from the same ``np.random.default_rng(0)`` draws as the
    reference's, built on the backend's device.  Raises ValueError for
    workloads with no kernel lowering; the batch driver converts that into
    a failed MeasureResult.
    """
    cls = classify(workload)
    if cls is None:
        raise ValueError(f"no kernel lowering for workload {workload.name!r}")
    op, roles = cls
    ext = workload.extents
    pt = padded_tiles(workload, hw, schedule)

    import torch

    from repro_torch.kernels import ops

    if opts.backend not in ops.DEVICE_OF:
        raise ValueError(f"unknown measurement backend {opts.backend!r} "
                         f"(want one of {ops.IMPLEMENTATIONS})")
    dtype = getattr(torch, opts.dtype)
    device = ops.DEVICE_OF[opts.backend]
    rng = np.random.default_rng(0)

    def arr(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                               device=device)

    if op == "gemm":
        m, n, k = (ext[roles[r]] for r in ("m", "n", "k"))
        blocks = {"bm": min(pt[roles["m"]], m), "bn": min(pt[roles["n"]], n),
                  "bk": min(pt[roles["k"]], k)}
        shape: tuple[int, ...] = (m, n, k)
        a, b = arr(m, k), arr(k, n)
        fn = lambda: ops.matmul(a, b, implementation=opts.backend, **blocks)
    elif op == "gemv":
        m, k = ext[roles["m"]], ext[roles["k"]]
        blocks = {"bm": min(pt[roles["m"]], m), "bk": min(pt[roles["k"]], k)}
        shape = (m, k)
        a, x = arr(m, k), arr(k)
        fn = lambda: ops.matvec(a, x, implementation=opts.backend, **blocks)
    elif op == "dot":
        k = ext[roles["k"]]
        blocks = {"bk": min(pt[roles["k"]], k)}
        shape = (k,)
        a, b = arr(k), arr(k)
        fn = lambda: ops.dot(a, b, implementation=opts.backend, **blocks)
    else:  # conv2d
        kk, c, x, y, r, s = (ext[roles[t]] for t in "kcxyrs")
        blocks = {"bk": min(pt[roles["k"]], kk)}
        shape = (kk, c, x, y, r, s)
        a, w = arr(c, x + r - 1, y + s - 1), arr(kk, c, r, s)
        fn = lambda: ops.conv2d(a, w, implementation=opts.backend, **blocks)

    vol = 1
    for v in pt.values():
        vol *= v
    if opts.max_block_elems is not None and vol > opts.max_block_elems:
        raise ValueError(f"padded tile volume {vol} exceeds "
                         f"max_block_elems={opts.max_block_elems}")

    point = KernelPoint(op, shape, opts.dtype, opts.backend,
                        tuple(sorted(blocks.items())))
    if device == "cpu":
        return point, fn

    def run():
        fn()
        torch.cuda.synchronize()

    return point, run


def _time(thunk: Callable, opts: MeasureOptions) -> tuple[float, ...]:
    # fault-injection site (DESIGN.md §14): one draw per timing attempt, so
    # a rate schedule exercises the retry path independently each attempt
    inject.check("measure.kernel")
    for _ in range(opts.warmup):
        thunk()
    times = []
    for _ in range(opts.repeats):
        t0 = time.perf_counter()
        thunk()
        times.append(time.perf_counter() - t0)
    return tuple(times)


def _time_retry(thunk: Callable, opts: MeasureOptions,
                workload: TensorExpr) -> tuple[float, ...]:
    """Time with bounded retry + capped exponential backoff; re-raises the
    last failure once ``max_retries`` extra attempts are exhausted."""
    for attempt in range(opts.max_retries + 1):
        if attempt:
            time.sleep(min(opts.retry_backoff_s * 2 ** (attempt - 1),
                           opts.retry_backoff_cap_s))
            st = obs.state()
            if st is not None:
                st.metrics.counter("tuner.measure_retries").inc()
                st.tracer.instant("tuner.measure_retry",
                                  {"workload": workload.name,
                                   "attempt": attempt})
        try:
            return _time(thunk, opts)
        except Exception:
            if attempt >= opts.max_retries:
                raise
    raise AssertionError("unreachable")  # pragma: no cover


def _fail_result(e: Exception, point: KernelPoint | None,
                 elapsed_s: float, workload: TensorExpr) -> MeasureResult:
    """Failure capture: invalid candidates become inf, with the exception
    class and the wall clock the attempt burned recorded alongside."""
    st = obs.state()
    if st is not None:
        st.metrics.counter("tuner.measure_failures").inc()
        st.tracer.instant("tuner.measure_fail",
                          {"workload": workload.name,
                           "error_type": type(e).__name__})
    return MeasureResult(math.inf, (), point, f"{type(e).__name__}: {e}",
                         elapsed_s=elapsed_s,
                         error_type=type(e).__name__)


def _static_illegal(workload: TensorExpr, hw: HWConfig, schedule: Schedule,
                    opts: MeasureOptions) -> list:
    """Error-severity legality findings for a candidate, or [] when the
    static verifier has nothing gating to say.  A choice matched against a
    *different* workload is left for :func:`lower` to reject (its
    'no kernel lowering' ValueError is load-bearing failure-capture data),
    as is the max_block_elems volume cap."""
    if schedule.choice.workload_name != workload.name:
        return []
    from repro_torch.analysis.findings import errors
    from repro_torch.analysis.legality import verify_candidate
    return errors(verify_candidate(workload, schedule, hw,
                                   max_block_elems=opts.max_block_elems))


def _illegal_result(findings: list, workload: TensorExpr) -> MeasureResult:
    """Skip a statically-illegal candidate unrun: inf latency, the firing
    rule ids in the error string, ``error_type="Illegal"`` and no kernel
    point — so it can never be retried or quarantined."""
    st = obs.state()
    if st is not None:
        st.metrics.counter("tuner.illegal_skips").inc()
        st.tracer.instant("tuner.illegal_skip",
                          {"workload": workload.name,
                           "rule": findings[0].rule})
    detail = "; ".join(f"{f.rule}: {f.detail}" for f in findings[:3])
    return MeasureResult(math.inf, (), None, detail, error_type="Illegal")


def _quarantined_result(point: KernelPoint,
                        workload: TensorExpr) -> MeasureResult:
    """Skip a candidate the tuning DB has quarantined: inf latency with a
    distinguishing error_type, and no kernel time burned."""
    st = obs.state()
    if st is not None:
        st.metrics.counter("tuner.quarantine_skips").inc()
        st.tracer.instant("tuner.quarantine_skip",
                          {"workload": workload.name,
                           "key": quarantine_key(point)})
    return MeasureResult(math.inf, (), point,
                         "quarantined by tuning-db failure history",
                         error_type="Quarantined")


def measure_one(workload: TensorExpr, hw: HWConfig, schedule: Schedule,
                opts: MeasureOptions | None = None,
                quarantine: set[str] | None = None) -> MeasureResult:
    """Lower and time one candidate; never raises on candidate failure.
    ``quarantine`` holds :func:`quarantine_key` strings of candidates the
    tuning DB has marked persistently failing — they are skipped unrun."""
    opts = opts or MeasureOptions()
    with obs.span("tuner.measure",
                  {"workload": workload.name, "backend": opts.backend}
                  if obs.enabled() else None):
        bad = _static_illegal(workload, hw, schedule, opts)
        if bad:
            return _illegal_result(bad, workload)
        t0 = time.perf_counter()
        try:
            point, thunk = lower(workload, hw, schedule, opts)
        except Exception as e:
            return _fail_result(e, None, time.perf_counter() - t0, workload)
        if quarantine and quarantine_key(point) in quarantine:
            return _quarantined_result(point, workload)
        try:
            times = _time_retry(thunk, opts, workload)
        except Exception as e:
            return _fail_result(e, point, time.perf_counter() - t0, workload)
        st = obs.state()
        if st is not None:
            st.metrics.counter("tuner.measured").inc()
        return MeasureResult(float(np.median(times)), times, point,
                             elapsed_s=time.perf_counter() - t0)


def measure_batch(workload: TensorExpr,
                  hw_configs: HWConfig | Sequence[HWConfig],
                  schedules: Sequence[Schedule],
                  opts: MeasureOptions | None = None,
                  quarantine: set[str] | None = None) -> list[MeasureResult]:
    """Measure a candidate population, deduplicating identical lowerings.

    Many (hw, schedule) points lower to the same KernelPoint (e.g. tiles
    that pad to the same block shape); each distinct point is compiled and
    timed once and its result shared — the batched analogue of the cost
    model's EvalCache, but for wall-clock measurements.  Candidates whose
    :func:`quarantine_key` is in ``quarantine`` are skipped unrun, as are
    statically-illegal candidates (``error_type="Illegal"``);
    :func:`summarize_batch` counts both skip classes alongside the dedup
    statistics.
    """
    opts = opts or MeasureOptions()
    schedules = list(schedules)
    n = len(schedules)
    if isinstance(hw_configs, HWConfig):
        hws: list[HWConfig] = [hw_configs] * n
    else:
        hws = list(hw_configs)
        if len(hws) == 1 and n > 1:
            hws = hws * n
        if len(hws) != n:
            raise ValueError(f"{len(hws)} hw configs for {n} schedules")

    memo: dict[KernelPoint, MeasureResult] = {}
    out: list[MeasureResult] = []
    for hw, sched in zip(hws, schedules):
        with obs.span("tuner.measure",
                      {"workload": workload.name, "backend": opts.backend}
                      if obs.enabled() else None):
            bad = _static_illegal(workload, hw, sched, opts)
            if bad:
                out.append(_illegal_result(bad, workload))
                continue
            t0 = time.perf_counter()
            try:
                point, thunk = lower(workload, hw, sched, opts)
            except Exception as e:
                out.append(_fail_result(e, None, time.perf_counter() - t0,
                                        workload))
                continue
            if quarantine and quarantine_key(point) in quarantine:
                out.append(_quarantined_result(point, workload))
                continue
            res = memo.get(point)
            if res is None:
                try:
                    times = _time_retry(thunk, opts, workload)
                    res = MeasureResult(float(np.median(times)), times, point,
                                        elapsed_s=time.perf_counter() - t0)
                    st = obs.state()
                    if st is not None:
                        st.metrics.counter("tuner.measured").inc()
                except Exception as e:
                    res = _fail_result(e, point, time.perf_counter() - t0,
                                       workload)
                memo[point] = res
            out.append(res)
    return out


def summarize_batch(results: Sequence[MeasureResult]) -> dict:
    """Skip/dedup accounting for one :func:`measure_batch` population:
    how many candidates were actually timed vs served from the dedup memo,
    skipped as statically illegal, skipped as quarantined, or failed."""
    n_ok = sum(r.ok for r in results)
    n_illegal = sum(r.error_type == "Illegal" for r in results)
    n_quarantined = sum(r.error_type == "Quarantined" for r in results)
    unique = len({r.point for r in results if r.point is not None})
    return {
        "candidates": len(results),
        "measured": n_ok,
        "unique_points": unique,
        "deduped": sum(r.point is not None for r in results) - unique,
        "illegal": n_illegal,
        "quarantined": n_quarantined,
        "failed": len(results) - n_ok - n_illegal - n_quarantined,
    }
