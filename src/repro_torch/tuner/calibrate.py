"""Calibration: fit the analytical cost model to measured latencies
(DESIGN.md §8.2).

The analytical model's job in the DSE loop is *ranking*, and its absolute
numbers target a TPU-instance abstraction — real kernels (or the interpret
backend on CPU) have different constants and different second-order terms.
Following the learned-co-design recipe (Shi et al., "Learned Hardware/
Software Co-Design of Neural Accelerators"), we keep the cheap model as the
feature generator and fit a small per-op correction from its predictions to
measured truth:

    log(measured_s) ≈ w · φ(report)

where φ is a log-space feature vector drawn from the CostReport the
analytical model already computes (predicted latency, calls, flops, HBM
bytes, utilization, compute fraction).  A ridge least-squares fit needs only
a few dozen measurements; with fewer samples the fit degrades gracefully to
a pure log-offset (scale) correction, and with none it is the identity.

:class:`CalibratedCostModel` exposes the corrected model through the same
``evaluate``/``evaluate_batch`` surface as ``core/cost_model.py`` (including
EvalCache sharing), so explorers can swap it in without code changes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from repro_torch.core.cost_model import (CostReport, EvalCache, _fingerprint,
                                   evaluate, evaluate_batch_reports)
from repro_torch.core.hw_primitives import HWConfig
from repro_torch.core.sw_primitives import Schedule
from repro_torch.core.tst import TensorExpr

from .measure import MeasureResult, classify

N_FEATURES = 7
_MIN_LINEAR_SAMPLES = N_FEATURES + 3   # under this, offset-only is safer
_RIDGE = 1e-3


def features(report: CostReport) -> np.ndarray:
    """φ(report): log-space features of one analytical evaluation."""
    lat = report.latency_s
    if not math.isfinite(lat) or lat <= 0:
        return np.full(N_FEATURES, np.nan)
    total = report.compute_s + report.memory_s
    return np.array([
        1.0,
        math.log(lat),
        math.log1p(report.calls),
        math.log1p(report.flops),
        math.log1p(report.hbm_bytes),
        report.utilization,
        report.compute_s / total if total > 0 else 0.5,
    ])


@dataclass(frozen=True)
class Correction:
    """One op family's fitted analytical->measured latency map."""

    kind: str                      # 'identity' | 'offset' | 'linear'
    weights: tuple[float, ...] = ()
    offset: float = 0.0
    n_samples: int = 0

    def predict(self, report: CostReport) -> float:
        """Corrected latency for one analytical report (inf passes through)."""
        if not math.isfinite(report.latency_s):
            return report.latency_s
        if self.kind == "identity":
            return report.latency_s
        if self.kind == "offset":
            return report.latency_s * math.exp(self.offset)
        phi = features(report)
        return float(math.exp(float(np.dot(np.asarray(self.weights), phi))))

    def to_dict(self) -> dict:
        return {"kind": self.kind, "weights": list(self.weights),
                "offset": self.offset, "n_samples": self.n_samples}

    @classmethod
    def from_dict(cls, d: dict) -> "Correction":
        return cls(d.get("kind", "identity"),
                   tuple(d.get("weights", ())),
                   float(d.get("offset", 0.0)), int(d.get("n_samples", 0)))


IDENTITY = Correction("identity")


@dataclass
class Calibration:
    """Per-op corrections, persisted inside the tuning database."""

    corrections: dict[str, Correction] = field(default_factory=dict)

    def for_op(self, op: str) -> Correction:
        return self.corrections.get(op, IDENTITY)

    def to_dict(self) -> dict:
        return {op: c.to_dict() for op, c in self.corrections.items()}

    @classmethod
    def from_dict(cls, d: dict) -> "Calibration":
        return cls({op: Correction.from_dict(c) for op, c in d.items()})

    def __bool__(self) -> bool:
        return bool(self.corrections)


def fit_correction(reports: Sequence[CostReport],
                   measured_s: Sequence[float]) -> Correction:
    """Fit one op's correction from paired (analytical report, measured)."""
    phis, ys = [], []
    for rep, m in zip(reports, measured_s):
        phi = features(rep)
        if np.all(np.isfinite(phi)) and math.isfinite(m) and m > 0:
            phis.append(phi)
            ys.append(math.log(m))
    n = len(ys)
    if n == 0:
        return IDENTITY
    X = np.stack(phis)
    y = np.asarray(ys)
    if n < _MIN_LINEAR_SAMPLES:
        return Correction("offset", offset=float(np.median(y - X[:, 1])),
                          n_samples=n)
    # ridge least squares in log space; the bias column makes it affine
    A = X.T @ X + _RIDGE * np.eye(N_FEATURES)
    w = np.linalg.solve(A, X.T @ y)
    return Correction("linear", weights=tuple(float(v) for v in w),
                      n_samples=n)


def fit(samples: Sequence[tuple[str, CostReport, float]]) -> Calibration:
    """Fit per-op corrections from (op, analytical report, measured_s)."""
    by_op: dict[str, tuple[list, list]] = {}
    for op, rep, m in samples:
        by_op.setdefault(op, ([], []))
        by_op[op][0].append(rep)
        by_op[op][1].append(m)
    return Calibration({op: fit_correction(reps, ms)
                        for op, (reps, ms) in by_op.items()})


def collect_samples(workload: TensorExpr, reports: Sequence[CostReport],
                    results: Sequence[MeasureResult]
                    ) -> list[tuple[str, CostReport, float]]:
    """Pair analytical reports with successful measurements for fitting."""
    cls = classify(workload)
    if cls is None:
        return []
    op = cls[0]
    return [(op, rep, res.latency_s)
            for rep, res in zip(reports, results)
            if res.ok and rep.legal and math.isfinite(rep.latency_s)]


class CalibratedCostModel:
    """The analytical model with measured-truth corrections applied.

    Drop-in for the ``evaluate``/``evaluate_batch`` API: same signatures,
    same EvalCache protocol (the cache stores *analytical* reports, so one
    cache serves both the raw and the calibrated model), latency corrected
    per the workload's op family; power and area pass through unchanged.
    An EvalCache attached at construction becomes the default for every
    evaluate call, and its ``cache_hits``/``cache_misses``/``cache_hit_rate``
    are forwarded here so explorers can report reuse without reaching
    through to the cache object.
    """

    def __init__(self, calibration: Calibration,
                 target: str = "tpu", cache: EvalCache | None = None):
        self.calibration = calibration
        self.target = target
        self.cache = cache     # default EvalCache for evaluate/evaluate_batch
        self._op_cache: dict[tuple, str | None] = {}

    @property
    def cache_hits(self) -> int:
        """Hits of the attached EvalCache (0 when none is attached)."""
        return self.cache.hits if self.cache is not None else 0

    @property
    def cache_misses(self) -> int:
        return self.cache.misses if self.cache is not None else 0

    @property
    def cache_hit_rate(self) -> float:
        return self.cache.hit_rate if self.cache is not None else 0.0

    def _op(self, workload: TensorExpr) -> str | None:
        key = _fingerprint(workload)
        if key not in self._op_cache:
            cls = classify(workload)
            self._op_cache[key] = cls[0] if cls else None
        return self._op_cache[key]

    def evaluate(self, workload: TensorExpr, schedule: Schedule,
                 hw: HWConfig, target: str | None = None,
                 cache: EvalCache | None = None) -> CostReport:
        """Analytical report with its latency replaced by the corrected
        prediction (energy/power/area untouched)."""
        import dataclasses

        rep = evaluate(workload, schedule, hw, target or self.target,
                       cache=cache if cache is not None else self.cache)
        op = self._op(workload)
        if op is None or not rep.legal:
            return rep
        lat = self.calibration.for_op(op).predict(rep)
        return dataclasses.replace(rep, latency_s=lat)

    def evaluate_batch(self, workload: TensorExpr,
                       hw_configs, schedules: Sequence[Schedule],
                       target: str | None = None,
                       cache: EvalCache | None = None) -> np.ndarray:
        """(N, 3) minimized objectives with calibrated latency."""
        reports = evaluate_batch_reports(
            workload, hw_configs, schedules, target or self.target,
            cache=cache if cache is not None else self.cache)
        op = self._op(workload)
        corr = self.calibration.for_op(op) if op else IDENTITY
        ys = np.empty((len(reports), 3))
        for i, rep in enumerate(reports):
            lat = corr.predict(rep) if rep.legal else rep.latency_s
            ys[i] = (lat, rep.power_w, rep.area_um2)
        return ys

    def predict_latency(self, workload: TensorExpr,
                        reports: Sequence[CostReport]) -> np.ndarray:
        """Corrected latency for pre-computed analytical reports."""
        op = self._op(workload)
        corr = self.calibration.for_op(op) if op else IDENTITY
        return np.array([corr.predict(r) if r.legal else r.latency_s
                         for r in reports])


# ---------------------------------------------------------------------------
# Rank-correlation metric (scipy-free): how well does a model *order*
# candidates?  This is the quantity calibration must improve.
# ---------------------------------------------------------------------------


def _ranks(x: np.ndarray) -> np.ndarray:
    """Average ranks (ties shared), the classic Spearman prerequisite."""
    order = np.argsort(x, kind="mergesort")
    ranks = np.empty(len(x), dtype=float)
    sx = x[order]
    i = 0
    while i < len(x):
        j = i
        while j + 1 < len(x) and sx[j + 1] == sx[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j)
        i = j + 1
    return ranks


def spearman(a, b) -> float:
    """Spearman rank correlation over finite pairs; nan if degenerate."""
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    m = np.isfinite(a) & np.isfinite(b)
    if m.sum() < 2:
        return float("nan")
    ra, rb = _ranks(a[m]), _ranks(b[m])
    ra -= ra.mean()
    rb -= rb.mean()
    denom = math.sqrt(float(ra @ ra) * float(rb @ rb))
    if denom == 0:
        return float("nan")
    return float(ra @ rb) / denom
