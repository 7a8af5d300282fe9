"""Multi-objective Bayesian optimization (paper §V-B, Algorithm 1).

GP surrogate per objective (log-space), hypervolume-based probability of
improvement acquisition [Auger et al.]: the acquisition of a candidate is the
Monte-Carlo probability that its posterior draw enlarges the current
dominated hypervolume, tie-broken by the expected enlargement.

Acquisition runs on the vectorized Pareto engine (DESIGN.md §9): the current
front's :class:`~repro.core.pareto.BoxDecomposition` is built once per trial
and both the candidate prefilter and the MC draws are scored through one
``hvi`` pass each.  ``q > 1`` turns each trial into a q-batch suggestion —
greedy sequential hypervolume improvement with in-loop fantasy-front
augmentation — so a whole population per trial flows through
``batch_objectives`` (and, in the co-design flow, through the shared
``EvalCache``).  In the co-design flow, ``batch_objectives`` is
``hw_objectives_batch``: the trial's q × len(workloads) inner software
searches resolve in ONE lock-step batched-DSE engine pass (DESIGN.md
§10).  ``acquisition="reference"`` keeps the pre-engine per-candidate
scoring loops for parity benchmarks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from repro_torch import obs

from .hw_primitives import HWConfig
from .hw_space import HWSpace
from .pareto import (IncrementalHV, _reference_hypervolume, default_reference,
                     pareto_mask)
from .surrogate import fit_gps

Objectives = Callable[[HWConfig], tuple[float, ...]]
# batched form: a population of configs -> (n, n_obj) array in one call
BatchObjectives = Callable[[Sequence[HWConfig]], np.ndarray]


def as_batch(objectives: Objectives,
             batch_objectives: BatchObjectives | None) -> BatchObjectives:
    """Promote a scalar objectives callable to the batched protocol (the
    explorers only speak batch; scalar callers pay a per-config loop)."""
    if batch_objectives is not None:
        return batch_objectives
    return lambda configs: np.array([objectives(c) for c in configs],
                                    dtype=float)


@dataclass
class DSEResult:
    configs: list[HWConfig]
    ys: np.ndarray                       # (n, n_obj), minimized
    hv_history: list[float]              # hypervolume after each trial
    evaluations: int
    ref: np.ndarray

    @property
    def pareto_configs(self) -> list[HWConfig]:
        mask = pareto_mask(self.ys)
        return [c for c, m in zip(self.configs, mask) if m]

    @property
    def pareto_ys(self) -> np.ndarray:
        return self.ys[pareto_mask(self.ys)]

    def best_under(self, constraints: dict[int, float]) -> tuple[HWConfig, np.ndarray] | None:
        """Lowest-latency (objective 0) point satisfying y[i] <= bound."""
        ok = np.ones(len(self.ys), dtype=bool)
        for i, bound in constraints.items():
            ok &= self.ys[:, i] <= bound
        if not ok.any():
            return None
        idx = int(np.argmin(np.where(ok, self.ys[:, 0], np.inf)))
        return self.configs[idx], self.ys[idx]


def _finite_rows(ys: np.ndarray) -> np.ndarray:
    return np.all(np.isfinite(ys), axis=1)


def _log_rows(ys: np.ndarray) -> np.ndarray:
    return np.log10(np.maximum(ys, 1e-30))


def shared_reference(results: list[DSEResult], margin: float = 1.3) -> np.ndarray:
    """A common reference point over several DSE runs so their hypervolume
    histories are comparable (paper Fig. 10 plots all methods on one axis)."""
    rows = []
    for r in results:
        m = _finite_rows(r.ys)
        if m.any():
            rows.append(_log_rows(r.ys[m]))
    if not rows:
        # every objective of every run came back infeasible: all hypervolume
        # curves are identically zero, so any finite reference works
        d = results[0].ys.shape[1] if results else 1
        return np.ones(d)
    return default_reference(np.vstack(rows), margin=margin)


def rescore_hv_history(result: DSEResult, ref: np.ndarray) -> list[float]:
    """Recompute a run's hypervolume-vs-trial curve under a shared ref.

    Maintains an incremental front: each trial folds one point into an
    :class:`IncrementalHV` instead of recomputing the full prefix
    hypervolume from scratch (O(n) decomposition queries vs O(n^2) sweeps).
    """
    tracker = IncrementalHV(ref)
    out = []
    for y in result.ys:
        if np.all(np.isfinite(y)):
            tracker.add(_log_rows(y))
        out.append(tracker.hv)
    return out


def _acquire_reference(space: HWSpace, gps, cands: list[HWConfig],
                       Ylog: np.ndarray, ref: np.ndarray,
                       rng: np.random.Generator, n_draws: int,
                       n_candidates: int) -> HWConfig:
    """The pre-engine acquisition: per-candidate hypervolume recomputation in
    Python loops.  Kept as the parity/wall-clock baseline for
    ``benchmarks/bench_acquisition.py``; not a production path."""
    hv = _reference_hypervolume
    hv_now = hv(Ylog, ref)
    Xc = np.stack([space.encode01(c) for c in cands])
    # stage 1: rank by HVI of the posterior mean (cheap prefilter)
    means = np.stack([g.predict(Xc)[0] for g in gps], axis=-1)
    mean_hvi = np.array([
        hv(np.vstack([Ylog, m]), ref) - hv_now
        if np.all(m < ref) else 0.0 for m in means])
    top = np.argsort(-mean_hvi)[: max(8, n_candidates // 8)]
    # stage 2: MC hypervolume-PoI on the shortlist
    draws = np.stack([g.sample(Xc[top], n_draws, rng) for g in gps],
                     axis=-1)                # (draws, top, n_obj)
    prob = np.zeros(len(top))
    gain = np.zeros(len(top))
    for d in range(n_draws):
        for c in range(len(top)):
            y_new = draws[d, c]
            if np.any(y_new >= ref):
                continue
            hv_new = hv(np.vstack([Ylog, y_new]), ref)
            if hv_new > hv_now + 1e-12:
                prob[c] += 1.0
                gain[c] += hv_new - hv_now
    prob /= n_draws
    gain /= n_draws
    score = gain + 1e-3 * prob * (abs(hv_now) + 1e-9)
    return cands[int(top[int(np.argmax(score))])]


def _acquire(space: HWSpace, gps, cands: list[HWConfig],
             tracker: IncrementalHV, rng: np.random.Generator, n_draws: int,
             n_candidates: int, q: int) -> list[HWConfig]:
    """Vectorized q-batch acquisition.

    One box decomposition of the current front scores the 256-candidate
    posterior-mean prefilter in a single ``hvi`` pass; the shortlist's
    ``n_draws × |shortlist|`` posterior draws are scored in one more.  For
    ``q > 1``, picks are greedy-sequential joint-draw HVI: every MC draw
    keeps its own fantasy front, augmented after each pick with *that
    draw's* sample of the pick, so the batch hedges across posterior
    scenarios instead of piling onto the region one optimistic mean
    dominates.  With ``q=1`` the single pick scores against the shared
    decomposition — identical to the classic loop.
    """
    hv_now = tracker.hv
    Xc = np.stack([space.encode01(c) for c in cands])
    means = np.stack([g.predict(Xc)[0] for g in gps], axis=-1)
    mean_hvi = tracker.decomposition.hvi(means)
    top = np.argsort(-mean_hvi)[: max(8, n_candidates // 8)]
    draws = np.stack([g.sample(Xc[top], n_draws, rng) for g in gps],
                     axis=-1)                # (draws, top, n_obj)
    picked: list[int] = []
    fantasies: list[IncrementalHV] | None = None
    q_eff = min(q, len(top))            # a thin candidate pool caps the batch
    for _ in range(q_eff):
        if fantasies is None:                # first pick: shared front
            hvi = tracker.decomposition.hvi(
                draws.reshape(-1, draws.shape[-1])).reshape(n_draws, len(top))
        else:
            hvi = np.stack([f.decomposition.hvi(draws[d])
                            for d, f in enumerate(fantasies)])
        improving = hvi > 1e-12
        gain = np.where(improving, hvi, 0.0).mean(axis=0)
        prob = improving.mean(axis=0)
        score = gain + 1e-3 * prob * (abs(hv_now) + 1e-9)
        score[picked] = -np.inf
        j = int(np.argmax(score))
        picked.append(j)
        if len(picked) < q_eff:
            if fantasies is None:
                fantasies = [tracker.copy() for _ in range(n_draws)]
            for d, f in enumerate(fantasies):
                f.add(draws[d, j])
    return [cands[int(top[j])] for j in picked]


def mobo(space: HWSpace, objectives: Objectives, *, n_init: int = 5,
         n_trials: int = 20, seed: int = 0, n_candidates: int = 256,
         n_draws: int = 24, ref: np.ndarray | None = None,
         batch_objectives: BatchObjectives | None = None, q: int = 1,
         acquisition: str = "vectorized") -> DSEResult:
    """Algorithm 1.  ``objectives`` returns minimized metrics, e.g.
    (latency_s, power_w, area_um2).  ``batch_objectives``, when given, scores
    whole populations per call (the initial design, and each trial's picks)
    through the batched cost-model path.

    ``q`` is the suggestion batch size: each acquisition round proposes ``q``
    distinct configs (greedy sequential HVI) and evaluates them with one
    batched objectives call.  ``q=1`` reproduces the classic single-pick
    loop.  ``acquisition`` selects the engine: ``"vectorized"`` (default) or
    ``"reference"`` (pre-engine scalar loops; q must be 1).
    """
    if acquisition not in ("vectorized", "reference"):
        raise ValueError(f"unknown acquisition engine: {acquisition!r}")
    q = max(1, int(q))
    if acquisition == "reference" and q != 1:
        raise ValueError("reference acquisition only supports q=1")
    rng = np.random.default_rng(seed)
    fbatch = as_batch(objectives, batch_objectives)

    configs: list[HWConfig] = space.sample(rng, n_init)
    with obs.span("mobo.init_design"):
        ys = np.asarray(fbatch(configs), dtype=float)
    tried = {c.encode() for c in configs}

    fin = _finite_rows(ys)
    if ref is None:
        base = ys[fin] if fin.any() else np.ones((1, ys.shape[1]))
        ref = default_reference(_log_rows(base), margin=1.3)

    tracker = IncrementalHV(ref)
    for y in ys:
        if np.all(np.isfinite(y)):
            tracker.add(_log_rows(y))
    hv_history = [0.0] * (len(configs) - 1) + [tracker.hv]

    st = obs.state()
    while len(configs) < n_trials:
        with obs.span("mobo.trial"):
            fin = _finite_rows(ys)
            if fin.sum() >= 2:
                # impute illegal/failed points at a log-space penalty above
                # the observed worst so the surrogate learns to avoid them
                # (dropping them wastes the paper's scarce trials on
                # infeasible regions)
                X = np.stack([space.encode01(c) for c in configs])
                Ylog = _log_rows(ys)
                worst = np.nanmax(np.where(np.isfinite(Ylog), Ylog, np.nan),
                                  axis=0)
                Y = np.where(np.isfinite(Ylog), Ylog, worst + 1.0)
                with obs.span("mobo.fit_gps"):
                    # one shared kernel sweep for all objectives
                    gps = fit_gps(X, Y)
            else:
                gps = None

            cands = space.sample(rng, n_candidates, exclude=tried)
            if not cands:
                break
            q_now = min(q, n_trials - len(configs))
            with obs.span("mobo.acquire"):
                if gps is None:
                    picks = cands[:q_now]
                elif acquisition == "reference":
                    picks = [_acquire_reference(space, gps, cands,
                                                _log_rows(ys[fin]), ref, rng,
                                                n_draws, n_candidates)]
                else:
                    picks = _acquire(space, gps, cands, tracker, rng,
                                     n_draws, n_candidates, q_now)

            with obs.span("mobo.evaluate"):
                ys_new = np.asarray(fbatch(picks), dtype=float)
            for pick, y in zip(picks, ys_new):
                configs.append(pick)
                tried.add(pick.encode())
                ys = np.vstack([ys, y[None, :]])
                if np.all(np.isfinite(y)):
                    tracker.add(_log_rows(y))
                hv_history.append(tracker.hv)
            if st is not None:
                # the HV-vs-trial trajectory, one point per MOBO round
                st.tracer.instant("mobo.hv", {"trial": len(configs),
                                              "hv": tracker.hv})
                st.metrics.gauge("mobo.hv").set(tracker.hv)
                st.metrics.counter("mobo.trials").inc()

    return DSEResult(configs, ys, hv_history, len(configs), ref)
