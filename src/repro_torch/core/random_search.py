"""Random-search baseline for the hardware DSE comparison (paper §VII-C)."""
from __future__ import annotations

import numpy as np

from .hw_space import HWSpace
from .mobo import (BatchObjectives, DSEResult, Objectives, _finite_rows,
                   _log_rows, as_batch)
from .pareto import IncrementalHV, default_reference


def random_search(space: HWSpace, objectives: Objectives, *,
                  n_trials: int = 20, seed: int = 0,
                  batch_objectives: BatchObjectives | None = None) -> DSEResult:
    rng = np.random.default_rng(seed)
    configs = space.sample(rng, n_trials)
    ys = np.asarray(as_batch(objectives, batch_objectives)(configs),
                    dtype=float)

    fin = _finite_rows(ys)
    base = ys[fin] if fin.any() else np.ones((1, ys.shape[1]))
    ref = default_reference(_log_rows(base), margin=1.3)

    tracker = IncrementalHV(ref)
    hv_history = []
    for y in ys:
        if np.all(np.isfinite(y)):
            tracker.add(_log_rows(y))
        hv_history.append(tracker.hv)
    return DSEResult(configs, ys, hv_history, len(configs), ref)
