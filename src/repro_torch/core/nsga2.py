"""NSGA-II baseline (paper §VII-C compares MOBO against it).

Standard elitist non-dominated sorting GA [Deb et al. 2002]: fast
non-dominated sort, crowding distance, binary tournament, uniform crossover
and ordinal mutation over the hardware design space encoding.  Sorting and
crowding are vectorized (one dominance matrix / one argsort per generation
instead of the double Python loop over the dominance relation), and the
hypervolume history rides the incremental front tracker (DESIGN.md §9).
"""
from __future__ import annotations

import numpy as np

from .hw_space import HWSpace
from .mobo import (BatchObjectives, DSEResult, Objectives, _finite_rows,
                   _log_rows, as_batch)
from .pareto import IncrementalHV, default_reference


def _fast_nondominated_sort(ys: np.ndarray) -> list[list[int]]:
    """Deb's rank peeling on a vectorized dominance matrix: ``dom[p, q]`` is
    "p dominates q"; rank-r members are those whose domination count hits
    zero once ranks < r are peeled off."""
    ys = np.asarray(ys, dtype=float)
    n = len(ys)
    if n == 0:
        return []
    le = np.all(ys[:, None, :] <= ys[None, :, :], axis=-1)
    lt = np.any(ys[:, None, :] < ys[None, :, :], axis=-1)
    dom = le & lt
    counts = dom.sum(axis=0).astype(np.int64)
    fronts: list[list[int]] = []
    current = np.flatnonzero(counts == 0)
    while current.size:
        fronts.append([int(i) for i in current])
        counts -= dom[current].sum(axis=0)
        counts[current] = -1            # retire assigned rows
        current = np.flatnonzero(counts == 0)
    return fronts


def _crowding(ys: np.ndarray, front: list[int]) -> dict[int, float]:
    if len(front) <= 2:
        return {i: np.inf for i in front}
    arr = ys[front]                                  # (k, n_obj)
    order = np.argsort(arr, axis=0)                  # per-objective ranking
    svals = np.take_along_axis(arr, order, axis=0)
    span = svals[-1] - svals[0]
    span = np.where(span != 0, span, 1.0)
    gaps = (svals[2:] - svals[:-2]) / span           # (k-2, n_obj)
    contrib = np.zeros_like(arr)
    np.put_along_axis(contrib, order[1:-1], gaps, axis=0)
    dist = contrib.sum(axis=1)
    dist[order[0]] = np.inf                          # boundary points
    dist[order[-1]] = np.inf
    return {front[k]: float(dist[k]) for k in range(len(front))}


def nsga2(space: HWSpace, objectives: Objectives, *, pop_size: int = 5,
          n_trials: int = 20, seed: int = 0,
          batch_objectives: BatchObjectives | None = None,
          children_per_gen: int = 1) -> DSEResult:
    """Evaluate at most ``n_trials`` distinct design points (the paper caps
    all methods by trial count — evaluations are the expensive resource).

    The initial population and each generation's offspring are scored
    through one batched objectives call; ``children_per_gen > 1`` evaluates
    a whole brood per generation (clipped to the trial budget) before
    environmental selection.
    """
    rng = np.random.default_rng(seed)
    fbatch = as_batch(objectives, batch_objectives)
    configs = space.sample(rng, pop_size)
    ys = np.asarray(fbatch(configs), dtype=float)
    tried = {c.encode(): i for i, c in enumerate(configs)}

    all_configs = list(configs)
    all_ys = ys.copy()

    fin = _finite_rows(all_ys)
    base = all_ys[fin] if fin.any() else np.ones((1, all_ys.shape[1]))
    ref = default_reference(_log_rows(base), margin=1.3)

    tracker = IncrementalHV(ref)
    for y in all_ys:
        if np.all(np.isfinite(y)):
            tracker.add(_log_rows(y))
    hv_history = [0.0] * (len(all_configs) - 1) + [tracker.hv]

    pop_idx = list(range(len(configs)))
    while len(all_configs) < n_trials:
        pys = all_ys[pop_idx]
        fronts = _fast_nondominated_sort(pys)
        rank = {}
        crowd = {}
        for r, f in enumerate(fronts):
            c = _crowding(pys, f)
            for i in f:
                rank[i] = r
                crowd[i] = c[i]

        def tournament() -> int:
            a, b = rng.integers(len(pop_idx)), rng.integers(len(pop_idx))
            if rank.get(a, 0) != rank.get(b, 0):
                return pop_idx[a] if rank.get(a, 0) < rank.get(b, 0) else pop_idx[b]
            return pop_idx[a] if crowd.get(a, 0) >= crowd.get(b, 0) else pop_idx[b]

        # produce this generation's brood of unseen offspring, then score
        # the whole brood with one batched objectives call
        brood: list = []
        brood_keys = set()
        want = min(max(1, children_per_gen), n_trials - len(all_configs))
        for _ in range(64 * want):
            if len(brood) >= want:
                break
            pa = all_configs[tournament()]
            pb = all_configs[tournament()]
            c = space.mutate(space.crossover(pa, pb, rng), rng)
            key = c.encode()
            if key not in tried and key not in brood_keys:
                brood.append(c)
                brood_keys.add(key)
        if len(brood) < want:
            extra = space.sample(rng, want - len(brood),
                                 exclude=set(tried) | brood_keys)
            brood += extra
            if not brood:
                break
        ys_brood = np.asarray(fbatch(brood), dtype=float)
        new_idx = []
        for child, y in zip(brood, ys_brood):
            tried[child.encode()] = len(all_configs)
            new_idx.append(len(all_configs))
            all_configs.append(child)
            all_ys = np.vstack([all_ys, y[None, :]])
            if np.all(np.isfinite(y)):
                tracker.add(_log_rows(y))
            hv_history.append(tracker.hv)

        # environmental selection on the union
        union = pop_idx + new_idx
        uys = all_ys[union]
        fronts = _fast_nondominated_sort(uys)
        new_pop: list[int] = []
        for f in fronts:
            if len(new_pop) + len(f) <= pop_size:
                new_pop += [union[i] for i in f]
            else:
                c = _crowding(uys, f)
                rest = sorted(f, key=lambda i: -c[i])
                new_pop += [union[i] for i in rest[: pop_size - len(new_pop)]]
                break
        pop_idx = new_pop

    return DSEResult(all_configs, all_ys, hv_history, len(all_configs), ref)
