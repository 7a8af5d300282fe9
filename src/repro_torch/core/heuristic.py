"""Candidate-value heuristic (paper §VI-B, Fig. 5(d)).

The paper values a candidate ``p`` with latency ``l_p`` against the best
latency in history ``l*`` as ``exp(-(l* - l_p)/l*)``.  Taken literally that
rewards *worse* candidates (l_p > l* ⇒ value > 1); we use the evidently
intended sign, ``exp(-(l_p - l*)/l*)``, so the best candidate scores 1.0 and
worse candidates decay — the FlexTensor [85] convention the paper cites.
This deviation is recorded in EXPERIMENTS.md §Fidelity.
"""
from __future__ import annotations

import math


def candidate_value(latency: float, best_latency: float) -> float:
    if not math.isfinite(latency):
        return 0.0
    if best_latency <= 0:
        return 0.0
    return math.exp(-(latency - best_latency) / best_latency)


def top_k(pool: list, latencies: list[float], k: int) -> list[int]:
    """Indices of the (up to) k most valuable *feasible* candidates.

    Infeasible candidates (non-finite latency: illegal tiling, resource
    overflow) are filtered out entirely rather than padding the tail — a
    refine budget spent revising a known-illegal schedule is a wasted
    evaluation — so fewer than ``k`` indices come back when feasible
    candidates are scarce.  Callers must size downstream work by
    ``len(result)``, not ``k``.
    """
    best = min((l for l in latencies if math.isfinite(l)), default=math.inf)
    feasible = [i for i in range(len(pool)) if math.isfinite(latencies[i])]
    feasible.sort(key=lambda i: -candidate_value(latencies[i], best))
    return feasible[:k]
