"""Software DSE driver (paper §VI-B, Fig. 5(a)):

  initialize a candidate pool of random primitive sequences  →  repeat:
  heuristic top-k picks valuable candidates  →  Q-learning picks the most
  promising revision choice per candidate  →  evaluate, learn, iterate.

Two engines share these semantics (DESIGN.md §10):

  * ``engine="reference"`` — :func:`optimize` per search, sequentially.  One
    software space, one DQN, one candidate pool; the round's frontier is
    still scored through the batched cost model (DESIGN.md §4.3), but every
    search pays its own DQN forwards, per-transition train steps, and
    cost-model calls.
  * ``engine="batched"``  — :func:`run_searches` advances N searches (all
    workloads of a hardware candidate × all candidates of a ``mobo(q=N)``
    batch) round-by-round in lock-step: one stacked feature array, one
    DQN-bank selection pass and one DQN-bank train pass cover every search,
    and one cost-model pass per distinct workload scores the union of every
    search's revision frontier and refill.

Each lock-step search keeps its own RNG streams and its own DQN slot (the
paper reuses a DQN within one software space, i.e. per (workload, hw) pair),
so the batched engine reproduces the reference results bit-for-bit
(``tests/test_torch_qlearning.py`` asserts it).  The DQNs run on the
caller's ``device``.  An optional
:class:`~repro_torch.core.cost_model.EvalCache` makes
re-probed (hw, schedule) points free across rounds, budget tiers, engines,
and co-design steps.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from repro_torch import obs

from .cost_model import EvalCache, _fingerprint, evaluate_batch_reports
from .heuristic import top_k
from .hw_primitives import HWConfig
from .matching import TensorizeChoice
from .qlearning import DQN, DQNBank
from .sw_primitives import Schedule
from .sw_space import SoftwareSpace
from .tst import TensorExpr


# software-DSE budget tiers (paper §VI-B: Step-2 probes are cheap, the
# committed Step-3 refinement runs the full search)
BUDGETS = {"small": dict(pool_size=12, rounds=4, k=4),
           "full": dict(pool_size=24, rounds=12, k=6)}


@dataclass
class SWResult:
    schedule: Schedule
    latency_s: float
    evaluations: int
    history: list[float] = field(default_factory=list)  # best-so-far curve


@dataclass
class SearchSpec:
    """One software search: a workload to schedule on one accelerator."""

    workload: TensorExpr
    choices: list[TensorizeChoice]
    hw: HWConfig
    seed: int = 0


def optimize(workload: TensorExpr, choices: list[TensorizeChoice],
             hw: HWConfig, *, target: str = "spatial", pool_size: int = 24,
             rounds: int = 12, k: int = 6, seed: int = 0,
             dqn: DQN | None = None, use_qlearning: bool = True,
             cache: EvalCache | None = None, device="cuda") -> SWResult:
    """Find a low-latency schedule for one workload on one accelerator.

    This is the scalar reference engine: one search, sequential rounds,
    per-transition DQN train steps.  :func:`run_searches` advances many of
    these in lock-step with identical results.  ``device`` is where a DQN
    this call creates lives.
    """
    space = SoftwareSpace(workload, choices, hw, target, cache=cache)
    rng = np.random.default_rng(seed)

    pool: list[Schedule] = [space.default_schedule()]
    pool += [space.random_schedule(rng) for _ in range(pool_size - 1)]
    lat = [float(l) for l in space.latency_batch(pool)]
    evals = len(pool)
    history = [min(lat)]

    if use_qlearning and dqn is None:
        dqn = DQN(space.n_features, len(space.moves), seed=seed,
                  device=device)

    # fixed keep/refill split: ``top_k`` filters infeasible candidates, so
    # the kept set may come up short — the refill count stays constant (the
    # pool temporarily shrinks) to keep the reference and lock-step engines
    # on identical RNG streams
    n_keep = max(pool_size // 2, k)
    n_refill = pool_size - n_keep

    for _ in range(rounds):
        chosen = top_k(pool, lat, k)   # may be < k: only feasible candidates
        if chosen:
            # the round's whole revision frontier in three batched calls: one
            # feature stack, one DQN forward for every candidate, one
            # vectorized cost-model pass over every revised schedule
            feats = space.features_batch([pool[i] for i in chosen])
            if use_qlearning:
                acts = dqn.select_batch(feats)
            else:
                acts = rng.integers(len(space.moves), size=len(chosen))
            revised = [space.apply(pool[i], space.moves[int(a)], rng)
                       for i, a in zip(chosen, acts)]
            new_reports = space.report_batch(revised)
            evals += len(revised)
            if use_qlearning:
                next_feats = space.features_batch(revised,
                                                  reports=new_reports)
            for j, (i, s2) in enumerate(zip(chosen, revised)):
                l2 = float(new_reports[j].latency_s)
                if use_qlearning:
                    dqn.record(feats[j], int(acts[j]),
                               _reward(lat[i], l2), next_feats[j])
                    dqn.train_step()
                pool.append(s2)
                lat.append(l2)
        # keep the pool bounded: retain the most valuable feasible candidates
        # + a fixed count of fresh randoms
        keep = _keep_indices(pool, lat, n_keep)
        pool = [pool[i] for i in keep]
        lat = [lat[i] for i in keep]
        refill = [space.random_schedule(rng) for _ in range(n_refill)]
        if refill:
            lat += [float(l) for l in space.latency_batch(refill)]
            pool += refill
            evals += len(refill)
        history.append(min(lat) if lat else math.inf)

    best_i = int(np.argmin(lat))
    return SWResult(pool[best_i], lat[best_i], evals, history)


def _keep_indices(pool: list, lat: list[float], n_keep: int) -> list[int]:
    """Pool-bounding survivors: the most valuable feasible candidates; if
    the whole pool is infeasible, the newest ``n_keep`` survive instead so
    the search stays bounded without stalling on an empty pool.  Shared by
    both engines — part of the same-seed parity contract."""
    keep = top_k(pool, lat, n_keep)
    if not keep:
        keep = list(range(max(0, len(pool) - n_keep), len(pool)))
    return keep


def _reward(prev: float, new: float) -> float:
    """Relative-improvement reward of revising a candidate (paper Fig. 5)."""
    if math.isfinite(new) and math.isfinite(prev) and prev > 0:
        return float(np.clip((prev - new) / prev, -1.0, 1.0))
    return -1.0 if not math.isfinite(new) else 0.0


# ---------------------------------------------------------------------------
# Lock-step batched engine (DESIGN.md §10)
# ---------------------------------------------------------------------------


def _union_reports(spaces: list[SoftwareSpace],
                   sched_lists: list[list[Schedule]], target: str,
                   cache: EvalCache | None) -> list[list]:
    """CostReports for every search's schedules with one vectorized
    cost-model pass per *distinct workload* — searches sharing a workload
    (e.g. the same layer on q different hardware candidates) ride one call
    with per-row hardware configs."""
    groups: dict[tuple, tuple] = {}
    for si, (space, scheds) in enumerate(zip(spaces, sched_lists)):
        if not scheds:
            continue
        g = groups.setdefault(_fingerprint(space.workload),
                              (space.workload, [], [], []))
        for j, sched in enumerate(scheds):
            g[1].append(space.hw)
            g[2].append(sched)
            g[3].append((si, j))
    out: list[list] = [[None] * len(s) for s in sched_lists]
    for workload, hws, scheds, refs in groups.values():
        reps = evaluate_batch_reports(workload, hws, scheds, target,
                                      cache=cache)
        for (si, j), rep in zip(refs, reps):
            out[si][j] = rep
    return out


def run_searches(specs: list[SearchSpec], *, target: str = "spatial",
                 pool_size: int = 24, rounds: int = 12, k: int = 6,
                 use_qlearning: bool = True, cache: EvalCache | None = None,
                 engine: str = "batched", device="cuda") -> list[SWResult]:
    """Run N software searches, one :class:`SWResult` per spec.

    ``engine="batched"`` (production) advances all searches round-by-round in
    lock-step; ``engine="reference"`` runs :func:`optimize` per spec
    sequentially.  Same seeds ⇒ identical results either way.  The DQNs
    live on ``device``.
    """
    if engine not in ("batched", "reference"):
        raise ValueError(f"unknown software-DSE engine: {engine!r}")
    if not specs:
        return []
    k = min(k, pool_size)   # both engines must agree on the frontier size,
    # or the same-seed contract below breaks for degenerate k > pool_size
    if engine == "reference":
        return [optimize(sp.workload, sp.choices, sp.hw, target=target,
                         pool_size=pool_size, rounds=rounds, k=k,
                         seed=sp.seed, use_qlearning=use_qlearning,
                         cache=cache, device=device) for sp in specs]
    return _run_batched(specs, target=target, pool_size=pool_size,
                        rounds=rounds, k=k, use_qlearning=use_qlearning,
                        cache=cache, device=device)


def _run_batched(specs: list[SearchSpec], *, target: str, pool_size: int,
                 rounds: int, k: int, use_qlearning: bool,
                 cache: EvalCache | None, device) -> list[SWResult]:
    """The lock-step engine: per round, ONE stacked feature array, ONE
    DQN-bank selection pass, ONE multi-transition train pass, and one
    cost-model pass per distinct workload over the union of every
    search's revision frontier + refill."""
    with obs.span("sw_dse.run_searches",
                  {"n": len(specs), "rounds": rounds}
                  if obs.enabled() else None):
        return _run_batched_body(specs, target=target, pool_size=pool_size,
                                 rounds=rounds, k=k,
                                 use_qlearning=use_qlearning, cache=cache,
                                 device=device)


def _run_batched_body(specs: list[SearchSpec], *, target: str,
                      pool_size: int, rounds: int, k: int,
                      use_qlearning: bool,
                      cache: EvalCache | None, device) -> list[SWResult]:
    N = len(specs)
    spaces = [SoftwareSpace(sp.workload, sp.choices, sp.hw, target,
                            cache=cache) for sp in specs]
    rngs = [np.random.default_rng(sp.seed) for sp in specs]
    n_moves = len(spaces[0].moves)     # MAX_LOOPS-derived: same for every
    n_feat = spaces[0].n_features      # space, which is what lets one bank
    # serve heterogeneous searches

    # per-search report/feature memos: every schedule is evaluated exactly
    # once per search (the shared EvalCache additionally dedups across
    # searches probing identical (hw, schedule) points)
    repmaps: list[dict] = [{} for _ in range(N)]
    fmaps: list[dict] = [{} for _ in range(N)]

    def remember(si: int, scheds: list[Schedule], reps: list) -> list[float]:
        rm = repmaps[si]
        for s, rep in zip(scheds, reps):
            rm[s] = rep
        return [float(rep.latency_s) for rep in reps]

    def feat_of(si: int, sched: Schedule) -> np.ndarray:
        f = fmaps[si].get(sched)
        if f is None:
            f = spaces[si].features(sched, repmaps[si].get(sched))
            fmaps[si][sched] = f
        return f

    pools: list[list[Schedule]] = []
    for space, rng in zip(spaces, rngs):
        pools.append([space.default_schedule()]
                     + [space.random_schedule(rng)
                        for _ in range(pool_size - 1)])
    init_reps = _union_reports(spaces, pools, target, cache)
    lats = [remember(si, pools[si], init_reps[si]) for si in range(N)]
    evals = [pool_size] * N
    history = [[min(l)] for l in lats]

    bank = (DQNBank(n_feat, n_moves, [sp.seed for sp in specs],
                    device=device) if use_qlearning else None)
    n_keep = max(pool_size // 2, k)
    n_refill = pool_size - n_keep

    for _ in range(rounds):
        with obs.span("sw_dse.round"):
            # frontiers are feasible-only (top_k filters non-finite latencies),
            # so they may be ragged: search si revises m_si <= k candidates.
            # The stacked arrays stay (N, k, ...) — zero-padded rows feed the
            # network forward (no RNG) and are masked out of replay/training —
            # while every per-search RNG draw is sized m_si, exactly matching
            # the reference engine's stream.
            chosen = [top_k(pools[si], lats[si], k) for si in range(N)]
            counts = [len(c) for c in chosen]
            feats = np.zeros((N, k, n_feat), np.float32)
            for si in range(N):
                for j, i in enumerate(chosen[si]):
                    feats[si, j] = feat_of(si, pools[si][i])
            if use_qlearning:
                acts = bank.select_round(feats, counts=counts)
            else:
                acts = np.zeros((N, k), int)
                for si in range(N):
                    if counts[si]:
                        acts[si, :counts[si]] = rngs[si].integers(
                            n_moves, size=counts[si])
            revised = [[spaces[si].apply(pools[si][i], spaces[si].moves[int(a)],
                                         rngs[si])
                        for i, a in zip(chosen[si], acts[si][:counts[si]])]
                       for si in range(N)]
            refills = [[spaces[si].random_schedule(rngs[si])
                        for _ in range(n_refill)] for si in range(N)]
            # the round's entire evaluation demand — every search's frontier and
            # refill — in one union pass
            union = _union_reports(spaces,
                                   [revised[si] + refills[si] for si in range(N)],
                                   target, cache)
            new_lats = [remember(si, revised[si], union[si][:counts[si]])
                        for si in range(N)]
            refill_lats = [remember(si, refills[si], union[si][counts[si]:])
                           for si in range(N)]

            if use_qlearning:
                next_feats = np.zeros((N, k, n_feat), np.float32)
                rewards = np.zeros((N, k))
                for si in range(N):
                    for j, i in enumerate(chosen[si]):
                        next_feats[si, j] = feat_of(si, revised[si][j])
                        rewards[si, j] = _reward(lats[si][i], new_lats[si][j])
                with obs.span("sw_dse.train_round"):
                    bank.train_round(feats, acts, rewards, next_feats,
                                     counts=counts)

            for si in range(N):
                pools[si] += revised[si]
                lats[si] += new_lats[si]
                evals[si] += counts[si]
                keep = _keep_indices(pools[si], lats[si], n_keep)
                pools[si] = [pools[si][i] for i in keep]
                lats[si] = [lats[si][i] for i in keep]
                pools[si] += refills[si]
                lats[si] += refill_lats[si]
                evals[si] += n_refill
                history[si].append(min(lats[si]) if lats[si] else math.inf)

    out = []
    for si in range(N):
        best_i = int(np.argmin(lats[si]))
        out.append(SWResult(pools[si][best_i], lats[si][best_i], evals[si],
                            history[si]))
    return out


def optimize_set(workloads: list[TensorExpr],
                 partition: dict[tuple[str, str], list[TensorizeChoice]],
                 hw: HWConfig, *, target: str = "spatial", seed: int = 0,
                 budget: str = "small", dqn: DQN | None = None,
                 cache: EvalCache | None = None,
                 engine: str = "batched", device="cuda"
                 ) -> dict[str, SWResult]:
    """Per-workload schedules on a shared accelerator (paper §III: one
    accelerator per application, one program per workload).

    All workloads advance in lock-step through the batched engine by
    default; ``engine="reference"`` runs them sequentially with identical
    results.  Passing ``dqn`` keeps the legacy explicitly-shared-agent
    sequential path.
    """
    sizes = BUDGETS[budget]
    specs = [SearchSpec(w, partition[(w.name, hw.intrinsic)], hw,
                        seed + 17 * n)
             for n, w in enumerate(workloads)
             if partition.get((w.name, hw.intrinsic))]
    if dqn is not None:
        return {sp.workload.name:
                optimize(sp.workload, sp.choices, sp.hw, target=target,
                         seed=sp.seed, dqn=dqn, cache=cache, **sizes)
                for sp in specs}
    results = run_searches(specs, target=target, cache=cache, engine=engine,
                           device=device, **sizes)
    return {sp.workload.name: r for sp, r in zip(specs, results)}


def total_latency(results: dict[str, SWResult]) -> float:
    """Application latency: the sum over workloads (paper Table III runs
    whole CNNs through one accelerator)."""
    if not results:
        return math.inf
    return sum(r.latency_s for r in results.values())
