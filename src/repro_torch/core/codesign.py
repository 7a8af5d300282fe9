"""The HASCO co-design flow (paper §III, Fig. 3).

  Step 1  HW/SW partitioning — tensorize choices from TST matching.
  Step 2  Solution generation — hardware DSE (MOBO over accelerator
          parameters, objective = best-software latency / power / area) and
          software DSE (heuristic + Q-learning) per workload.
  Step 3  Solution tuning — pick Pareto points meeting the user constraints;
          if none satisfy them, extend the hardware DSE with more trials.

Baselines implemented alongside (paper §VII-D/E):
  * ``separate_design``  — hardware picked with a default/naive software
    mapping (the traditional decoupled methodology of Table III).
  * ``library_schedule`` — im2col-style fixed library mapping (Fig. 11).
  * ``template_search``  — AutoTVM-style: fixed tensorize choice + source
    loop order, only tile sizes explored (Fig. 11).
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass

import numpy as np

from repro_torch import obs

from . import sw_dse
from .hw_primitives import HWConfig
from .hw_space import HWSpace
from .matching import TensorizeChoice, partition_space
from .intrinsics import ALL_INTRINSICS
from .mobo import DSEResult, mobo
from .qlearning import resolve_device
from .sw_primitives import Schedule
from .sw_space import SoftwareSpace
from .tst import TensorExpr


@dataclass
class Constraints:
    """User constraints from the input description (paper Fig. 3)."""

    latency_s: float = math.inf
    power_w: float = math.inf
    area_um2: float = math.inf

    def as_bounds(self) -> dict[int, float]:
        out: dict[int, float] = {}
        if math.isfinite(self.latency_s):
            out[0] = self.latency_s
        if math.isfinite(self.power_w):
            out[1] = self.power_w
        if math.isfinite(self.area_um2):
            out[2] = self.area_um2
        return out


@dataclass
class Solution:
    """A holistic solution: one accelerator shared by the application, one
    schedule (+ interface) per workload (paper §III)."""

    hw: HWConfig
    schedules: dict[str, Schedule]
    latency_s: float
    power_w: float
    area_um2: float
    intrinsic: str

    def describe(self) -> str:
        return (f"{self.intrinsic}: pe={self.hw.pe_rows}x{self.hw.pe_cols}"
                f"x{self.hw.pe_depth} vmem={self.hw.vmem_kib}KiB "
                f"banks={self.hw.banks} df={self.hw.dataflow} | "
                f"lat={self.latency_s:.4e}s pow={self.power_w:.2f}W "
                f"area={self.area_um2:.3e}um2")


@dataclass
class CodesignReport:
    solution: Solution | None
    per_intrinsic: dict[str, DSEResult]
    partition_sizes: dict[tuple[str, str], int]
    evaluations: int
    cache_stats: dict | None = None
    # measured-autotuning extras (measure=True): per-intrinsic measurement
    # summaries, the fitted per-op Calibration, and where the tuning DB went
    measured: dict | None = None
    calibration: object | None = None
    db_path: object | None = None


def hw_objectives(workloads: list[TensorExpr], partition, intrinsic: str,
                  *, target: str = "spatial", seed: int = 0,
                  sw_budget: str = "small", cache=None,
                  engine: str = "batched", device="cuda"):
    """The paper's correlated objective: evaluating a hardware point runs the
    software DSE and reports the *achieved* latency plus power/area.

    Scalar protocol — one config per call; :func:`hw_objectives_batch` is the
    production form the MOBO loop uses.  ``cache`` (an
    :class:`~repro.core.cost_model.EvalCache`) is threaded into the inner
    software DSE and the final per-schedule rescore, so hardware points
    probed by several explorers — or re-refined at a bigger software budget
    in Step 3 — never re-derive a (hw, schedule) evaluation.
    """
    fbatch = hw_objectives_batch(workloads, partition, intrinsic,
                                 target=target, seed=seed,
                                 sw_budget=sw_budget, cache=cache,
                                 engine=engine, device=device)

    def f(hw: HWConfig) -> tuple[float, float, float]:
        return tuple(fbatch([hw])[0])

    return f


def hw_objectives_batch(workloads: list[TensorExpr], partition,
                        intrinsic: str, *, target: str = "spatial",
                        seed: int = 0, sw_budget: str = "small", cache=None,
                        engine: str = "batched", device="cuda"):
    """Batched hardware objectives (DESIGN.md §10): score a whole population
    of hardware candidates — a ``mobo(q=N)`` trial's picks, or the initial
    design — by resolving all ``len(configs) × len(workloads)`` software
    searches in ONE lock-step engine pass, then rescoring every winning
    schedule's energy through one batched cost-model call per workload."""
    from .cost_model import TARGETS, accelerator_area, evaluate_batch_reports

    tgt = TARGETS[target]

    def fbatch(configs) -> np.ndarray:
        configs = list(configs)
        specs: list[sw_dse.SearchSpec] = []
        owners: list[tuple[int, str]] = []
        for ci, hw in enumerate(configs):
            for n, w in enumerate(workloads):
                choices = partition.get((w.name, hw.intrinsic), [])
                if choices:
                    specs.append(sw_dse.SearchSpec(w, choices, hw,
                                                   seed + 17 * n))
                    owners.append((ci, w.name))
        results = sw_dse.run_searches(specs, target=target, cache=cache,
                                      engine=engine, device=device,
                                      **sw_dse.BUDGETS[sw_budget])
        per_config: list[dict[str, sw_dse.SWResult]] = \
            [{} for _ in configs]
        for (ci, wname), r in zip(owners, results):
            per_config[ci][wname] = r

        # energy rescore of every config's winning schedules: one batched
        # cost-model pass per workload over all configs (cache-hot anyway —
        # each schedule was just evaluated by its own search)
        rescore: dict[str, tuple] = {}
        for ci, res in enumerate(per_config):
            if set(res) != {w.name for w in workloads}:
                continue
            for w in workloads:
                g = rescore.setdefault(w.name, (w, [], [], []))
                g[1].append(configs[ci])
                g[2].append(res[w.name].schedule)
                g[3].append(ci)
        reps_of: dict[tuple[int, str], object] = {}
        for w, hws, scheds, cis in rescore.values():
            reps = evaluate_batch_reports(w, hws, scheds, target, cache=cache)
            for ci, rep in zip(cis, reps):
                reps_of[(ci, w.name)] = rep

        ys = np.full((len(configs), 3), math.inf)
        for ci, (hw, res) in enumerate(zip(configs, per_config)):
            if set(res) != {w.name for w in workloads}:
                continue
            lat = sw_dse.total_latency(res)
            e_tot = 0.0
            for w in workloads:
                rep = reps_of[(ci, w.name)]
                if not rep.legal:
                    break
                e_tot += rep.energy_j
            else:
                ys[ci] = (lat, e_tot / max(lat, 1e-12),
                          accelerator_area(hw, tgt))
        return ys

    return fbatch


def codesign(workloads: list[TensorExpr], *, intrinsics: list[str] = None,
             constraints: Constraints = None, target: str = "spatial",
             n_trials: int = 20, n_init: int = 5, seed: int = 0, q: int = 1,
             max_dse_extensions: int = 0, engine: str = "batched",
             sw_budget: str = "small", space_axes: dict | None = None,
             cache=None, measure: bool = False,
             measure_backend: str = "cuda", measure_top_k: int = 3,
             measure_opts=None, db_path=None, app: str = "default",
             checkpoint_dir=None, resume_from=None,
             device="cuda") -> CodesignReport:
    """Full HASCO flow over one application (= workload set).

    One :class:`~repro.core.cost_model.EvalCache` is shared across the whole
    run — every intrinsic's hardware DSE, its inner software DSE, and the
    Step-3 full-budget refinement — so identical (hw, schedule) points probed
    in different steps are evaluated exactly once.

    ``q`` is the MOBO suggestion batch size (DESIGN.md §9): each hardware-DSE
    trial proposes ``q`` configs and scores them with one batched objectives
    call, which resolves the trial's q × len(workloads) software searches in
    a single lock-step engine pass (DESIGN.md §10; ``engine="reference"``
    keeps the sequential per-search path with identical same-seed results).
    ``max_dse_extensions`` enables the paper's constraint-
    driven Step-3 extension: when no explored point satisfies the user
    constraints, the hardware DSE is re-run with a doubled trial budget (up
    to that many doublings) — the shared cache makes every previously-probed
    point free, so an extension only pays for the *new* trials.

    With ``measure=True``, Step 3 closes the loop on measured truth: the
    top-``measure_top_k`` constraint-feasible Pareto candidates of each
    intrinsic are refined at full software budget, their per-workload
    schedules are lowered to the hand-written CUDA kernels
    (``tuner/measure.py``, backend ``measure_backend``: ``"cuda"`` on the
    card, ``"torch"`` for the plain versions on the CPU) and timed, and the
    committed Solution is the candidate with the lowest *measured* total
    latency (workloads without a kernel lowering fall back to their
    analytical latency).  All (analytical, measured) pairs feed a per-op
    calibration fit; records + calibration are persisted to ``db_path``
    (a tuning database, ``tuner/db.py``) when given.  Candidates the DB has
    *quarantined* (persistently failing kernels) are skipped unrun, and
    newly retry-exhausted failures join the quarantine on persist.

    The software DSE's DQNs run on ``device`` (the card by default; asking
    for it where there is none raises).

    With ``checkpoint_dir``, one payload checkpoint is written per
    completed intrinsic (``ft.CheckpointManager.save_payload``); with
    ``resume_from``, the newest clean payload of a run with the same
    signature (workloads and every search parameter) is restored and its
    completed intrinsics are skipped, so a killed run resumes to the same
    committed solution (bit for bit where the flow is analytical; with
    ``measure=True`` a round that runs again times its kernels again).  A
    foreign checkpoint warns and starts fresh, as does an empty directory
    (silently).
    """
    resolve_device(device)
    with obs.span("codesign.run",
                  {"workloads": [w.name for w in workloads],
                   "n_trials": n_trials, "q": q, "measure": measure}
                  if obs.enabled() else None):
        return _codesign_body(
            workloads, intrinsics=intrinsics, constraints=constraints,
            target=target, n_trials=n_trials, n_init=n_init, seed=seed, q=q,
            max_dse_extensions=max_dse_extensions, engine=engine,
            sw_budget=sw_budget, space_axes=space_axes, cache=cache,
            measure=measure, measure_backend=measure_backend,
            measure_top_k=measure_top_k, measure_opts=measure_opts,
            db_path=db_path, app=app, checkpoint_dir=checkpoint_dir,
            resume_from=resume_from, device=device)


def _codesign_signature(workloads, intrinsics, constraints, target, n_trials,
                        n_init, seed, q, max_dse_extensions, engine,
                        sw_budget, space_axes, measure, measure_backend,
                        measure_top_k) -> tuple:
    """What makes two codesign invocations "the same run" for resume: the
    workload identities and every parameter that steers the search.  A
    checkpoint whose signature differs must not be resumed (it would splice
    state from a different trajectory into this one)."""
    from .cost_model import _fingerprint

    return (tuple(_fingerprint(w) for w in workloads),
            tuple(i.upper() for i in intrinsics),
            (constraints.latency_s, constraints.power_w,
             constraints.area_um2),
            target, n_trials, n_init, seed, q, max_dse_extensions, engine,
            sw_budget, repr(sorted((space_axes or {}).items())),
            measure, measure_backend, measure_top_k)


def _codesign_body(workloads: list[TensorExpr], *, intrinsics, constraints,
                   target, n_trials, n_init, seed, q, max_dse_extensions,
                   engine, sw_budget, space_axes, cache, measure,
                   measure_backend, measure_top_k, measure_opts, db_path,
                   app, checkpoint_dir, resume_from, device
                   ) -> CodesignReport:
    from .cost_model import EvalCache

    intrinsics = intrinsics or ["GEMM", "GEMV", "DOT", "CONV2D"]
    constraints = constraints or Constraints()
    cache = cache if cache is not None else EvalCache()

    quarantine: set[str] = set()
    if measure:
        from repro_torch.tuner.measure import MeasureOptions
        measure_opts = measure_opts or MeasureOptions(backend=measure_backend)
        if db_path is not None:
            from repro_torch.tuner.db import TuningDB
            quarantine = TuningDB.load(db_path).quarantined_keys()

    # Step 1: partition space
    intr_tsts = [ALL_INTRINSICS[i.upper()] for i in intrinsics]
    partition = partition_space(intr_tsts, workloads)
    sizes = {k: len(v) for k, v in partition.items()}

    per_intrinsic: dict[str, DSEResult] = {}
    evals = 0
    best: Solution | None = None
    best_rank: tuple[int, float] | None = None
    measured_summary: dict[str, dict] = {}
    calib_samples: list = []
    measure_points: list = []   # (workload, rep, MeasureResult) for the DB
    measure_failures: list = []  # failure dicts for the DB's diagnostics

    # periodic checkpoint + resume (DESIGN.md §14): one payload checkpoint
    # per completed intrinsic; resume restores the newest clean one
    sig = _codesign_signature(workloads, intrinsics, constraints, target,
                              n_trials, n_init, seed, q, max_dse_extensions,
                              engine, sw_budget, space_axes, measure,
                              measure_backend, measure_top_k)
    completed: set[str] = set()
    ckpt = None
    if checkpoint_dir is not None:
        from repro_torch.ft import CheckpointManager
        ckpt = CheckpointManager(checkpoint_dir, keep=8)
    if resume_from is not None:
        from repro_torch.ft import CheckpointManager
        state = CheckpointManager(resume_from, keep=8).restore_payload()
        if state is None:
            pass   # nothing restorable: start fresh
        elif state.get("signature") != sig:
            warnings.warn("codesign resume: checkpoint signature does not "
                          "match this invocation; starting fresh",
                          stacklevel=3)
        else:
            completed = set(state["done"])
            per_intrinsic.update(state["per_intrinsic"])
            evals = state["evals"]
            best, best_rank = state["best"], state["best_rank"]
            measured_summary.update(state["measured_summary"])
            calib_samples.extend(state["calib_samples"])
            measure_points.extend(state["measure_points"])
            measure_failures.extend(state["measure_failures"])
            cache._data.update(state["cache_data"])

    for intrinsic in intrinsics:
        intrinsic = intrinsic.upper()
        if intrinsic in completed:   # resumed past this one
            continue
        # the intrinsic must cover every workload of the application
        if not all((w.name, intrinsic) in partition for w in workloads):
            continue
        with obs.span("codesign.intrinsic",
                      {"intrinsic": intrinsic} if obs.enabled() else None):
            space = HWSpace(intrinsic)
            if space_axes:
                space = HWSpace(intrinsic, axes={**space.axes, **space_axes})
            fb = hw_objectives_batch(workloads, partition, intrinsic,
                                     target=target, seed=seed,
                                     sw_budget=sw_budget, cache=cache,
                                     engine=engine, device=device)
            # scalar fallback view of the same batch objective (mobo only calls
            # it when batch_objectives is absent, i.e. never here)
            f = lambda hw: tuple(fb([hw])[0])
            with obs.span("codesign.hw_dse"):
                res = mobo(space, f, batch_objectives=fb, n_init=n_init,
                           n_trials=n_trials, seed=seed, q=q)
            bounds = constraints.as_bounds()
            for ext in range(1, max_dse_extensions + 1):
                if not bounds or res.best_under(bounds) is not None:
                    break
                # constraint-driven extension (paper Fig. 3 Step 3): nothing on
                # the frontier meets the constraints, so widen the search
                with obs.span("codesign.hw_dse_extension"):
                    res = mobo(space, f, batch_objectives=fb, n_init=n_init,
                               seed=seed, q=q, n_trials=n_trials * (2 ** ext))
            per_intrinsic[intrinsic] = res
            evals += res.evaluations

            if not measure:
                pick = res.best_under(constraints.as_bounds())
                if pick is not None:
                    hw, y = pick
                    # Step 3: refine the chosen point at full software
                    # budget — the shared cache makes every Step-2 probe
                    # of this point free
                    with obs.span("codesign.refine"):
                        results = sw_dse.optimize_set(
                            workloads, partition, hw, target=target,
                            seed=seed, budget="full", cache=cache,
                            engine=engine, device=device)
                    lat = sw_dse.total_latency(results)
                    sol = Solution(hw,
                                   {k: r.schedule for k, r in results.items()},
                                   min(lat, y[0]), y[1], y[2], intrinsic)
                    if best is None or sol.latency_s < best.latency_s:
                        best = sol
            else:
                # Step 3 (measured): re-rank the feasible frontier by real
                # kernels
                with obs.span("codesign.measure_rerank"):
                    sol, rank, summary = _measure_rerank(
                        workloads, partition, res, constraints, intrinsic,
                        target, seed, cache, measure_opts, measure_top_k,
                        calib_samples, measure_points, measure_failures,
                        engine=engine, quarantine=quarantine, device=device)
                if summary:
                    measured_summary[intrinsic] = summary
                if sol is not None and (best is None or rank < best_rank):
                    best, best_rank = sol, rank

        completed.add(intrinsic)
        if ckpt is not None:
            # everything a resumed run needs to continue to a bit-identical
            # committed solution, pickled atomically per intrinsic round
            ckpt.save_payload(len(completed), {
                "signature": sig, "done": sorted(completed),
                "per_intrinsic": per_intrinsic, "evals": evals,
                "best": best, "best_rank": best_rank,
                "measured_summary": measured_summary,
                "calib_samples": calib_samples,
                "measure_points": measure_points,
                "measure_failures": measure_failures,
                "cache_data": dict(cache._data)})

    calibration = None
    saved_db = None
    if measure:
        from repro_torch import tuner as _tuner
        calibration = _tuner.calibrate.fit(calib_samples)
        if db_path is not None:
            saved_db = _persist_tuning(db_path, app, best, calibration,
                                       measure_points, measure_failures)

    st = obs.state()
    if st is not None:
        cs = cache.stats()
        st.metrics.gauge("evalcache.entries").set(cs["entries"])
        st.metrics.gauge("evalcache.hits").set(cs["hits"])
        st.metrics.gauge("evalcache.misses").set(cs["misses"])

    return CodesignReport(best, per_intrinsic, sizes, evals, cache.stats(),
                          measured_summary or None, calibration, saved_db)


def _measure_rerank(workloads, partition, res: DSEResult,
                    constraints: Constraints, intrinsic: str, target: str,
                    seed: int, cache, measure_opts, top_k: int,
                    calib_samples: list, measure_points: list,
                    measure_failures: list, engine: str = "batched",
                    quarantine: set[str] | None = None, device="cuda"
                    ) -> tuple[Solution | None, tuple[int, float] | None,
                               dict]:
    """Measured Step 3 for one intrinsic: refine the top feasible candidates
    at full software budget, time their kernels, commit to measured truth."""
    from repro_torch.tuner import calibrate as C
    from repro_torch.tuner import measure as M

    from .cost_model import evaluate

    bounds = constraints.as_bounds()
    ok = np.ones(len(res.ys), dtype=bool)
    for i, bound in bounds.items():
        ok &= res.ys[:, i] <= bound
    order = np.argsort(np.where(ok, res.ys[:, 0], math.inf))
    cand_idx = [int(i) for i in order[:top_k] if ok[i]]
    if not cand_idx:
        return None, None, {}

    best_sol: Solution | None = None
    best_rank: tuple[int, float] | None = None
    n_measured = n_fallback = n_quarantined = n_illegal = 0
    for i in cand_idx:
        hw, y = res.configs[i], res.ys[i]
        results = sw_dse.optimize_set(workloads, partition, hw, target=target,
                                      seed=seed, budget="full", cache=cache,
                                      engine=engine, device=device)
        if set(r for r in results) != {w.name for w in workloads}:
            continue
        total = 0.0
        cand_fallbacks = 0
        for w in workloads:
            sched = results[w.name].schedule
            rep = evaluate(w, sched, hw, target, cache=cache)
            mres = M.measure_one(w, hw, sched, measure_opts, quarantine)
            if mres.ok and rep.legal:
                total += mres.latency_s
                n_measured += 1
                calib_samples.extend(C.collect_samples(w, [rep], [mres]))
                measure_points.append((w, rep, mres))
            else:  # no lowering / failed run: analytical latency stands in
                total += rep.latency_s
                cand_fallbacks += 1
                if mres.error_type == "Quarantined":
                    n_quarantined += 1   # skipped unrun, not a new failure
                elif mres.error_type == "Illegal":
                    # statically rejected by the legality verifier ahead of
                    # lowering (DESIGN.md §16.2): counted, but never recorded
                    # as a failure — no kernel ever ran, so there is nothing
                    # to retry or quarantine
                    n_illegal += 1
                elif mres.error:
                    measure_failures.append({
                        "workload": w.name, "intrinsic": intrinsic,
                        "backend": measure_opts.backend,
                        "error_type": mres.error_type, "error": mres.error,
                        "elapsed_s": mres.elapsed_s,
                        # only retry-exhausted kernel runs carry a point;
                        # its key is what _persist_tuning quarantines
                        "key": (M.quarantine_key(mres.point)
                                if mres.point is not None else "")})
        n_fallback += cand_fallbacks
        # rank lexicographically by (fallback count, total): analytical
        # stand-ins live on a different scale than wall-clock measurements,
        # so a candidate that could not be measured must never displace one
        # that was — fallback totals only compare against each other
        rank = (cand_fallbacks, total)
        sol = Solution(hw, {k: r.schedule for k, r in results.items()},
                       total, y[1], y[2], intrinsic)
        if best_rank is None or rank < best_rank:
            best_sol, best_rank = sol, rank
    summary = {"candidates": len(cand_idx), "measured": n_measured,
               "fallbacks": n_fallback, "quarantined": n_quarantined,
               "illegal": n_illegal,
               "best_measured_total_s":
                   best_sol.latency_s if best_sol else math.inf,
               # True when the committed candidate's total mixes analytical
               # stand-ins with wall-clock measurements: downstream consumers
               # must not read best_measured_total_s as measured truth then
               "best_has_fallbacks":
                   bool(best_rank[0] > 0) if best_rank else False}
    return best_sol, best_rank, summary


def _persist_tuning(db_path, app: str, best: Solution | None, calibration,
                    measure_points: list, measure_failures: list = ()):
    """Write measured records + calibration + failure diagnostics (+ the
    winning app solution) into the tuning database at ``db_path``
    (merge-on-save, atomic)."""
    from dataclasses import asdict

    from repro_torch.tuner.db import TuningDB, TuningRecord

    db = TuningDB.load(db_path)
    for w, rep, mres in measure_points:
        pt = mres.point
        if pt is None:
            continue
        db.record(TuningRecord(pt.op, pt.shape, pt.dtype, pt.backend,
                               pt.block_map, mres.latency_s, rep.latency_s,
                               app))
    db.add_failures({**f, "app": app} for f in measure_failures)
    # retry-exhausted kernel candidates (they carry a quarantine key) join
    # the persistent quarantine: future runs skip them unrun
    for f in measure_failures:
        key = f.get("key", "")
        if key:
            db.quarantine_candidate(key, {
                "app": app, "workload": f.get("workload", ""),
                "error_type": f.get("error_type", ""),
                "error": str(f.get("error", ""))[:200]})
    db.set_calibration(calibration)
    if best is not None:
        db.set_app(app, {
            "hw": asdict(best.hw), "intrinsic": best.intrinsic,
            "latency_s": best.latency_s, "power_w": best.power_w,
            "area_um2": best.area_um2,
        })
    return db.save(db_path)


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------

def separate_design(workloads: list[TensorExpr], hw: HWConfig, *,
                    target: str = "spatial", seed: int = 0,
                    tuned_software: bool = True, cache=None) -> Solution:
    """The traditional decoupled flow (Table III baseline): the accelerator
    ``hw`` was fixed without feedback from software DSE; software is then
    tuned (AutoTVM-style if ``tuned_software``) for that fixed hardware."""
    from .cost_model import TARGETS, accelerator_area, evaluate

    intr = ALL_INTRINSICS[hw.intrinsic]
    partition = partition_space([intr], workloads)
    schedules: dict[str, Schedule] = {}
    lat = 0.0
    e_tot = 0.0
    for w in workloads:
        choices = partition.get((w.name, hw.intrinsic))
        if not choices:
            return Solution(hw, {}, math.inf, math.inf,
                            accelerator_area(hw, TARGETS[target]), hw.intrinsic)
        if tuned_software:
            r = template_search(w, choices[0], hw, target=target, seed=seed,
                                cache=cache)
            schedules[w.name] = r
        else:
            schedules[w.name] = SoftwareSpace(w, choices, hw, target).default_schedule()
        rep = evaluate(w, schedules[w.name], hw, target, cache=cache)
        lat += rep.latency_s
        e_tot += rep.energy_j if rep.legal else math.inf
    area = accelerator_area(hw, TARGETS[target])
    return Solution(hw, schedules, lat, e_tot / max(lat, 1e-12), area,
                    hw.intrinsic)


def template_search(workload: TensorExpr, choice: TensorizeChoice,
                    hw: HWConfig, *, target: str = "spatial", seed: int = 0,
                    budget: int = 64, cache=None) -> Schedule:
    """AutoTVM-style fixed-template tuning (paper §VII-D): the tensorize
    choice and loop order are fixed by the template author; only the sizes of
    tensorized sub-workloads (tile factors) are explored.  The whole tile
    population is scored with one batched cost-model call."""
    from .cost_model import evaluate_batch

    rng = np.random.default_rng(seed)
    ext = workload.extents
    mapped = list(choice.mapped_compute_indices)
    order = tuple(workload.all_indices())  # source order: template-fixed

    def random_tiles() -> tuple[tuple[str, int], ...]:
        ts = []
        for c in mapped:
            hi = int(math.log2(max(1, ext[c])))
            ts.append((c, min(ext[c], 1 << int(rng.integers(0, hi + 1)))))
        return tuple(sorted(ts))

    population = [Schedule(choice, random_tiles(), order, 0)
                  for _ in range(budget)]
    lats = evaluate_batch(workload, hw, population, target, cache=cache)[:, 0]
    return population[int(np.argmin(lats))]


def human_template_choice(workload: TensorExpr,
                          choices: list[TensorizeChoice]) -> TensorizeChoice:
    """The choice a template author would write by hand: maximize the compute
    the intrinsic covers (product of mapped loop extents), untransposed."""
    def score(c):
        prod = 1
        for l in c.mapped_compute_indices:
            prod *= workload.extents[l]
        return (prod, not c.transposed)
    return max(choices, key=score)


HOST_DMA_GBPS = 2.0   # im2col/col2im run host-side (Gemmini library [24]):
# the expansion is materialized through the host DMA path, not accelerator
# HBM — this is exactly why the paper's Fig. 11 shows the conversion
# dominating whole-layer latency.


def library_schedule(workload: TensorExpr, hw: HWConfig,
                     target: str = "spatial"):
    """The im2col library mapping (paper §VII-D, [24]): convert the
    convolution to one big GEMM (unfold operands), then split by the array
    shape.  Models the im2col/col2im traffic overhead explicitly:
    the unfolded matrix ``A'[c·r·s, x·y]`` is materialized host-side (one
    write + read of the expanded operand) and the output is folded back."""
    from .cost_model import DTYPE_BYTES, TARGETS, evaluate
    from .matching import match
    from .intrinsics import GEMM
    from .workloads import gemm as make_gemm

    tgt = TARGETS[target]
    ext = workload.extents
    if set(ext) >= {"k", "c", "x", "y", "r", "s"}:  # a convolution
        gm = make_gemm(ext["k"], ext["x"] * ext["y"], ext["c"] * ext["r"] * ext["s"],
                       name=f"{workload.name}_im2col")
        expanded = (ext["c"] * ext["r"] * ext["s"] * ext["x"] * ext["y"]
                    * DTYPE_BYTES)
        folded = ext["k"] * ext["x"] * ext["y"] * DTYPE_BYTES
        # write + read of A' at im2col, write + read of L at col2im
        conv_overhead_s = 2.0 * (expanded + folded) / (HOST_DMA_GBPS * 1e9)
    else:
        gm, conv_overhead_s = workload, 0.0

    choices = match(GEMM, gm)
    space = SoftwareSpace(gm, choices, hw, target)
    sched = space.default_schedule()
    # the library splits by array shape & scratchpad: grow tiles while legal
    for loop in list(sched.tile_map):
        while True:
            bigger = sched.with_tile(loop, min(gm.extents[loop],
                                               sched.tile_map[loop] * 2))
            if bigger.tile_map[loop] == sched.tile_map[loop]:
                break
            if not evaluate(gm, bigger, hw, target).legal:
                break
            sched = bigger
    rep = evaluate(gm, sched, hw, target)
    return sched, rep.latency_s + conv_overhead_s, conv_overhead_s
