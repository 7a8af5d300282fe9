"""The port's numpy core is the reference's, bit for bit.

``repro_torch`` keeps its own copies of the numpy-only modules (importing
any ``repro.core`` module imports JAX).  These tests hold the copies to the
reference: the source files differ only in their import lines, and on the
same numpy-seeded inputs the batched/scalar cost model, the Pareto and
hypervolume machinery, a seeded MOBO run and TST partitioning give exactly
the same numbers (``==``, no tolerance).
"""
import importlib
import math
import re
from pathlib import Path

import numpy as np
import pytest

import repro.core.cost_model as R_cost
import repro.core.hw_space as R_hws
import repro.core.intrinsics as R_intr
import repro.core.matching as R_match
import repro.core.pareto as R_pareto
import repro.core.sw_space as R_sws
import repro.core.workloads as R_W
import repro_torch.core.cost_model as T_cost
import repro_torch.core.hw_space as T_hws
import repro_torch.core.intrinsics as T_intr
import repro_torch.core.matching as T_match
import repro_torch.core.pareto as T_pareto
import repro_torch.core.sw_space as T_sws
import repro_torch.core.workloads as T_W

# the packages re-export a function named ``mobo`` over the submodule
R_mobo = importlib.import_module("repro.core.mobo")
T_mobo = importlib.import_module("repro_torch.core.mobo")
R_nsga2 = importlib.import_module("repro.core.nsga2")
T_nsga2 = importlib.import_module("repro_torch.core.nsga2")
R_rand = importlib.import_module("repro.core.random_search")
T_rand = importlib.import_module("repro_torch.core.random_search")

SRC = Path(__file__).resolve().parents[1] / "src"
# copied with only their imports rewritten (repro -> repro_torch)
VERBATIM = [
    "obs/__init__.py", "obs/trace.py", "obs/metrics.py", "obs/export.py",
    "ft/inject.py", "analysis/findings.py", "analysis/legality.py",
    "tuner/calibrate.py", "core/solution.py",
    *(f"core/{m}.py" for m in (
        "tst", "intrinsics", "workloads", "matching", "hw_primitives",
        "hw_space", "sw_primitives", "cost_model", "sw_space", "heuristic",
        "pareto", "surrogate", "mobo", "artifacts", "nsga2",
        "random_search")),
    "launch/paging.py", "analysis/kv_sanitizer.py",
]
_IMPORT = re.compile(r"^(\s*)(from|import) repro(?=[\s.])", re.M)
# the one other difference a copy may carry: a docstring's reference to
# the project's change history (the end of the parenthesis that follows
# "negatives — "), reworded
REWORDED = {"analysis/kv_sanitizer.py": (re.compile(r"(negatives — )[^)]*"),
                                         r"\1a known class of bug")}


@pytest.mark.parametrize("rel", VERBATIM)
def test_copied_module_differs_only_in_imports(rel):
    ref = (SRC / "repro" / rel).read_text()
    port = (SRC / "repro_torch" / rel).read_text()
    if rel in REWORDED:
        ref, n = REWORDED[rel][0].subn(REWORDED[rel][1], ref)
        assert n == 1
    assert _IMPORT.sub(r"\1\2 repro_torch", ref) == port


REPORT_FIELDS = ("latency_s", "energy_j", "power_w", "area_um2", "flops",
                 "useful_flops", "hbm_bytes", "compute_s", "memory_s",
                 "legal", "calls", "vmem_bytes", "why_illegal")


def _population(W, intr, hws, sws, match, kind, intrinsic, n, seed):
    wl = {"gemm": W.gemm(512, 256, 128), "conv": W.conv2d(64, 32, 28, 28),
          "ttm": W.ttm(128, 64, 64, 64)}[kind]
    rng = np.random.default_rng(seed)
    choices = match.match(intr.ALL_INTRINSICS[intrinsic], wl)
    hw_pool = hws.HWSpace(intrinsic).sample(rng, 8)
    space = sws.SoftwareSpace(wl, choices, hw_pool[0], "spatial")
    scheds = [space.random_schedule(rng) for _ in range(n)]
    hw_list = [hw_pool[int(rng.integers(len(hw_pool)))] for _ in range(n)]
    return wl, hw_list, scheds


def _same(a, b) -> bool:
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


@pytest.mark.parametrize("case", [("gemm", "GEMM"), ("gemm", "GEMV"),
                                  ("gemm", "DOT"), ("conv", "GEMM"),
                                  ("conv", "CONV2D"), ("ttm", "GEMM")])
@pytest.mark.parametrize("target", ["spatial", "tpu"])
def test_cost_model_bit_identical_on_random_populations(case, target):
    kind, intrinsic = case
    wr, hr, sr = _population(R_W, R_intr, R_hws, R_sws, R_match, kind,
                             intrinsic, 64, seed=0)
    wt, ht, st = _population(T_W, T_intr, T_hws, T_sws, T_match, kind,
                             intrinsic, 64, seed=0)
    assert [s.describe() for s in sr] == [s.describe() for s in st]
    rep_r = R_cost.evaluate_batch_reports(wr, hr, sr, target)
    rep_t = T_cost.evaluate_batch_reports(wt, ht, st, target)
    ys_r = R_cost.evaluate_batch(wr, hr, sr, target)
    ys_t = T_cost.evaluate_batch(wt, ht, st, target)
    np.testing.assert_array_equal(ys_r, ys_t)
    for i, (a, b) in enumerate(zip(rep_r, rep_t)):
        for f in REPORT_FIELDS:
            assert _same(getattr(a, f), getattr(b, f)), (i, f)
    for i in range(0, 64, 7):   # the scalar entry point too
        a = R_cost.evaluate(wr, sr[i], hr[i], target)
        b = T_cost.evaluate(wt, st[i], ht[i], target)
        assert all(_same(getattr(a, f), getattr(b, f)) for f in REPORT_FIELDS)


@pytest.mark.parametrize("d", [2, 3, 4])
def test_pareto_mask_and_hvi_bit_identical(d):
    rng = np.random.default_rng(d)
    pts = rng.uniform(0, 10, (40, d))
    pts[::5] = pts[1::5]                       # duplicates and ties
    np.testing.assert_array_equal(R_pareto.pareto_mask(pts),
                                  T_pareto.pareto_mask(pts))
    ref = np.full(d, 11.0)
    front = R_pareto.pareto_front(pts[:20])
    cands = rng.uniform(0, 10, (30, d))
    np.testing.assert_array_equal(
        R_pareto.hvi_batch(front, ref, cands, mc_samples=4096, seed=1),
        T_pareto.hvi_batch(front, ref, cands, mc_samples=4096, seed=1))
    assert R_pareto.hypervolume(pts, ref) == T_pareto.hypervolume(pts, ref)


def _cheap_objectives(hw):
    lat = 1.0 / (n := hw.pe_rows * hw.pe_cols) + hw.burst_bytes * 1e-9
    return (lat, n * 1e-3 + hw.vmem_kib * 1e-4, n * 10.0 + hw.vmem_kib * 5.0)


@pytest.mark.parametrize("q", [1, 3])
def test_seeded_mobo_bit_identical(q):
    res_r = R_mobo.mobo(R_hws.HWSpace("GEMM"), _cheap_objectives, n_init=4,
                        n_trials=10, seed=3, q=q)
    res_t = T_mobo.mobo(T_hws.HWSpace("GEMM"), _cheap_objectives, n_init=4,
                        n_trials=10, seed=3, q=q)
    assert [c.encode() for c in res_r.configs] == \
        [c.encode() for c in res_t.configs]
    np.testing.assert_array_equal(res_r.ys, res_t.ys)
    assert res_r.hv_history == res_t.hv_history
    assert res_r.evaluations == res_t.evaluations


@pytest.mark.parametrize("search,kw", [
    ("nsga2", dict(pop_size=5, n_trials=14, seed=3)),
    ("nsga2", dict(pop_size=4, n_trials=12, seed=1, children_per_gen=3)),
    ("random_search", dict(n_trials=12, seed=3)),
    ("random_search", dict(n_trials=9, seed=7, batch=True)),
], ids=["nsga2", "nsga2-batched-children", "random", "random-batched"])
def test_seeded_baseline_searches_bit_identical(search, kw):
    """The hardware-DSE baselines (NSGA-II, random search) commit the same
    points, objectives and hypervolume history at the same seed."""
    kw = dict(kw)
    if kw.pop("batch", False):
        kw["batch_objectives"] = lambda cfgs: [_cheap_objectives(c)
                                               for c in cfgs]
    mods = {"nsga2": (R_nsga2, T_nsga2), "random_search": (R_rand, T_rand)}
    r_mod, t_mod = mods[search]
    res_r = getattr(r_mod, search)(R_hws.HWSpace("GEMM"), _cheap_objectives,
                                   **kw)
    res_t = getattr(t_mod, search)(T_hws.HWSpace("GEMM"), _cheap_objectives,
                                   **kw)
    assert [c.encode() for c in res_r.configs] == \
        [c.encode() for c in res_t.configs]
    np.testing.assert_array_equal(res_r.ys, res_t.ys)
    assert res_r.hv_history == res_t.hv_history
    assert res_r.evaluations == res_t.evaluations
    np.testing.assert_array_equal(res_r.ref, res_t.ref)


def test_partition_space_counts_identical():
    def sizes(W, intr, match):
        wls = W.table1_gemm()[:4] + W.cnn_set("resnet")[:4] \
            + [W.gemv(256, 128), W.dot(4096), W.ttm(16, 16, 16, 16)]
        part = match.partition_space(list(intr.ALL_INTRINSICS.values()), wls)
        return {k: sorted(c.describe() for c in v) for k, v in part.items()}

    ref = sizes(R_W, R_intr, R_match)
    assert ref and ref == sizes(T_W, T_intr, T_match)
