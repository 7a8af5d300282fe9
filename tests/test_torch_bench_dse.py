"""The port's experiment scripts (``repro_torch.bench``) against the
reference's (``benchmarks/``) on the same inputs, on the CPU at small sizes.

``jax.random`` initialisation cannot be reproduced in torch, so every test
whose result goes through the DQN carries the reference's initial weights
across (``repro_torch.core.qlearning._init_bank`` monkeypatched, as in
``tests/test_torch_qlearning.py``).  From the same weights:

* numpy-only results (the batched-eval and acquisition parity values) are
  equal, and so are results that only rank what the DQN chose (Fig. 10's
  hypervolume curves);
* results through the DQN have equal decisions (the chosen schedule, the
  committed hardware, which method wins) and latencies within rtol 1e-6,
  the DQN's parity bar;
* wall-clock speed gates are not asserted on a loaded CPU, but the booleans
  that read structure are.

Every test calls ``run(...)`` or the scripts' helpers, never a reference
``main()``, so nothing writes the reference's ``artifacts/``.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:                  # the reference's benchmarks/
    sys.path.insert(0, str(ROOT))

import repro.core.qlearning as RQ                           # noqa: E402
import repro_torch.core.qlearning as TQ                     # noqa: E402
from benchmarks import ablation_qlearning as R_abl          # noqa: E402
from benchmarks import bench_acquisition as R_acq           # noqa: E402
from benchmarks import bench_batched_eval as R_bev          # noqa: E402
from benchmarks import bench_sw_dse as R_swb                # noqa: E402
from benchmarks import fig7_intrinsics as R_fig7            # noqa: E402
from benchmarks import fig10_hw_dse as R_fig10              # noqa: E402
from benchmarks import fig11_sw_dse as R_fig11              # noqa: E402
from benchmarks import table3_codesign as R_tab3            # noqa: E402
from repro_torch.bench import ablation_qlearning as T_abl   # noqa: E402
from repro_torch.bench import bench_acquisition as T_acq    # noqa: E402
from repro_torch.bench import bench_batched_eval as T_bev   # noqa: E402
from repro_torch.bench import bench_sw_dse as T_swb         # noqa: E402
from repro_torch.bench import fig7_intrinsics as T_fig7     # noqa: E402
from repro_torch.bench import fig10_hw_dse as T_fig10       # noqa: E402
from repro_torch.bench import fig11_sw_dse as T_fig11       # noqa: E402
from repro_torch.bench import table3_codesign as T_tab3     # noqa: E402

RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs files in parallel workers, where
    torch's default of a thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_init(seeds, sizes, device):
    """The reference's stacked initial DQN weights, as the port's tensors."""
    keys = jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds])
    tree = jax.tree_util.tree_map(np.asarray, RQ._bank_init(keys, sizes))
    return TQ.params_from_numpy(tree, device)


@pytest.fixture
def jax_init(monkeypatch):
    monkeypatch.setattr(TQ, "_init_bank", reference_init)


def test_fig7_rows_and_preferences_match(jax_init):
    ref = R_fig7.run(budget_rounds=1, pool=4)
    port = T_fig7.run(budget_rounds=1, pool=4, device="cpu")
    assert [r[:3] for r in port] == [r[:3] for r in ref]
    np.testing.assert_allclose([r[3:] for r in port], [r[3:] for r in ref],
                               rtol=RTOL)

    def best(rows):
        out = {}
        for comp, iname, _, thr, _ in rows:
            if thr > out.get(comp, (0.0, ""))[0]:
                out[comp] = (thr, iname)
        return {c: i for c, (_, i) in out.items()}
    assert best(port) == best(ref)
    # paper §VII-B: GEMM and TTM prefer GEMM, conv CONV2D
    assert best(port)["GEMM"] == "GEMM" and best(port)["CONV"] == "CONV2D"


def test_fig10_hypervolume_curves_equal(jax_init):
    curves_r, res_r = R_fig10.run(n_trials=6, seed=0)
    curves_t, res_t = T_fig10.run(n_trials=6, seed=0, device="cpu")
    assert list(curves_t) == ["MOBO", "NSGAII", "random"]
    for method in curves_r:
        assert list(curves_t[method]) == list(curves_r[method]), method
    for a, b in zip(res_t, res_r):             # every method's trials
        np.testing.assert_array_equal(a.ys, b.ys)


def test_fig11_library_template_equal_and_hasco_close(jax_init):
    ref = R_fig11.run(n_layers=2)
    port = T_fig11.run(n_layers=2, device="cpu")
    assert [r[:4] for r in port] == [r[:4] for r in ref]
    np.testing.assert_allclose([r[4] for r in port], [r[4] for r in ref],
                               rtol=RTOL)
    # which stack wins each layer
    assert [min(range(3), key=lambda i: (r[1], r[3], r[4])[i])
            for r in port] == \
        [min(range(3), key=lambda i: (r[1], r[3], r[4])[i]) for r in ref]


def test_table3_commits_the_reference_solutions(jax_init):
    ref = R_tab3.run(n_layers=2, n_trials=6)
    port = T_tab3.run(n_layers=2, n_trials=6, device="cpu")
    assert [r[0] for r in port] == ["edge", "cloud"]
    for (scen, base_t, gemm_t, conv_t), (_, base_r, gemm_r, conv_r) in zip(
            port, ref):
        assert base_t.latency_s == base_r.latency_s, scen   # numpy only
        for sol_t, sol_r in ((gemm_t, gemm_r), (conv_t, conv_r)):
            assert (sol_t is None) == (sol_r is None), scen
            if sol_r is None:
                continue
            assert sol_t.hw.encode() == sol_r.hw.encode(), scen
            assert {k: s.describe() for k, s in sol_t.schedules.items()} == \
                {k: s.describe() for k, s in sol_r.schedules.items()}
            np.testing.assert_allclose(sol_t.latency_s, sol_r.latency_s,
                                       rtol=RTOL)
            # which side wins: co-design against the decoupled baseline
            assert (sol_t.latency_s < base_t.latency_s) == \
                (sol_r.latency_s < base_r.latency_s)


def test_ablation_rows_and_winner_match(jax_init):
    ref = R_abl.run(seeds=(0,))
    port = T_abl.run(seeds=(0,), device="cpu")
    assert [r[:2] for r in port] == [r[:2] for r in ref]
    np.testing.assert_allclose([r[2:] for r in port], [r[2:] for r in ref],
                               rtol=RTOL)
    win = lambda rows: [rows[i][2] <= rows[i + 1][2]       # noqa: E731
                        for i in range(0, len(rows), 2)]
    assert win(port) == win(ref)


def test_batched_eval_population_scores_equal():
    from repro.core.cost_model import evaluate_batch as r_eval
    from repro_torch.core.cost_model import evaluate_batch as t_eval

    for _, wl_args, intr in [("gemm512", ("gemm", (512, 512, 512)), "GEMM"),
                             ("conv", ("conv2d", (128, 64, 28, 28)), "GEMM")]:
        kind, shape = wl_args
        wl_r = getattr(R_bev.W, kind)(*shape)
        wl_t = getattr(T_bev.W, kind)(*shape)
        hw_r, s_r = R_bev._population(wl_r, intr, 64, 0)
        hw_t, s_t = T_bev._population(wl_t, intr, 64, 0)
        assert [h.encode() for h in hw_t] == [h.encode() for h in hw_r]
        assert [s.describe() for s in s_t] == [s.describe() for s in s_r]
        np.testing.assert_array_equal(t_eval(wl_t, hw_t, s_t),
                                      r_eval(wl_r, hw_r, s_r))
    rows = T_bev.run(n=64)
    assert [r[:2] for r in rows] == [("gemm512", 64), ("conv2d_resnet", 64)]
    assert all(np.isfinite(r[2:]).all() for r in rows)


def test_acquisition_hvi_parity_values_equal():
    _, _, err_t, front_t = T_acq.run_hvi(n_cands=32, n_draws=4)
    _, _, err_r, front_r = R_acq.run_hvi(n_cands=32, n_draws=4)
    assert (err_t, front_t) == (err_r, front_r)
    assert err_t <= 1e-9


def test_acquisition_mobo_hypervolumes_equal():
    got = T_acq.run_mobo(n_trials=8)
    want = R_acq.run_mobo(n_trials=8)
    assert got[3:] == want[3:]                  # hv: reference, vec, q=4
    assert got[3] == got[4]                     # the parity the gate reads


def test_sw_dse_round_loop_parity_at_four_searches(jax_init):
    from repro.core.sw_dse import run_searches as r_run

    _, _, parity, ref_t, bat_t = T_swb.run_round_loop("cpu", n_searches=4)
    assert parity                               # batched == per-search
    want = r_run(R_swb._specs()[:4], engine="batched", pool_size=R_swb.POOL,
                 rounds=R_swb.ROUNDS, k=R_swb.K)
    assert [r.schedule.describe() for r in bat_t] == \
        [r.schedule.describe() for r in want]
    np.testing.assert_allclose([r.latency_s for r in bat_t],
                               [r.latency_s for r in want], rtol=RTOL)


def test_sw_dse_codesign_q4_identical_solution(jax_init):
    from repro.core import workloads as RW
    from repro.core.codesign import codesign as r_codesign

    _, _, same, sol = T_swb.run_codesign_q4("cpu")
    assert same                                 # batched == reference
    want = r_codesign([RW.gemm(256, 256, 128, name="g0"),
                       RW.conv2d(32, 16, 14, 14, name="c0")],
                      intrinsics=["GEMM"], n_trials=10, n_init=4, seed=0,
                      q=4).solution
    assert sol.hw.encode() == want.hw.encode()
    np.testing.assert_allclose(sol.latency_s, want.latency_s, rtol=RTOL)


@pytest.mark.parametrize("mod", [T_fig7, T_fig10, T_fig11, T_tab3, T_abl,
                                 T_bev, T_acq, T_swb],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_script_asked_for_cuda_without_a_card_raises(mod):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv=[])
