"""The port's serving gates, kernel microbenchmark, calibration benchmark
and suite runner (``repro_torch.bench``) against the reference's
(``benchmarks/``), on the CPU.

* ``bench_serve`` and ``bench_obs`` at the reference's reduced qwen3-8b in
  float32, with the reference's weights carried across
  (``params_from_numpy``): the port's outputs equal the reference's token
  for token in every engine (uniform batched and sequential; mixed
  sequential, pinned and paged; traced and untraced paged), and the gate
  booleans match (outputs identical, no lifecycle defect, a valid
  telemetry schema).
* ``bench_serve_tp``: ``model=1`` bit for bit; 8 gloo ranks token for token
  against one rank alone; the TP-aware and TP-blind codesign commit the
  reference's two solutions.
* ``kernel_micro --device cpu`` prints its four rows; ``bench_calibration``
  on the ``torch`` backend reads a finite Spearman; ``run`` writes its
  results where ``RESULTS_PATH`` points and fails on a missed gate; a
  script asked for ``cuda`` without a card raises.

Every results and artifact path is redirected under ``tmp_path``; no
reference ``main()`` runs.
"""
import functools
import json
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
from benchmarks import bench_obs as R_obs                   # noqa: E402
from benchmarks import bench_serve as R_serve               # noqa: E402
from benchmarks import bench_serve_tp as R_tp               # noqa: E402
from repro import obs as jobs                               # noqa: E402
from repro.configs import get_config as jget_config         # noqa: E402
from repro.models import family_module as jfamily           # noqa: E402
from repro.models import reduced as jreduced                # noqa: E402
from repro_torch import obs                                 # noqa: E402
from repro_torch.bench import _results                      # noqa: E402
from repro_torch.bench import bench_calibration as T_cal    # noqa: E402
from repro_torch.bench import bench_obs as T_obs            # noqa: E402
from repro_torch.bench import bench_serve as T_serve        # noqa: E402
from repro_torch.bench import bench_serve_tp as T_tp        # noqa: E402
from repro_torch.bench import kernel_micro as T_km          # noqa: E402
from repro_torch.bench import run as T_run                  # noqa: E402
from repro_torch.configs import get_config                  # noqa: E402
from repro_torch.models import reduced                      # noqa: E402
from repro_torch.models.tree import params_from_numpy       # noqa: E402



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs files in parallel workers, where
    torch's default of a thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _carried():
    """The reference's reduced qwen3-8b in float32 from PRNGKey(0), and the
    same weights as the port's tensors on the CPU."""
    jcfg = jreduced(jget_config("qwen3-8b"), dtype="float32")
    jparams = jfamily(jcfg).init(jcfg, jax.random.PRNGKey(0), tp=1)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    cfg = reduced(get_config("qwen3-8b"), dtype="float32")
    return jcfg, jparams, cfg, params


def _outs(done):
    return [list(map(int, r.out)) for r in sorted(done, key=lambda r: r.rid)]


def test_bench_serve_uniform_token_identical_to_reference():
    jcfg, jparams, cfg, params = _carried()
    want_b = _outs(R_serve._serve(jcfg, jparams)[0])
    want_s = _outs(R_serve._serve(jcfg, jparams, max_concurrency=1)[0])
    assert _outs(T_serve._serve(cfg, params)[0]) == want_b
    assert _outs(T_serve._serve(cfg, params, max_concurrency=1)[0]) == want_s
    m = T_serve.run(cfg, params)
    assert m["outputs_identical"] == (want_b == want_s) is True
    assert m["tokens"] == T_serve.N_REQUESTS * T_serve.MAX_NEW
    assert m["decode_steps_sequential"] > m["decode_steps_batched"]


def test_bench_serve_mixed_token_identical_to_reference():
    jcfg, jparams, cfg, params = _carried()
    want, got = {}, {}
    for mode in ("sequential", "pinned", "paged"):
        done_r, stats_r, _ = R_serve._serve_mixed(jcfg, jparams, mode)
        done_t, stats_t, _ = T_serve._serve_mixed(cfg, params, mode)
        want[mode], got[mode] = _outs(done_r), _outs(done_t)
        assert got[mode] == want[mode], mode
        assert stats_t["preemptions"] == stats_r["preemptions"], mode
    m = T_serve.run_mixed(cfg, params)
    assert m["outputs_identical"] == (
        want["paged"] == want["pinned"] == want["sequential"]) is True
    assert m["requests"] == T_serve.MIX_N
    assert m["n_pages"] == T_serve.MIX_N_PAGES == 24


def test_bench_obs_token_identical_and_gates_match_reference(tmp_path):
    jcfg, jparams, cfg, params = _carried()
    # the reference, untraced then traced, with its own lifecycle replay
    jobs.disable()
    done_off = R_obs._serve(jcfg, jparams)[0]
    state = jobs.enable()
    try:
        done_on = R_obs._serve(jcfg, jparams)[0]
        want_defects = R_obs._lifecycle_defects(state.tracer, done_on)
    finally:
        jobs.disable()
    assert _outs(T_obs._serve(cfg, params)[0]) == _outs(done_off)

    m = T_obs.run(cfg, params, art_dir=tmp_path)
    assert m["outputs_identical"] == (_outs(done_off) == _outs(done_on))
    assert m["outputs_identical"] is True
    assert m["lifecycle_defects"] == want_defects == []
    assert m["schema_errors"] == []
    assert m["preemptions"] == sum(r.preemptions for r in done_on)
    assert m["trace_events"] > 0 and m["trace_dropped"] == 0
    assert (tmp_path / "torch_telemetry.json").exists()
    assert (tmp_path / "torch_trace.json").exists()
    assert not obs.enabled()


def test_bench_serve_tp_model1_bit_for_bit():
    m = T_tp.run_model1(device="cpu")
    assert m["outputs_identical"] is True
    assert m["tok_s_plain"] > 0 and m["tok_s_mesh"] > 0


def test_bench_serve_tp_8_ranks_token_for_token(tmp_path):
    m = T_tp.run_tp8(store_dir=tmp_path, timeout=150)
    assert m["outputs_identical"] is True
    assert len(m["outs"]) == T_tp.N_REQUESTS
    assert all(len(o) == T_tp.MAX_NEW for o in m["outs"])


def reference_init(seeds, sizes, device):
    keys = jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds])
    tree = jax.tree_util.tree_map(np.asarray, RQ._bank_init(keys, sizes))
    return TQ.params_from_numpy(tree, device)


def test_bench_serve_tp_codesign_commits_reference_solutions(monkeypatch):
    monkeypatch.setattr(TQ, "_init_bank", reference_init)
    got = T_tp.run_codesign("cpu")
    want = R_tp.run_codesign()
    for key in ("hw_blind", "hw_aware", "tp_blind", "tp_aware",
                "solutions_differ"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(
        [got["latency_blind_s"], got["latency_aware_s"]],
        [want["latency_blind_s"], want["latency_aware_s"]], rtol=1e-6)
    assert got["solutions_differ"] and got["tp_aware"] > 1
    assert T_tp.gate({"outputs_identical": True},
                     {"outputs_identical": True}, got)


def test_kernel_micro_cpu_prints_four_rows(capsys, monkeypatch):
    monkeypatch.setattr(T_km, "ITERS", 2)      # rows and format, not speed
    T_km.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("benchmark,kernel,shape,us_per_call,"
                               "derived_gflops")
    rows = [ln.split(",") for ln in lines[1:]]
    assert [r[1] for r in rows] == ["gemm", "flash_attention", "rwkv6",
                                    "mamba2_ssd"]
    assert [r[2] for r in rows] == ["512x512x512", "b1s1024h8d64",
                                    "b1s512h8", "b1s512h8n32"]
    assert all(float(r[3]) > 0 and np.isfinite(float(r[4])) for r in rows)
    assert all(T_km.LAST_METRICS["rows"][k]["finite"]
               for k in T_km.LAST_METRICS["rows"])


def test_bench_calibration_torch_backend_finite_spearman():
    r = T_cal.run("torch")
    assert np.isfinite([r["before_all"], r["before"], r["after"]]).all()
    assert r["n_fail"] == 0 and r["n_points"] > 1
    assert isinstance(r["correction"], str)


def test_run_writes_results_and_fails_on_a_missed_gate(tmp_path,
                                                       monkeypatch, capsys):
    path = tmp_path / "artifacts" / "torch_bench_results.json"
    monkeypatch.setattr(_results, "RESULTS_PATH", path)
    import repro_torch.bench as B
    names = ["kernel_micro", "bench_batched_eval", "bench_acquisition",
             "bench_sw_dse", "bench_serve", "bench_calibration",
             "fig7_intrinsics", "fig11_sw_dse", "fig10_hw_dse",
             "table3_codesign", "ablation_qlearning"]
    seen = []

    def stub(name):
        def main(argv=None):
            seen.append((name, argv))
            if name == "bench_serve":
                raise SystemExit(1)
        return main
    for name in names:
        mod = __import__(f"repro_torch.bench.{name}", fromlist=["main"])
        monkeypatch.setattr(mod, "main", stub(name))
        monkeypatch.setattr(mod, "LAST_METRICS", {"stub": name},
                            raising=False)
    with pytest.raises(SystemExit, match="gated benchmarks failed: "
                                         "bench_serve"):
        T_run.main(["--device", "cpu"])
    assert [n for n, _ in seen] == names      # the reference's order
    assert all(a == ["--device", "cpu"] for _, a in seen)
    doc = json.loads(path.read_text())
    assert [r["name"] for r in doc["results"]] == names
    assert [r["name"] for r in doc["results"] if r["failed"]] == \
        ["bench_serve"]
    assert doc["results"][0]["metrics"] == {"stub": "kernel_micro"}
    assert "quarantined_candidates" in doc
    assert B.__doc__ and "fig10_hw_dse" in B.__doc__


@pytest.mark.parametrize("mod", [T_serve, T_obs, T_tp, T_km, T_cal, T_run],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_script_asked_for_cuda_without_a_card_raises(mod):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def test_full_width_refuses_the_cpu():
    with pytest.raises(ValueError, match="card only"):
        T_serve.model("cpu", full_width=True)
    cfg, params = T_serve.model("cpu")
    assert cfg.name == "qwen3-8b-smoke"
    assert params["embed"]["table"].device.type == "cpu"


def _example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_lm_example_serves_on_the_cpu(capsys):
    _example("serve_lm_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "8 requests, 64 tokens" in out and "status: OK=8" in out


def test_codesign_convnet_example_on_the_cpu(capsys):
    _example("codesign_convnet_torch").main(
        ["--device", "cpu", "--layers", "2"])
    out = capsys.readouterr().out
    assert "GEMM Pareto front" in out and "CONV2D Pareto front" in out
    assert "decoupled baseline: GEMM" in out and "co-design speedup" in out
