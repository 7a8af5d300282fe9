"""The cell ``zamba2-7b.prefill-4k``: its harness path at a tiny size on
the CPU through the plain versions (a sound run is correct, a broken one
is not, the control separates from the program), the benchmark's counts
at the published shapes, and the reference's tree against the program's.
The tests marked ``chip`` run the cell at its own size on the card."""
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import counts, faults, harness, weights
from perfbench.counts import Meta
from perfbench.reference import zamba2

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "perfbench"
CELL = "zamba2-7b.prefill-4k"
H100 = counts.peaks("NVIDIA H100 80GB HBM3")
# every part of the published shape, tiny: two B/C groups of two heads,
# two shared blocks, hybrid layers 1, 3 and 4, rank-4 adapters
TINY = dict(n_layers=5, d_model=16, n_heads=4, n_kv_heads=4, d_ff=40,
            vocab=96, head_dim=12, ssm_state=8, ssm_head_dim=8,
            hybrid_layer_ids=[1, 3, 4], adapter_rank=4)


def _model():
    return json.loads((HERE / "configs" / "zamba2-7b.json").read_text())


def _run(fault=None, trace_on=False, seed=31_000_000_009):
    return harness.execute(CELL, seed, 0.3, trace_on, time.perf_counter(),
                           device="cpu", config_override=TINY,
                           mix_override={"seq_len": 64}, fault=fault)


def _meta(shape, itemsize=2, stride=None):
    if stride is None:
        stride, acc = [], 1
        for s in reversed(shape):
            stride.insert(0, acc)
            acc *= s
    return Meta(tuple(shape), tuple(stride), itemsize)


def test_sound_tiny_run_is_correct():
    run, line = _run()
    assert line["correct"], line["checks"]
    names = {m["name"] for m in harness.metrics_of(harness.manifest(), CELL,
                                                   False)}
    assert set(line["metrics"]) == names == {
        "setup_s", "prefill_tokens_per_s", "prefill_seq_p95_ms"}


def test_traced_tiny_run_reads_the_host_metrics():
    run, line = _run(trace_on=True)
    assert line["correct"]
    # no card: only the host clock's per-layer metric has something to read
    assert set(line["metrics"]) == {"host_enqueue_ms.prefill"}
    # the trace saw one mamba2 call a layer and one attention call a
    # hybrid layer, b/c in their two groups
    calls = run.trace.op_calls
    assert len(calls["mamba2"]) == 4 * TINY["n_layers"]
    assert len(calls["attention"]) == 4 * len(TINY["hybrid_layer_ids"])
    assert calls["mamba2"][0][0][2].shape[2] == 2


@pytest.mark.parametrize("fault", sorted(faults.PREFILL))
def test_broken_prefill_is_not_correct(fault):
    _, line = _run(fault=faults.PREFILL[fault])
    assert not line["correct"], line["checks"]


def test_control_separates_from_the_program():
    limits = harness.cell_files(harness.manifest(), CELL)[3]
    program, _ = _run()
    control, _ = _run(fault=faults.CONTROL)
    for name in limits:
        assert control.numbers[name] > 3 * program.numbers[name], name


def test_config_file_keeps_every_catalog_key_and_cuts_nothing():
    conf = _model()
    assert conf["reduced"] == [] and conf["family"] == "zamba2"
    m = conf["model"]
    assert (m["n_layers"], m["d_model"], m["d_ff"], m["vocab"]) == (
        conf["num_hidden_layers"], conf["hidden_size"],
        conf["intermediate_size"], conf["vocab_size"])
    assert (m["head_dim"], m["ssm_groups"], m["shared_blocks"]) == (
        conf["attention_head_dim"], conf["mamba_ngroups"],
        conf["num_mem_blocks"])
    assert m["hybrid_layer_ids"] == conf["hybrid_layer_ids"] == [
        i for i, t in enumerate(conf["layers_block_type"]) if t == "hybrid"]
    assert (m["ssm_state"], m["ssm_head_dim"], m["adapter_rank"]) == (
        conf["mamba_d_state"], conf["mamba_headdim"], conf["adapter_rank"])
    assert m["norm_eps"] == conf["rms_norm_eps"]
    assert 2 * m["d_model"] // m["ssm_head_dim"] == conf["n_mamba_heads"]


def test_parameter_counts_and_forward_flops():
    m = _model()["model"]
    spec = zamba2.param_tree(m)
    assert weights.count(spec) == pytest.approx(7.357e9, rel=5e-4)
    # block 0 met 7 times a token, block 1 6 times
    calls = [spec["shared"][b]["attn"]["wq"].mm_calls for b in ("0", "1")]
    assert calls == [7, 6]
    assert weights.matmul_params(spec) == pytest.approx(11.03e9, rel=5e-4)
    ops = zamba2.seq_ops(m, 4096)
    assert ops["attention"] / 13 == 4 * 32 * 224 * 4096 * 4097 // 2
    f = counts.model_flops(weights.matmul_params(spec), ops, 4096)
    assert f / 1e12 == pytest.approx(94.4, abs=0.1)


def test_kernel_bounds_at_the_published_shapes():
    x = _meta((1, 4096, 112, 64))
    a = _meta((1, 4096, 112))
    # b and c (B, T, G, N), views into the conv's output rows
    bc = _meta((1, 4096, 2, 64), stride=(4096 * 7424, 7424, 64, 1))
    ops, nbytes = counts.mamba2_cost(x, a, bc, bc, None)
    assert nbytes == 2 * 4096 * 112 * 64 * 2 + 4096 * 112 * 2 \
        + 2 * 4096 * 2 * 64 * 2 + 112 * 64 * 64 * 4
    assert ops == (4 * 64 * 64 + 64 * 64 + 64 * 64) * 4096 * 112
    assert counts.bound_s(ops, nbytes, H100) > nbytes / 3.35e12 * 0.999
    q = _meta((1, 4096, 32, 224))
    ops, nbytes = counts.attention_cost(q, q, q, causal=True)
    assert ops == 4 * 32 * 224 * 4096 * 4097 // 2
    assert counts.bound_s(ops, nbytes, H100) * 1e3 == pytest.approx(
        0.2433, abs=5e-4)


def test_reference_tree_is_the_programs():
    from repro_torch.models import abstract, zamba2 as program
    from repro_torch.models.config import ModelConfig

    m = _model()["model"]
    tree = abstract(program.init, ModelConfig(**m), device="cpu")

    def walk(t, p=()):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from walk(v, p + (k,))
        else:
            yield p, (tuple(t.shape), str(t.dtype).removeprefix("torch."))
    spec = [(p, (leaf.shape, leaf.dtype))
            for p, leaf in weights.leaves(zamba2.param_tree(m))]
    assert spec == list(walk(tree))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark runs only on one")


@pytest.mark.chip
def test_the_command_runs_the_cell_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELL,
         "--seed", "2147483693", "--seconds", "5", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    for name in ("mamba2_roofline", "attention_roofline"):
        assert 0 < line["metrics"][name]["value"] <= 100, name


@pytest.mark.chip
def test_control_is_not_correct_on_the_card(card):
    """The control in the program's place, at the cell's own size and
    load, against the committed limit, through the harness's path."""
    mix = harness.cell_files(harness.manifest(), CELL)[2]
    run, line = harness.execute(CELL, 2147483699, 30.0, False,
                                time.perf_counter(), fault=faults.CONTROL)
    assert len(run.compared) == int(mix["check_sample"])
    assert not line["correct"], line["checks"]
