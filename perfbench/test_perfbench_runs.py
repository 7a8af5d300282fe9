"""Each cell's harness path at a tiny size on the CPU through the plain
versions (the look for a card skipped): a sound run is correct, a run with
its timed path broken underneath is not, and the control in the program's
place separates from the program.  The trace reader on a trace written by
hand.  The tests marked ``chip`` run at the cell's own size on the card
(the command; the control against the committed limits) and skip where
there is none."""
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import faults, harness, trace

ROOT = Path(__file__).resolve().parents[1]
TINY = {
    "rwkv6": dict(n_layers=4, d_model=64, d_ff=128, vocab=256,
                  rwkv_head_dim=16),
}
PREFILL = ["rwkv6-3b.prefill-4k"]


def _run(cell, fault=None, trace_on=False, seed=31_000_000_007):
    family = cell.split("-")[0]
    return harness.execute(
        cell, seed, 0.3, trace_on, time.perf_counter(), device="cpu",
        config_override=TINY[family], mix_override={"seq_len": 64},
        fault=fault)


@pytest.mark.parametrize("cell", PREFILL)
def test_sound_tiny_run_is_correct(cell):
    run, line = _run(cell)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks" and line["attempted"] >= 1
    names = {m["name"] for m in harness.metrics_of(harness.manifest(), cell,
                                                   False)}
    assert set(line["metrics"]) == names
    assert line["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell", PREFILL)
def test_traced_tiny_run_reads_the_host_metrics(cell):
    run, line = _run(cell, trace_on=True)
    assert line["correct"]
    # no card: only the host clock's per-layer metric has something to read
    assert set(line["metrics"]) == {"host_enqueue_ms.prefill"}
    assert run.trace is not None and run.traced_requests == 4


@pytest.mark.parametrize("cell", PREFILL)
@pytest.mark.parametrize("fault", sorted(faults.PREFILL))
def test_broken_prefill_is_not_correct(cell, fault):
    _, line = _run(cell, fault=faults.PREFILL[fault])
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", PREFILL)
def test_control_separates_from_the_program(cell):
    limits = harness.cell_files(harness.manifest(), cell)[3]
    program, _ = _run(cell)
    control, line = _run(cell, fault=faults.CONTROL)
    assert control.compared and program.compared
    for name in limits:          # the numbers the cell compares
        assert control.numbers[name] > 3 * program.numbers[name], name


def test_the_line_keeps_the_setup_parts_and_ends_with_the_checks():
    run, line = _run(PREFILL[0])
    assert list(line)[-2:] == ["setup_parts", "checks"]
    parts = line["setup_parts"]
    assert list(parts) == ["harness_s", "build_s", "weights_s", "warmup_s"]
    assert sum(parts.values()) == pytest.approx(run.setup_s)


def test_trace_attributes_device_time_by_range():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.STRETCH,
         "tid": 1, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": trace.STEP, "tid": 1,
         "ts": 1, "dur": 60},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "tid": 1, "ts": 2,
         "dur": 5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": 3, "dur": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "user_annotation", "name": trace.OP + "mamba2",
         "tid": 1, "ts": 10, "dur": 20},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": 11, "dur": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "tid": 1, "ts": 40,
         "dur": 5},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel",
         "tid": 1, "ts": 41, "dur": 1, "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "gemm_kernel", "tid": 9,
         "ts": 5, "dur": 10, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "ssd_kernel", "tid": 9,
         "ts": 20, "dur": 30, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "add_kernel", "tid": 9,
         "ts": 60, "dur": 10, "args": {"correlation": 9}},
    ]
    tr = trace.parse(ev)
    by = {o.name: o for o in tr.ops}
    assert by["gemm_kernel"].host_op == "aten::mm"
    assert by["gemm_kernel"].ranges == (trace.STRETCH, trace.STEP)
    assert trace.OP + "mamba2" in by["ssd_kernel"].ranges
    assert by["add_kernel"].host_op == "aten::add"
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(50e-6)      # 5-15, 20-50, 60-70
    gaps = dict((w, s) for s, w in tr.gaps)
    assert sum(s for s, _ in tr.gaps) == pytest.approx(50e-6)
    assert trace.STEP in gaps or "aten::add" in gaps
    b = tr.breakdown()
    assert b["device_ops"][0] == ["ssd_kernel", pytest.approx(30e-6)]
    run = harness.Run(cell="c", config={}, traffic={}, seed=0, seconds=1,
                      trace=tr, traced_requests=2)
    read = harness.reader("gemm_ms.prefill")
    assert read(run) == pytest.approx(10e-6 * 1e3 / 2)
    assert harness.reader("other_ms.prefill")(run) == pytest.approx(
        10e-6 * 1e3 / 2)
    assert run.idle_pct() == pytest.approx(50.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark runs only on one")


@pytest.mark.chip
def test_the_command_runs_a_cell_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", PREFILL[0],
         "--seed", "2147483659", "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


@pytest.mark.chip
@pytest.mark.parametrize("cell", PREFILL)
def test_control_is_not_correct_on_the_card(card, cell):
    """The control in the program's place, at the cell's own size and
    load, against the committed limits, through the harness's path."""
    mix = harness.cell_files(harness.manifest(), cell)[2]
    run, line = harness.execute(cell, 2147483671, 8.0, False,
                                time.perf_counter(), fault=faults.CONTROL)
    assert len(run.compared) == int(mix["check_sample"])
    assert not line["correct"], line["checks"]


@pytest.mark.chip
@pytest.mark.parametrize("cell", PREFILL)
def test_moved_tokens_are_not_correct_on_the_card(card, cell):
    """The token fault at the cell's own size.  One altered answer among
    4095 positions is not caught at this size (PERF.md)."""
    run, line = harness.execute(cell, 2147483677, 2.0, False,
                                time.perf_counter(),
                                fault=faults.PREFILL["token"])
    assert not line["correct"], line["checks"]


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", PREFILL[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
