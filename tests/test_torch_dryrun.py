"""The port's dry run, op analysis and roofline (``repro_torch.launch.
{dryrun,op_analysis,roofline}``) against the reference's:

  * the FLOP count of a known matmul chain is the analytic count;
  * ``OpReport.wire_bytes`` is ``HLOReport.wire_bytes`` on the same byte
    and group dicts (the ring model, copied);
  * ``model_flops`` and ``hbm_bytes_per_dev`` equal the reference's for
    every runnable cell;
  * the temporaries' peak counts live bytes: a freed tensor stops counting;
  * in subprocesses (each starts and ends its own fake process group):
    ``gemma2-2b x decode_32k`` prints an ``OK`` line on both meshes (the
    reference's ``test_dryrun_cell_compiles``) and leaves no group behind,
    ``qwen3-8b x long_500k`` prints ``SKIP``, and ``--mode fsdp`` is
    refused;
  * the per-device matmul FLOPs of ``gemma2-2b x decode_32k`` on 16x16
    are within 10% of the reference's HLO ``dot_flops`` for that cell;
  * the roofline's markdown builds from the port's record with the H100's
    rates.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.launch import hlo_analysis as ref_hlo
from repro.launch import roofline as ref_roofline
from repro.configs import get_config as ref_get_config
from repro.models.config import SHAPES as REF_SHAPES
from repro_torch.configs import get_config, runnable_cells
from repro_torch.launch import dryrun, op_analysis, roofline
from repro_torch.models.config import SHAPES

ROOT = Path(__file__).resolve().parents[1]


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "JAX_PLATFORMS": "cpu"}


def test_flop_count_of_a_matmul_chain():
    a, b, c = torch.ones(64, 128), torch.ones(128, 32), torch.ones(32, 16)
    x = torch.ones(3, 8, 24)

    def chain(a, b, c, x):
        return (a @ b) @ c, torch.einsum("bij,jk->bik", x, torch.ones(24, 5))

    _, rep = op_analysis.analyze(chain, a, b, c, x)
    assert rep.dot_flops == 2 * 64 * 128 * 32 + 2 * 64 * 32 * 16 \
        + 2 * 3 * 8 * 24 * 5
    assert rep.collective_bytes == {} and rep.n_ops > 0


WIRE_CASES = [
    ({"all-reduce": 1e6}, {"all-reduce": 16}),
    ({"all-gather": 3e6, "all-reduce": 5e5}, {"all-gather": 4,
                                              "all-reduce": 2}),
    ({"reduce-scatter": 2e6, "collective-permute": 7e5},
     {"reduce-scatter": 8}),
    ({"all-reduce": 1e6, "all-reduce:group": 16}, {}),
    ({"all-to-all": 9e5, "broadcast": 1e3}, {"all-to-all": 16}),
]


@pytest.mark.parametrize("case", range(len(WIRE_CASES)))
def test_wire_bytes_is_the_reference_ring_model(case):
    nbytes, groups = WIRE_CASES[case]
    counts = {k: 1 for k in nbytes}
    want = ref_hlo.HLOReport(0.0, dict(nbytes), dict(groups), counts)
    got = op_analysis.OpReport(0.0, dict(nbytes), dict(groups), counts)
    assert got.wire_bytes() == want.wire_bytes()


def test_from_stats_reads_the_collectives_entries():
    stats = {"all_reduce": [3, 0.1, 3000, 16, tuple(range(16))],
             "all_gather": [1, 0.2, 800, 16, tuple(range(0, 256, 16))]}
    rep = op_analysis.from_stats(stats, 5.0)
    assert rep.collective_bytes == {"all-reduce": 3000.0, "all-gather": 800.0}
    assert rep.n_collectives == {"all-reduce": 3, "all-gather": 1}
    assert rep.group_sizes == {"all-reduce": 16, "all-gather": 16}
    assert rep.wire_bytes() == 2 * 3000 * 15 / 16 + 800 * 15 / 16


@pytest.mark.parametrize("cell", runnable_cells(),
                         ids=[f"{a}-{s}" for a, s in runnable_cells()])
def test_model_flops_and_hbm_bytes_equal_the_reference(cell):
    arch, shape = cell
    record = {"memory": {"argument_bytes": 3.5e9}}
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert roofline.model_flops(cfg, SHAPES[shape]) == \
        ref_roofline.model_flops(ref_cfg, REF_SHAPES[shape])
    assert roofline.hbm_bytes_per_dev(cfg, SHAPES[shape], 256, record) == \
        ref_roofline.hbm_bytes_per_dev(ref_cfg, REF_SHAPES[shape], 256,
                                       record)


def test_temporaries_peak_counts_live_bytes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(1024, 1024)                   # 4 MiB, an argument
        live = dryrun.LiveBytes(exclude=(x,))
        with live:
            a = x * 2
            b = a * 2
            del a
            c = b * 2
            del b, c
    assert live.peak == 2 * 4 * 1024 * 1024
    assert live.now == 0


def test_roofline_rates_are_the_h100s():
    assert roofline.PEAK_FLOPS == 989e12 and roofline.HBM_BW == 3.35e12
    assert roofline.fabric_bw(1) == 450e9 and roofline.fabric_bw(2) == 50e9
    assert roofline.GPUS_PER_NODE == 8


_REF_CELL = r"""
import json
import repro.launch.dryrun as d
rec = d.lower_cell("gemma2-2b", "decode_32k", multi_pod=False)
print(json.dumps(rec["hlo"]))
"""


@pytest.fixture(scope="module")
def gemma_runs():
    """The port's CLI on gemma2-2b x decode_32k on both meshes, and the
    reference's cell on 16x16, in two processes at once."""
    port = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma2-2b", "--shape", "decode_32k", "--both-meshes"], cwd=ROOT,
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    ref = subprocess.Popen([sys.executable, "-c", _REF_CELL], cwd=ROOT,
                           env=_env(), stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        out, err = port.communicate(timeout=300)
        rout, rerr = ref.communicate(timeout=300)
    finally:
        for p in (port, ref):
            if p.poll() is None:
                p.kill()
                p.wait()
    assert port.returncode == 0, err[-3000:]
    assert ref.returncode == 0, rerr[-3000:]
    return out, json.loads(rout.strip().splitlines()[-1])


def test_dryrun_cell_runs_on_both_meshes(gemma_runs):
    out, _ = gemma_runs
    ok = [ln for ln in out.splitlines() if ln.startswith("OK ")]
    assert len(ok) == 2, out
    assert "16x16" in ok[0] and "2x16x16" in ok[1]
    rec = json.loads((dryrun.ART_DIR / ok[0].split("-> ")[-1]).read_text())
    assert rec["mesh"] == "data=16xmodel=16" and rec["n_devices"] == 256
    assert rec["rows_per_device"] == 128 // 16
    assert rec["ops"]["group_sizes"]["all-reduce"] == 16
    assert rec["ops"]["group_nodes"]["all-reduce"] == 2
    assert rec["memory"]["argument_bytes"] > 0


def test_dot_flops_match_the_reference_hlo(gemma_runs):
    out, ref_hlo_rec = gemma_runs
    line = next(ln for ln in out.splitlines() if ln.startswith("OK ")
                and "x 16x16" in ln)
    rec = json.loads((dryrun.ART_DIR / line.split("-> ")[-1]).read_text())
    ratio = rec["ops"]["dot_flops"] / ref_hlo_rec["dot_flops"]
    assert abs(ratio - 1) <= 0.10, ratio


def test_roofline_markdown_builds_from_a_record(gemma_runs):
    out, _ = gemma_runs
    line = next(ln for ln in out.splitlines() if ln.startswith("OK "))
    rec = json.loads((dryrun.ART_DIR / line.split("-> ")[-1]).read_text())
    row = roofline.build_row(rec)
    assert row.compute_s == rec["ops"]["dot_flops"] / 989e12
    assert row.collective_s > 0 and 0 < row.roofline_fraction <= 1
    md = roofline.markdown([row])
    assert md.splitlines()[2].startswith("| gemma2-2b | decode_32k | "
                                         "data=16xmodel=16 |")
    assert "qwen3-8b × long_500k: pure full attention" in md
    assert roofline.suggestion(row)


_NO_GROUP = r"""
import torch.distributed as dist
from repro_torch.launch.dryrun import lower_cell
from repro_torch.models.config import ShapeCell
rec = lower_cell("qwen3-8b", ShapeCell("t", 16, 2, "train"), layers=1)
assert not dist.is_initialized()
rec1 = lower_cell("qwen3-8b", ShapeCell("t", 16, 2, "train"), layers=1,
                  single=True)
assert rec1["n_devices"] == 1 and rec1["ops"]["collective_counts"] == {}
assert rec["ops"]["collective_counts"]["all-reduce"] > 0
print("OK")
"""


def test_lower_cell_leaves_no_process_group():
    res = subprocess.run([sys.executable, "-c", _NO_GROUP], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")


def test_skip_and_refused_mode(capsys):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-8b", "--shape", "long_500k"], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("SKIP qwen3-8b x long_500k")
    with pytest.raises(ValueError, match="fsdp"):
        dryrun.lower_cell("qwen3-8b", "train_4k", mode="fsdp")
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen3-8b", "--shape", "train_4k", "--mode",
                     "fsdp"])
    assert e.value.code not in (0, None)
    assert "FAIL qwen3-8b x train_4k x 16x16: ValueError: --mode fsdp" \
        in capsys.readouterr().out
