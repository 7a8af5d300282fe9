"""The port's measured-tuning path (``repro_torch.tuner``) and co-design
driver, on the CPU with backend ``torch`` (the plain kernel versions).

* ``classify``/``lower``/``measure_one``/``measure_batch`` behave as the
  reference's do: the same kernel points (op, shape, dtype, blocks), the
  same inputs from ``np.random.default_rng(0)``, the same dedup and
  failure capture.
* ``codesign(measure=False)`` on ``W.table1_gemm()[:3]``, with the
  reference's DQN initialisation carried across, commits the same hardware
  and the same schedules as the live reference on this stack (not the
  golden file: the reference itself drifts from it, ROADMAP queue C.2).
* ``python -m repro_torch.tuner --smoke --backend torch`` returns 0 and
  writes a DB with ``torch`` records and a calibration.
* ``examples/quickstart_torch.py --device cpu`` co-designs, saves the
  port's registry and runs the tuned GEMM's plain version; without
  ``--device cpu`` it asks for the card.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.qlearning as RQ
import repro_torch.core.qlearning as TQ
from repro.core import workloads as R_W
from repro.core.codesign import codesign as r_codesign
from repro.core.hw_primitives import HWConfig as R_HW
from repro.core.intrinsics import GEMM as R_GEMM
from repro.core.matching import match as r_match
from repro.core.sw_primitives import Schedule as R_Sched
from repro.tuner import measure as RM
from repro_torch.core import workloads as W
from repro_torch.core.codesign import codesign
from repro_torch.core.hw_primitives import HWConfig
from repro_torch.core.intrinsics import GEMM
from repro_torch.core.matching import match
from repro_torch.core.sw_primitives import Schedule
from repro_torch.tuner import measure as M
from repro_torch.tuner.__main__ import main
from repro_torch.tuner.db import TuningDB

CPU = M.MeasureOptions(backend="torch", warmup=1, repeats=2)


def _hw(mod, rows=16, cols=16, depth=16, **kw):
    kw.setdefault("vmem_kib", 2048)
    return mod(intrinsic="GEMM", pe_rows=rows, pe_cols=cols, pe_depth=depth,
               **kw)


def _sched(sched_cls, wl, choice, tile, order=None):
    tiles = tuple(sorted((c, tile) for c in choice.mapped_compute_indices))
    return sched_cls(choice, tiles, tuple(order or wl.all_indices()), 0)


@pytest.mark.parametrize("make", ["gemm", "gemv", "dot", "conv2d", "ttm",
                                  "mttkrp"])
def test_classify_matches_reference(make):
    args = {"gemm": (8, 8, 8), "gemv": (8, 8), "dot": (8,),
            "conv2d": (4, 4, 6, 6), "ttm": (4, 4, 4, 4),
            "mttkrp": (4, 4, 4, 4)}[make]
    assert M.classify(getattr(W, make)(*args)) == \
        RM.classify(getattr(R_W, make)(*args))


@pytest.mark.parametrize("tile", [16, 32, 64])
def test_lower_gives_reference_point_and_inputs(tile, monkeypatch):
    """Same kernel point as the reference, and the thunk feeds the
    dispatch layer the reference's numpy draws."""
    wl, rwl = W.gemm(64, 48, 32, name="g"), R_W.gemm(64, 48, 32, name="g")
    sch = _sched(Schedule, wl, match(GEMM, wl)[0], tile)
    rsch = _sched(R_Sched, rwl, r_match(R_GEMM, rwl)[0], tile)
    point, thunk = M.lower(wl, _hw(HWConfig), sch, CPU)
    rpoint, _ = RM.lower(rwl, _hw(R_HW), rsch, RM.MeasureOptions())
    assert (point.op, point.shape, point.dtype, point.blocks) == \
        (rpoint.op, rpoint.shape, rpoint.dtype, rpoint.blocks)
    assert point.backend == "torch"
    seen = []
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "matmul", lambda a, b, **kw: seen.append(
        (a, b, kw)) or a @ b)
    thunk()
    (a, b, kw), = seen
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(a.numpy(), rng.standard_normal((64, 32))
                                  .astype(np.float32))
    np.testing.assert_array_equal(b.numpy(), rng.standard_normal((32, 48))
                                  .astype(np.float32))
    assert kw == {"implementation": "torch", **point.block_map}


def test_lower_rejects_unknown_backend():
    wl = W.gemm(8, 8, 8)
    with pytest.raises(ValueError, match="backend"):
        M.lower(wl, _hw(HWConfig), _sched(Schedule, wl, match(GEMM, wl)[0], 8),
                M.MeasureOptions(backend="interpret"))


@pytest.mark.parametrize("wl_name", ["gemm", "gemv", "dot", "conv2d"])
def test_measure_one_torch_backend(wl_name):
    wl = {"gemm": W.gemm(64, 64, 64), "gemv": W.gemv(64, 96),
          "dot": W.dot(512), "conv2d": W.conv2d(8, 4, 6, 6)}[wl_name]
    intr = {"gemm": "GEMM", "gemv": "GEMV", "dot": "DOT",
            "conv2d": "GEMM"}[wl_name]
    from repro_torch.core.intrinsics import ALL_INTRINSICS
    choice = match(ALL_INTRINSICS[intr], wl)[0]
    hw = HWConfig(intrinsic=intr, pe_rows=16, pe_cols=16, pe_depth=16,
                  vmem_kib=4096)
    res = M.measure_one(wl, hw, _sched(Schedule, wl, choice, 16), CPU)
    assert res.ok and res.latency_s > 0 and len(res.times_s) == 2
    assert res.point.op == wl_name and res.point.backend == "torch"


def test_measure_failure_capture_and_batch_dedup():
    wl = W.gemm(64, 64, 64, name="g64")
    choice = match(GEMM, wl)[0]
    bad = M.measure_one(W.ttm(8, 8, 8, 8), _hw(HWConfig),
                        _sched(Schedule, wl, choice, 8), CPU)
    assert not bad.ok and math.isinf(bad.latency_s)
    assert bad.error_type == "ValueError" and "no kernel lowering" in bad.error
    pop = [_sched(Schedule, wl, choice, 32),
           _sched(Schedule, wl, choice, 32, order=reversed(wl.all_indices())),
           _sched(Schedule, wl, choice, 64)]
    out = M.measure_batch(wl, _hw(HWConfig), pop, CPU)
    assert all(r.ok for r in out)
    assert out[0].times_s == out[1].times_s       # served from the memo
    assert out[2].point != out[0].point
    s = M.summarize_batch(out)
    assert s["unique_points"] == 2 and s["deduped"] == 1 and s["failed"] == 0


def test_port_sets_no_block_volume_cap_but_honours_one():
    wl = W.gemm(64, 64, 64)
    sch = _sched(Schedule, wl, match(GEMM, wl)[0], 64)
    assert M.MeasureOptions().max_block_elems is None
    assert M.measure_one(wl, _hw(HWConfig), sch, CPU).ok
    capped = M.MeasureOptions(backend="torch", max_block_elems=8)
    res = M.measure_one(wl, _hw(HWConfig), sch, capped)
    assert res.error_type == "ValueError" and "max_block_elems" in res.error


def _reference_init(seeds, sizes, device):
    keys = jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds])
    tree = jax.tree_util.tree_map(np.asarray, RQ._bank_init(keys, sizes))
    return TQ.params_from_numpy(tree, device)


def test_codesign_commits_the_live_reference_solution(monkeypatch):
    monkeypatch.setattr(TQ, "_init_bank", _reference_init)
    kw = dict(intrinsics=["GEMM"], n_trials=8, n_init=4, seed=0, q=2)
    ref = r_codesign(R_W.table1_gemm()[:3], **kw).solution
    got = codesign(W.table1_gemm()[:3], device="cpu", **kw).solution
    assert got.intrinsic == ref.intrinsic
    assert got.hw.encode() == ref.hw.encode()
    assert {k: s.describe() for k, s in got.schedules.items()} == \
        {k: s.describe() for k, s in ref.schedules.items()}
    assert (got.latency_s, got.power_w, got.area_um2) == \
        (ref.latency_s, ref.power_w, ref.area_um2)


def test_codesign_refuses_checkpointing_and_a_missing_card(tmp_path):
    """Checkpointing is ported: ``checkpoint_dir`` writes one payload per
    intrinsic and ``resume_from`` it commits the same solution (the kill
    and resume cases are in ``tests/test_torch_checkpoint.py``); a missing
    card still refuses the default device."""
    from repro_torch.ft import CheckpointManager

    wl = W.table1_gemm()[:1]
    kw = dict(intrinsics=["GEMM"], n_trials=3, n_init=2, device="cpu")
    full = codesign(wl, checkpoint_dir=tmp_path, **kw).solution
    assert CheckpointManager(tmp_path).payload_steps() == [1]
    resumed = codesign(wl, resume_from=tmp_path, **kw).solution
    assert (resumed.hw, resumed.latency_s, sorted(resumed.schedules)) == \
        (full.hw, full.latency_s, sorted(full.schedules))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            codesign(wl)                          # default device: the card


def test_cli_smoke_torch_backend_writes_db(tmp_path, capsys):
    db_path = tmp_path / "db.json"
    assert main(["--smoke", "--backend", "torch", "--db", str(db_path),
                 "--warmup", "1", "--repeats", "2"]) == 0
    assert "measure=on (torch)" in capsys.readouterr().out
    db = TuningDB.load(db_path)
    assert db.records and all(r.backend == "torch"
                              for r in db.records.values())
    assert db.calibration.corrections
    assert "default" in db.apps


def test_cli_checkpoint_flags_raise(tmp_path, capsys):
    """The flags work now: ``--checkpoint-dir`` writes a payload per
    intrinsic, and ``--resume`` from it commits the same solution."""
    from repro_torch.ft import CheckpointManager

    args = ["--workload", "gemm:32,32,32", "--backend", "torch",
            "--intrinsics", "GEMM,DOT", "--trials", "3", "--init", "2"]
    assert main(args + ["--checkpoint-dir", str(tmp_path)]) == 0
    first = capsys.readouterr().out
    assert CheckpointManager(tmp_path).payload_steps() == [1, 2]
    assert main(args + ["--resume", str(tmp_path)]) == 0
    solution = [ln for ln in first.splitlines() if ln.startswith("solution")]
    assert solution and solution[0] in capsys.readouterr().out


def test_quickstart_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    import runpy
    from pathlib import Path

    script = Path(__file__).resolve().parents[1] / "examples" \
        / "quickstart_torch.py"
    quickstart = runpy.run_path(str(script))
    monkeypatch.chdir(tmp_path)
    quickstart["main"](["--device", "cpu"])
    out = capsys.readouterr().out
    assert "tuned GEMM blocks: bm=" in out
    assert "tuned torch GEMM on cpu: max abs err vs the plain version 0.0" \
        in out
    assert (tmp_path / "artifacts" / "torch_solutions.json").exists()
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            quickstart["main"]([])
