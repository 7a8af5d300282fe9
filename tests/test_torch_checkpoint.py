"""The port's checkpointing (``repro_torch.ft.CheckpointManager``), heartbeat
watchdog and co-design checkpoint/resume, on the CPU.

* The reference's cases of ``tests/test_ft_data_optim.py``: a bfloat16
  round trip (the same bits, with no ``ml_dtypes``), retention and latest,
  async then wait, no ``tmp-`` left behind; plus a torn checkpoint skipped
  for the next older one, restore onto the caller's dtype, a tree of
  params and ``OptState``, and the reference's path keys.
* The reference's watchdog cases, on the copied ``Watchdog``.
* The reference's ``tests/test_chaos.py`` co-design kill/resume cases on
  the port's ``codesign`` (backend torch, the DQNs on the CPU): a resumed
  run commits the uninterrupted run's solution bit for bit, one payload
  per intrinsic; a foreign signature warns and starts fresh; an empty
  directory starts fresh.
"""
import math
import warnings

import pytest
import torch

from repro_torch.core import workloads as W
from repro_torch.core.codesign import Constraints, codesign
from repro_torch.ft import CheckpointManager, Watchdog
from repro_torch.ft.checkpoint import _flatten
from repro_torch.optim import AdamW


def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"w": torch.ones(4, dtype=torch.bfloat16) * 1.5,
                  "step": torch.tensor(7, dtype=torch.int32)}}


def _leaves(tree):
    return list(_flatten(tree).values())


def test_checkpoint_roundtrip_bf16(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = _tree()
    # bf16 words no float32 rounds to: the bits must survive, not the value
    tree["b"]["w"] = torch.tensor([1.5, -3.140625, 1e-3, 65280.0],
                                  dtype=torch.bfloat16)
    mgr.save(3, tree)
    like = {"a": torch.zeros(2, 3), "b": {
        "w": torch.zeros(4, dtype=torch.bfloat16),
        "step": torch.zeros((), dtype=torch.int32)}}
    got = mgr.restore(3, like=like)
    for a, b in zip(_leaves(got), _leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    manifest = (tmp_path / "step-000000000003" / "manifest.json").read_text()
    assert '"dtype": "bfloat16"' in manifest


def test_checkpoint_retention_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_async_then_wait(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = _tree()
    mgr.save(9, tree, blocking=False)
    tree["a"].add_(100.0)        # an in-place update after save returns
    mgr.wait()
    assert mgr.latest_step() == 9
    got = mgr.restore(9, like=_tree())
    assert torch.equal(got["a"], _tree()["a"])   # the snapshot, not the edit


def test_checkpoint_atomic_no_tmp_left(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, _tree())
    assert not list(tmp_path.glob("tmp-*"))


@pytest.mark.parametrize("tear", ["npy", "manifest", "shape"])
def test_torn_checkpoint_falls_back_to_the_older_one(tmp_path, tear):
    mgr = CheckpointManager(tmp_path)
    old, new = _tree(), _tree()
    new["a"].add_(1.0)
    mgr.save(1, old)
    mgr.save(2, new)
    d = tmp_path / "step-000000000002"
    if tear == "npy":
        npy = sorted(d.glob("*.npy"))[0]
        npy.write_bytes(npy.read_bytes()[:20])
    elif tear == "manifest":
        (d / "manifest.json").write_text("{not json")
    like = _tree()
    if tear == "shape":          # a checkpoint of another model's shapes
        like["a"] = torch.zeros(3, 2)
        with pytest.warns(UserWarning, match="step 2 .*skipping"):
            assert mgr.restore(2, like=like) is None
        return
    with pytest.warns(UserWarning, match="step 2 .*skipping"):
        got = mgr.restore(2, like=like)
    assert torch.equal(got["a"], old["a"])


def test_restore_takes_the_callers_dtype_and_opt_state(tmp_path):
    params = {"w": torch.randn(3, 4, generator=torch.Generator()
                               .manual_seed(0)).to(torch.bfloat16),
              "n": torch.ones(4)}
    opt = AdamW(lr=1e-2)
    state = opt.init(params)
    params, state, _ = opt.update({"w": torch.ones(3, 4, dtype=torch.bfloat16),
                                   "n": torch.ones(4)}, state, params)
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, (params, state))
    keys = set(_flatten((params, state)))
    # the reference's keys: tuple index, OptState field index, dict key
    assert keys == {"0__w", "0__n", "1__0", "1__1__w", "1__1__n", "1__2__w",
                    "1__2__n"}
    fresh = {k: torch.zeros_like(v) for k, v in params.items()}
    p2, s2 = mgr.restore(1, like=(fresh, opt.init(fresh)))
    assert int(s2.step) == 1 and s2.step.dtype == torch.int32
    assert p2["w"].dtype == torch.bfloat16
    assert torch.equal(p2["w"], params["w"])
    assert torch.equal(s2.m["w"], state.m["w"])
    # onto a (one-rank) mesh: DTensors laid out by the specs, same values
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.distributed.local import full_tensor
    from repro_torch.distributed.sharding import P
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh()
    specs = {"w": P("data", "model"), "n": P(None)}
    p3, s3 = mgr.restore(1, like=(fresh, opt.init(fresh)), mesh=mesh,
                         specs=(specs, opt.init_specs(specs)))
    assert isinstance(p3["w"], DTensor)
    assert tuple(p3["w"].placements) == (Shard(0), Shard(1))
    assert torch.equal(full_tensor(p3["w"]), params["w"])
    assert torch.equal(full_tensor(s3.v["n"]), state.v["n"])
    with pytest.raises(ValueError, match="both mesh= and specs="):
        mgr.restore(1, like=(fresh, opt.init(fresh)), mesh=mesh)


def test_payload_roundtrip_and_corrupt_payload_skipped(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=8)
    mgr.save_payload(1, {"x": 1})
    mgr.save_payload(2, {"x": 2})
    assert mgr.restore_payload() == {"x": 2}
    (tmp_path / "state-000000000002.pkl").write_bytes(b"\x80garbage")
    with pytest.warns(UserWarning, match="corrupt"):
        assert mgr.restore_payload() == {"x": 1}


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------

def test_watchdog_detects_dead_and_stragglers():
    wd = Watchdog(n_workers=4, dead_after_s=10.0, straggler_factor=2.0,
                  cordon_after=2)
    now = 1000.0
    for step in range(6):
        for w in range(3):  # worker 3 never beats -> dead
            dt = 1.0 if w != 1 else (5.0 if step >= 3 else 1.0)
            wd.beat(w, step, now=now + step, step_time_s=dt)
    health = wd.check(now=now + 6)
    assert health["dead"] == [3]
    assert 1 in health["cordoned"] or 1 in health["stragglers"]
    assert 0 not in health["stragglers"]


def test_watchdog_elastic_target():
    wd = Watchdog(n_workers=8, dead_after_s=1.0)
    for w in range(6):
        wd.beat(w, 0, now=0.0)
    assert wd.healthy_mesh_size(8, now=0.5) == 4  # 6 healthy -> pow2 = 4


# ---------------------------------------------------------------------------
# codesign kill/resume: bit-identical committed solution
# ---------------------------------------------------------------------------

def _mini_codesign(**kw):
    wl = [W.gemm(64, 64, 64, name="g0")]
    kw.setdefault("seed", 0)
    return codesign(wl, intrinsics=["GEMM", "DOT"], n_trials=3, n_init=2,
                    constraints=Constraints(power_w=1e4), device="cpu", **kw)


def _sol_key(rep):
    s = rep.solution
    return (s.intrinsic, s.hw, s.latency_s, s.power_w,
            sorted(s.schedules.items()))


def test_codesign_kill_resume_is_bit_identical(tmp_path):
    ref = _mini_codesign()
    assert ref.solution is not None

    ckdir = tmp_path / "ck"
    full = _mini_codesign(checkpoint_dir=ckdir)
    assert _sol_key(full) == _sol_key(ref)         # checkpointing is passive
    mgr = CheckpointManager(ckdir, keep=8)
    assert mgr.payload_steps() == [1, 2]           # one per intrinsic

    # simulate a kill after the first intrinsic: drop the final checkpoint,
    # then resume: the second intrinsic re-runs, the first is restored
    (ckdir / "state-000000000002.pkl").unlink()
    resumed = _mini_codesign(resume_from=ckdir)
    assert _sol_key(resumed) == _sol_key(ref)
    assert resumed.evaluations == ref.evaluations
    assert math.isfinite(resumed.solution.latency_s)


def test_codesign_resume_rejects_foreign_checkpoint(tmp_path):
    ckdir = tmp_path / "ck"
    _mini_codesign(checkpoint_dir=ckdir)
    with pytest.warns(UserWarning, match="signature"):
        rep = _mini_codesign(seed=1, resume_from=ckdir)  # fresh run
    assert rep.solution is not None
    assert _sol_key(rep) == _sol_key(_mini_codesign(seed=1))


def test_codesign_resume_from_empty_dir_starts_fresh(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("error")               # silently, no warning
        rep = _mini_codesign(resume_from=tmp_path / "nothing-here")
    assert _sol_key(rep) == _sol_key(_mini_codesign())
