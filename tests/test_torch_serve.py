"""The port's continuous-batching engine, on the CPU.

Three gates, in the discipline of ``tests/test_serve_engine.py``:

  * in float32, with the reference's weights carried over, the port's
    ``ServeEngine`` emits the same tokens as the reference's engine under
    the burst and trickle admission patterns (qwen3, the gemma2 ring case
    whose prompts overflow the window, and the recurrent rwkv6 and zamba2,
    whose prompts of 2-8 tokens the reference's engine can prefill);
  * the port's engine is bit-identical to its own sequential
    single-request runs and to a teacher-forced token-by-token decode that
    shares nothing with the admission path;
  * the engine's lifecycle (budgets, cancel, deadlines, rejection, stall)
    and the scheduler behave as the reference's.

Argmax ties are frequent in bfloat16, so token identity is held in float32.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import family_module as jfamily
from repro.models import reduced as jreduced
from repro_torch.configs import get_config
from repro_torch.core.solution import mxu_legal
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch.serve import (EngineStalledError, FCFSScheduler,
                                      Request, ServeEngine, make_requests,
                                      serve_requests)
from repro_torch.models import family_module, reduced
from repro_torch.models import transformer as T
from repro_torch.tuner.__main__ import main as tuner_main
from repro_torch.tuner.db import TuningDB

GEMMA_RING = (("local_window", 5), ("n_layers", 4))
PATTERN_BURST = {0: 6}                        # all up front, 6 reqs > 4 slots
PATTERN_TRICKLE = {0: 3, 2: 2, 5: 1}          # arrivals join mid-decode
MAX_SEQ, MAX_NEW = 32, 6


@functools.lru_cache(maxsize=None)
def _model(arch, over=()):
    over = dict(over, dtype="float32")
    jcfg = jreduced(jget_config(arch), **over)
    jparams = jfamily(jcfg).init(jcfg, jax.random.PRNGKey(0), tp=1)
    params = T.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                 device="cpu")
    return reduced(get_config(arch), **over), jcfg, jparams, params


def _req(rid, n=3, max_new=4, **kw):
    return Request(rid, np.arange(1, n + 1, dtype=np.int32), max_new, **kw)


def _prompts(vocab, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(2, 9)))
            .astype(np.int32) for _ in range(n)]


def _drive(eng, make, prompts, pattern):
    """Submit per ``pattern`` ({step: count}) while stepping; -> {rid: out}."""
    pending = [make(i, p.copy(), MAX_NEW) for i, p in enumerate(prompts)]
    done, step = [], 0
    while pending or eng.scheduler.has_work():
        for _ in range(pattern.get(step, 0)):
            eng.submit(pending.pop(0))
        done.extend(eng.step())
        step += 1
    assert sorted(r.rid for r in done) == list(range(len(prompts)))
    assert all(r.status == "OK" for r in done)
    return {r.rid: r.out for r in done}


def _sequential(cfg, params, prompts):
    out = {}
    for i, p in enumerate(prompts):
        eng = ServeEngine(cfg, params, slots=1, max_seq=MAX_SEQ, impl="torch")
        eng.submit(Request(i, p.copy(), MAX_NEW))
        out[i] = eng.run()[0].out
    return out


def _teacher_forced(cfg, params, prompts):
    """Prompt fed one token at a time through decode_step: no one-shot
    prefill, no pack_slot_cache, no slot scatter."""
    mod = family_module(cfg)
    out = {}
    for i, p in enumerate(prompts):
        cache = mod.init_cache(cfg, 1, MAX_SEQ, device="cpu")
        for t, tok in enumerate(p):
            logits, cache = mod.decode_step(
                params, cfg, cache, torch.tensor([[int(tok)]]), [t],
                impl="torch")
        toks = [int(torch.argmax(logits[0, -1]))]
        pos = len(p)
        while len(toks) < MAX_NEW and pos < MAX_SEQ:
            logits, cache = mod.decode_step(
                params, cfg, cache, torch.tensor([[toks[-1]]]), [pos],
                impl="torch")
            toks.append(int(torch.argmax(logits[0, -1])))
            pos += 1
        out[i] = toks
    return out


CASES = [("qwen3-8b", ()), ("gemma2-2b", GEMMA_RING), ("rwkv6-3b", ()),
         ("zamba2-2.7b", ())]
IDS = ["qwen3-8b", "gemma2-ring", "rwkv6-3b", "zamba2-2.7b"]


@pytest.mark.parametrize("arch,over", CASES, ids=IDS)
def test_engine_is_token_identical_to_the_reference_engine(arch, over):
    cfg, jcfg, jparams, params = _model(arch, over)
    prompts = _prompts(cfg.vocab, 6, seed=1)
    for pattern in (PATTERN_BURST, PATTERN_TRICKLE):
        mine = _drive(ServeEngine(cfg, params, slots=4, max_seq=MAX_SEQ,
                                  impl="torch"), Request, prompts, pattern)
        ref = _drive(jserve.ServeEngine(jcfg, jparams, slots=4,
                                        max_seq=MAX_SEQ),
                     jserve.Request, prompts, pattern)
        assert mine == ref, f"{arch} diverged under {pattern}"


@pytest.mark.parametrize("arch,over", CASES, ids=IDS)
def test_engine_is_bit_identical_to_its_sequential_and_teacher_forced_runs(
        arch, over):
    cfg, _, _, params = _model(arch, over)
    prompts = _prompts(cfg.vocab, 6, seed=2)
    seq = _sequential(cfg, params, prompts)
    assert _teacher_forced(cfg, params, prompts) == seq
    for pattern in (PATTERN_BURST, PATTERN_TRICKLE):
        got = _drive(ServeEngine(cfg, params, slots=4, max_seq=MAX_SEQ,
                                 impl="torch"), Request, prompts, pattern)
        assert got == seq, f"{arch} diverged under {pattern}"


def test_sequential_mode_matches_batched_outputs():
    cfg, _, _, params = _model("qwen3-8b")
    prompts = _prompts(cfg.vocab, 5, seed=3)
    copy = lambda: [Request(i, p.copy(), 5) for i, p in enumerate(prompts)]
    batched, st_b = serve_requests(cfg, params, copy(), slots=4,
                                   max_seq=MAX_SEQ, impl="torch")
    seq, st_s = serve_requests(cfg, params, copy(), slots=4, max_seq=MAX_SEQ,
                               impl="torch", max_concurrency=1)
    assert [r.out for r in batched] == [r.out for r in seq]
    assert st_b["generated"] == st_s["generated"] == 25
    assert st_b["decode_steps"] < st_s["decode_steps"]
    assert st_b["status_counts"] == {"OK": 5}
    assert st_b["ttft_s"]["count"] == 5


def test_idle_slots_ride_the_decode_step_without_touching_the_cache():
    """After a request retires at its budget its slot parks at max_seq and
    keeps decoding; the out-of-range writes are dropped, so the live slot's
    tokens are what it produces alone."""
    cfg, _, _, params = _model("qwen3-8b")
    eng = ServeEngine(cfg, params, slots=2, max_seq=12, impl="torch")
    eng.submit(_req(0, n=8, max_new=50))          # retires at pos 12
    eng.submit(_req(1, n=3, max_new=9))
    done = eng.run()
    assert len(done[0].out) == 1 + (12 - 8) and len(done[1].out) == 9
    alone = ServeEngine(cfg, params, slots=1, max_seq=12, impl="torch")
    alone.submit(_req(1, n=3, max_new=9))
    assert alone.run()[0].out == done[1].out


def test_make_requests_is_the_reference_stream():
    cfg, jcfg, _, _ = _model("qwen3-8b")
    for kw in ({}, dict(long_every=3, priorities=(0, 2), max_new_spread=2)):
        mine = make_requests(cfg, 7, 4, seed=5, **kw)
        ref = jserve.make_requests(jcfg, 7, 4, seed=5, **kw)
        assert [(r.prompt.tolist(), r.max_new, r.priority) for r in mine] \
            == [(r.prompt.tolist(), r.max_new, r.priority) for r in ref]


# ---------------------------------------------------------------------------
# lifecycle and scheduler (the reference's tests, on the port)
# ---------------------------------------------------------------------------

def test_request_validation():
    with pytest.raises(ValueError, match="non-empty"):
        Request(0, np.array([], np.int32), 4)
    with pytest.raises(ValueError, match="max_new"):
        _req(0, max_new=0)
    with pytest.raises(ValueError, match="priority"):
        _req(0, priority=-1)
    assert _req(0).next_token == -1


def test_fcfs_admission_reuse_and_cap():
    s = FCFSScheduler(3)
    for i in range(5):
        s.submit(_req(i))
    assert [(slot, r.rid) for slot, r in s.admit()] == [(0, 0), (1, 1),
                                                        (2, 2)]
    assert s.retire(1).rid == 1
    assert [(slot, r.rid) for slot, r in s.admit()] == [(1, 3)]
    with pytest.raises(ValueError, match="not occupied"):
        FCFSScheduler(1).retire(0)
    capped = FCFSScheduler(4, max_concurrency=1)
    for i in range(3):
        capped.submit(_req(i))
    assert len(capped.admit()) == 1 and capped.admit() == []


def test_budget_rejection_and_max_new_one():
    cfg, _, _, params = _model("qwen3-8b")
    eng = ServeEngine(cfg, params, slots=2, max_seq=32, impl="torch")
    eng.submit(_req(0, n=3, max_new=50, max_seq=6))
    eng.submit(_req(1, n=3, max_new=1))
    done = eng.run()
    assert len(done[0].out) == 1 + (6 - 3) and len(done[1].out) == 1
    rej = _req(2, n=6, max_new=2, max_seq=6)
    assert eng.submit(rej) is False and rej.status == "REJECTED"
    assert eng.run() == [rej]


def test_cancel_and_deadlines():
    cfg, _, _, params = _model("qwen3-8b")
    now = [0.0]
    eng = ServeEngine(cfg, params, slots=1, max_seq=32, impl="torch",
                      clock=lambda: now[0])
    eng.submit(_req(0, max_new=8))
    eng.submit(_req(1, max_new=8, deadline_s=1.0))
    eng.submit(_req(2, max_new=8))
    eng.step()
    assert eng.cancel(2) and not eng.cancel(2) and not eng.cancel(99)
    now[0] = 5.0                 # request 1 expires while waiting
    done = {r.rid: r.status for r in eng.run()}
    assert done == {0: "OK", 1: "EXPIRED", 2: "CANCELLED"}


def test_stall_raises_with_diagnostics():
    cfg, _, _, params = _model("qwen3-8b")
    eng = ServeEngine(cfg, params, slots=1, max_seq=32, impl="torch",
                      stall_limit=3)
    eng.submit(_req(0))
    eng.step = lambda: []        # an engine that never makes progress
    with pytest.raises(EngineStalledError) as err:
        eng.run()
    assert err.value.diagnostics["waiting"] == [0]


def test_encoder_and_unported_options_raise(tmp_path, capsys):
    """The encoder raises, and so do a mesh that is not a ``DeviceMesh``
    and a ``--mesh`` whose size is not the process group's (one rank
    here); ``--mesh data=1,model=1`` serves on a one-rank mesh;
    ``--paged``, ``--sanitize`` and the tuned-blocks flags (``--tuned-app``
    with a DB the port's tuner wrote) serve."""
    cfg, _, _, params = _model("qwen3-8b")
    with pytest.raises(ValueError, match="encoder-only"):
        ServeEngine(reduced(get_config("hubert-xlarge")), params)
    with pytest.raises(TypeError, match="DeviceMesh"):
        ServeEngine(cfg, params, mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        serve_requests(cfg, params, [], paged=True, mesh=object())
    with pytest.raises(SystemExit, match="wants 2 ranks, the process "
                                         "group has 1"):
        serve.main(["--smoke", "--device", "cpu", "--mesh=data=1,model=2"])
    with pytest.raises(SystemExit, match="exactly data= and model="):
        serve.main(["--smoke", "--device", "cpu", "--mesh=model=1"])
    serve.main(["--smoke", "--device", "cpu", "--mesh=data=1,model=1",
                "--requests", "2", "--max-new", "2"])
    assert "mesh: data=1xmodel=1" in capsys.readouterr().out
    done, stats = serve_requests(cfg, params, [], paged=True)
    assert done == [] and stats["status_counts"] == {}

    db = tmp_path / "db.json"
    assert tuner_main(["--smoke", "--backend", "torch", "--db", str(db),
                       "--warmup", "1", "--repeats", "2"]) == 0
    want = TuningDB.load(db).apps["default"]["hw"]
    capsys.readouterr()
    try:
        for flags in (["--paged"], ["--paged", "--sanitize"],
                      ["--sanitize"], ["--tuned-app", "default",
                                       "--tuning-db", str(db)]):
            serve.main(["--smoke", "--device", "cpu", "--requests", "2",
                        "--max-new", "3", *flags])
            out = capsys.readouterr().out
            assert "2 requests, 6 tokens" in out and "status: OK=2" in out
        installed = ops.configure(app="default", db_path=db)
    finally:
        ops.reset_dispatch()
    assert f"tuned kernel blocks installed: gemm={installed['gemm']}" in out
    assert installed["gemm"]["bm"] == mxu_legal(want["pe_rows"], 8)


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-3b"])
def test_cli_serves_on_the_cpu(capsys, arch):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests",
                "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "2 requests, 6 tokens" in out and "status: OK=2" in out
