"""The port's paged serving engine, on the CPU.

In the discipline of ``tests/test_paged_kv.py`` and ``tests/test_chaos.py``:

  * in float32, with the reference's weights carried over, the port's
    ``PagedServeEngine`` emits the same tokens as the reference's, with the
    same preemption count, for qwen3, the gemma2 ring case (dense rings on
    the local layers beside pools on the global ones), rwkv6 (nothing
    paged), zamba2 (a pooled shared-attention KV beside per-slot conv/SSD
    state) and granite-moe; each with an ample pool and with one small
    enough to preempt;
  * injected ``page.alloc`` faults never change the outputs and leave the
    allocator leak-free; a prefill fault fails one request alone; a
    persistent decode fault raises ``EngineStalledError``;
  * the kv sanitizer runs every tick (``sanitize=True``), the lifecycle
    (rejection, cancel, deadlines) matches the reference's, and the CLI
    serves ``--paged --sanitize --smoke --device cpu``.
"""
import functools
import re

import jax
import numpy as np
import pytest

from repro import obs as jobs
from repro.configs import get_config as jget_config
from repro.ft import inject as jinject
from repro.launch import serve as jserve
from repro.models import family_module as jfamily
from repro.models import reduced as jreduced
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.ft import inject
from repro_torch.launch import serve
from repro_torch.launch.serve import (EngineStalledError, PagedServeEngine,
                                      Request, make_requests, serve_requests)
from repro_torch.models import reduced
from repro_torch.models.tree import params_from_numpy

GEMMA_RING = (("local_window", 5), ("n_layers", 4))
CASES = [("qwen3-8b", ()), ("gemma2-2b", GEMMA_RING), ("rwkv6-3b", ()),
         ("zamba2-2.7b", ()), ("granite-moe-3b-a800m", ())]
IDS = ["qwen3-8b", "gemma2-ring", "rwkv6-3b", "zamba2-2.7b", "granite-moe"]
# (n_pages, page_size): the default dense-equivalent pool, and 12 pages of
# 2 rows under 3 slots of 32 rows, where priority-2 requests are preempted
POOLS = {"ample": (None, 2), "pressure": (12, 2)}


@pytest.fixture(autouse=True)
def _no_plan_leaks():
    yield
    inject.disarm()


@functools.lru_cache(maxsize=None)
def _model(arch, over=()):
    over = dict(over, dtype="float32")
    jcfg = jreduced(jget_config(arch), **over)
    jparams = jfamily(jcfg).init(jcfg, jax.random.PRNGKey(0), tp=1)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    return reduced(get_config(arch), **over), jcfg, jparams, params


def _requests(make, cfg):
    """Mixed traffic: short and long prompts in two priority classes."""
    base = make_requests(cfg, 6, 5, seed=3, priorities=(0, 2),
                         long_every=3, long_lengths=(12, 17))
    return [make(r.rid, r.prompt.copy(), r.max_new, priority=r.priority)
            for r in base]


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    return {r.rid: (r.status, r.out) for r in done}, eng.preemptions


def _engines(arch, over, pool, **kw):
    cfg, jcfg, jparams, params = _model(arch, over)
    n_pages, page_size = POOLS[pool]
    common = dict(slots=3, max_seq=32, page_size=page_size, n_pages=n_pages,
                  prefill_chunk=4, age_steps=0, **kw)
    mine = PagedServeEngine(cfg, params, impl="torch", **common)
    ref = jserve.PagedServeEngine(jcfg, jparams, **common)
    return cfg, mine, ref


@pytest.mark.parametrize("pool", sorted(POOLS))
@pytest.mark.parametrize("arch,over", CASES, ids=IDS)
def test_paged_engine_is_token_identical_to_the_reference(arch, over, pool):
    cfg, mine, ref = _engines(arch, over, pool)
    got, got_pre = _serve(mine, _requests(Request, cfg))
    want, want_pre = _serve(ref, _requests(jserve.Request, cfg))
    assert got == want, f"{arch} diverged with the {pool} pool"
    assert got_pre == want_pre
    assert all(status == "OK" for status, _ in got.values())
    if pool == "pressure" and mine._has_pool:
        assert got_pre > 0, "the small pool never preempted"
    assert mine.alloc.n_free == mine.alloc.n_pages


@pytest.mark.parametrize("arch,over", [CASES[0], CASES[3]],
                         ids=[IDS[0], IDS[3]])
def test_preemption_never_changes_tokens_and_sanitizer_holds(arch, over):
    """The no-recompute swap guarantee on the port alone: a pool that
    forces preemptions gives the ample pool's tokens, with the page-table
    invariants asserted after every tick."""
    cfg, ample, _ = _engines(arch, over, "ample", sanitize=True)
    cfg, tight, _ = _engines(arch, over, "pressure", sanitize=True)
    got, _ = _serve(ample, _requests(Request, cfg))
    tight_out, pre = _serve(tight, _requests(Request, cfg))
    assert pre > 0 and tight_out == got


def test_swap_out_copies_and_swap_in_restores_the_bits():
    """A snapshot is host memory, not a view of the pool: the next tenant
    of the freed pages cannot change it, and swap-in writes back the very
    bits that were swapped out."""
    cfg, _, _, params = _model("zamba2-2.7b")
    eng = PagedServeEngine(cfg, params, slots=2, max_seq=32, page_size=2,
                           prefill_chunk=4, impl="torch")
    req = Request(0, np.arange(1, 8, dtype=np.int32), 6)
    eng.submit(req)
    while eng.pos[0] == eng.max_seq or len(req.out) < 3:
        eng.step()
    rows = int(eng.pos[0])
    before = {k: v.clone() for k, v in eng.cache["attn"].items()}
    prows = eng._slot_rows(0, rows)
    eng._preempt(0)
    snap_rows, snap = eng._suspended[0]
    assert snap_rows == rows and snap["attn"]["k"].device.type == "cpu"
    for leaf in eng.cache["attn"].values():
        leaf.fill_(7.0)                    # the next tenant's writes
    np.testing.assert_array_equal(snap["attn"]["k"].numpy(),
                                  before["k"][:, prows].numpy())
    eng.scheduler.place(req)
    eng._swap_in(0, req)
    new_rows = eng._slot_rows(0, rows)
    for name, leaf in eng.cache["attn"].items():
        np.testing.assert_array_equal(leaf[:, new_rows].numpy(),
                                      before[name][:, prows].numpy())


# ---------------------------------------------------------------------------
# chaos: page faults, prefill faults, persistent faults (test_chaos.py)
# ---------------------------------------------------------------------------

def _run_chaos(cfg, params, reqs):
    eng = PagedServeEngine(cfg, params, slots=3, max_seq=32, page_size=2,
                           n_pages=12, prefill_chunk=4, age_steps=0,
                           impl="torch")
    for r in reqs:
        eng.submit(r)
    return eng, eng.run()


@functools.lru_cache(maxsize=None)
def _baseline():
    cfg, _, _, params = _model("qwen3-8b")
    base = make_requests(cfg, 5, 4, seed=3, priorities=(0, 2))
    eng, done = _run_chaos(cfg, params, _copies(base))
    assert all(r.status == "OK" for r in done)
    assert eng.alloc.n_free == eng.alloc.n_pages
    return cfg, params, base, {r.rid: list(r.out) for r in done}


def _copies(base):
    return [Request(r.rid, r.prompt.copy(), r.max_new, priority=r.priority)
            for r in base]


@pytest.mark.parametrize("seed", [11, 12])
def test_page_faults_never_change_outputs(seed):
    cfg, params, base, ref = _baseline()
    plan = inject.arm(seed=seed, rates={"page.alloc": 0.3})
    try:
        eng, done = _run_chaos(cfg, params, _copies(base))
    finally:
        inject.disarm()
    assert plan.total_fired > 0
    assert {r.rid: r.status for r in done} == {r.rid: "OK" for r in base}
    assert {r.rid: r.out for r in done} == ref
    assert eng.alloc.n_free == eng.alloc.n_pages


@pytest.mark.parametrize("seed", [1, 12])
def test_every_preemption_reaches_the_telemetry(seed):
    """Under injected page faults every preemption, the engine's count,
    is also a ``req.preempt`` event and a ``serve.preemptions`` count, and
    the count equals the reference's.  The reference's re-admission fault
    branch skips its telemetry, so its exported counter falls short
    (ROADMAP C.1.6); the port counts every preemption in one place."""
    cfg, jcfg, jparams, params = _model("qwen3-8b")
    base = make_requests(cfg, 5, 4, seed=3, priorities=(0, 2))

    def run(obs_mod, inject_mod, make_engine, make):
        st = obs_mod.enable()
        inject_mod.arm(seed=seed, rates={"page.alloc": 0.3})
        try:
            eng = make_engine()
            for r in base:
                eng.submit(make(r.rid, r.prompt.copy(), r.max_new,
                                priority=r.priority))
            eng.run()
            events = sum(ev[1] == "req.preempt"
                         for ev in st.tracer.events())
            return eng.preemptions, int(st.metrics.counter(
                "serve.preemptions").value), events
        finally:
            inject_mod.disarm()
            obs_mod.disable()

    common = dict(slots=3, max_seq=32, page_size=2, n_pages=12,
                  prefill_chunk=4, age_steps=0)
    mine = run(obs, inject, lambda: PagedServeEngine(
        cfg, params, impl="torch", **common), Request)
    ref = run(jobs, jinject, lambda: jserve.PagedServeEngine(
        jcfg, jparams, **common), jserve.Request)
    assert mine[0] > 0 and mine == (mine[0],) * 3
    assert ref[0] == mine[0]
    assert ref[1] < ref[0], "the reference now counts every preemption"


def test_mixed_chaos_survivors_bit_identical():
    cfg, params, base, ref = _baseline()
    plan = inject.arm(seed=5, rates={"page.alloc": 0.15},
                      at={"serve.prefill": [1], "serve.decode": [0, 2]})
    try:
        eng, done = _run_chaos(cfg, params, _copies(base))
    finally:
        inject.disarm()
    assert plan.fired.get("serve.prefill") == 1
    assert plan.fired.get("serve.decode") == 2
    statuses = [r.status for r in done]
    assert sorted(r.rid for r in done) == [r.rid for r in base]
    assert statuses.count("FAILED") == 1
    assert statuses.count("OK") == len(base) - 1
    for r in done:
        if r.status == "OK":
            assert r.out == ref[r.rid], f"survivor {r.rid} diverged"
    assert eng.alloc.n_free == eng.alloc.n_pages


def test_persistent_fault_schedule_fails_stop_not_hang():
    cfg, _, _, params = _model("qwen3-8b")
    inject.arm(seed=0, rates={"serve.decode": 1.0})
    try:
        eng = PagedServeEngine(cfg, params, slots=1, max_seq=16, page_size=4,
                               prefill_chunk=8, stall_limit=6, impl="torch")
        eng.submit(Request(0, np.arange(1, 4, dtype=np.int32), 3))
        with pytest.raises(EngineStalledError) as ei:
            eng.run()
    finally:
        inject.disarm()
    diag = ei.value.diagnostics
    assert diag["stall_limit"] == 6 and diag["active"] == {0: 0}
    assert "pages_free" in diag and "preemptions" in diag


# ---------------------------------------------------------------------------
# lifecycle, the sanitizer's coverage, the CLI
# ---------------------------------------------------------------------------

def test_rejection_cancel_and_deadlines():
    cfg, _, _, params = _model("qwen3-8b")
    now = [0.0]
    eng = PagedServeEngine(cfg, params, slots=2, max_seq=16, page_size=4,
                           n_pages=2, impl="torch", clock=lambda: now[0])
    big = Request(0, np.arange(1, 6, dtype=np.int32), 10)   # 14 rows > 8
    assert eng.submit(big) is False and big.status == "REJECTED"
    full = Request(1, np.arange(1, 17, dtype=np.int32), 2)  # fills budget
    assert eng.submit(full) is False and full.status == "REJECTED"
    late = Request(2, np.arange(1, 4, dtype=np.int32), 3, deadline_s=5.0)
    assert eng.submit(late) and late.deadline_at == 5.0
    vic = Request(3, np.arange(1, 4, dtype=np.int32), 3)
    eng.submit(vic)
    assert eng.cancel(3) and not eng.cancel(3) and not eng.cancel(99)
    now[0] = 10.0
    done = eng.run()
    assert {r.rid: r.status for r in done} == \
        {0: "REJECTED", 1: "REJECTED", 2: "EXPIRED", 3: "CANCELLED"}
    assert eng.alloc.n_free == eng.alloc.n_pages and eng.run() == []


def test_sanitizer_skips_only_a_family_with_no_pool():
    """The reference's sanitizer flags a pool-less family (rwkv6) as
    corrupt on its first committed slot (ROADMAP queue C); the port checks
    only where a pool exists, and still catches a corrupted page table."""
    from repro.analysis.kv_sanitizer import PagedStateError as JError
    from repro_torch.analysis.kv_sanitizer import PagedStateError

    cfg, jcfg, jparams, params = _model("rwkv6-3b")
    reqs = lambda make: [make(i, np.arange(1, 5, dtype=np.int32), 3)
                         for i in range(2)]
    ref = jserve.PagedServeEngine(jcfg, jparams, slots=2, max_seq=16,
                                  sanitize=True)
    for r in reqs(jserve.Request):
        ref.submit(r)
    with pytest.raises(JError, match="row-unmapped-live"):
        ref.run()
    mine = PagedServeEngine(cfg, params, slots=2, max_seq=16, sanitize=True,
                            impl="torch")
    assert [r.status for r in _run_all(mine, reqs(Request))] == ["OK"] * 2

    cfg, _, _, params = _model("qwen3-8b")
    eng = PagedServeEngine(cfg, params, slots=2, max_seq=16, page_size=4,
                           sanitize=True, impl="torch")
    eng.submit(Request(0, np.arange(1, 6, dtype=np.int32), 4))
    while eng.pos[0] == eng.max_seq:
        eng.step()
    eng.row_map[0, 1] = -2              # a wrap hazard in the live table
    with pytest.raises(PagedStateError, match="kv/negative-row"):
        eng.step()


def _run_all(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return eng.run()


def test_serve_requests_paged_stats():
    cfg, _, _, params = _model("qwen3-8b")
    reqs = make_requests(cfg, 3, 3, seed=4) + \
        [Request(3, np.arange(1, 40, dtype=np.int32), 2)]   # over budget
    done, stats = serve_requests(cfg, params, reqs, slots=2, max_seq=32,
                                 impl="torch", paged=True, page_size=4,
                                 prefill_chunk=4, sanitize=True)
    assert stats["status_counts"] == {"OK": 3, "REJECTED": 1}
    assert stats["generated"] == 9 and stats["preemptions"] == 0
    assert stats["ttft_s"]["count"] == 3


def test_cli_serves_paged_with_the_sanitizer(capsys):
    serve.main(["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu",
                "--paged", "--sanitize", "--page-size", "4", "--pages", "10",
                "--prefill-chunk", "4", "--requests", "6", "--max-new", "5"])
    out = capsys.readouterr().out
    assert "6 requests, 30 tokens" in out and "status: OK=6" in out
    assert re.search(r"\(([1-9]\d*) preemptions\)", out), out
