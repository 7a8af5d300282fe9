"""The port's paging layer against the reference's, on the CPU.

  * ``PageAllocator`` and ``PriorityScheduler`` (copies of the reference's
    with their imports rewritten) give the reference's results, op for op,
    on seeded random op sequences; hypothesis widens the seeds where it is
    installed;
  * ``gather_pages`` matches the reference's bit for bit on random paged
    layouts (allocation, retirement and page reuse interleaved);
  * a parked lane (an all -1 page table at the idle position) never
    touches the pool: its writes land on the pool's scratch row;
  * paged ``decode_step`` is bit-identical to batch-1 dense decode for
    qwen3 and for the gemma2 ring case (dense rings beside pooled global
    layers), the cases of ``tests/test_paged_kv.py``; and in float32 its
    tokens are the reference's paged path's;
  * the kv sanitizer's findings equal the reference's on the states of
    ``tests/test_analysis_kv.py`` and on its random traces.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_analysis_kv as akv
from repro.analysis import kv_sanitizer as jkv
from repro.configs import get_config as jget_config
from repro.launch import paging as jpaging
from repro.launch import serve as jserve
from repro.models import family_module as jfamily
from repro.models import layers as JL
from repro.models import reduced as jreduced
from repro_torch.analysis import kv_sanitizer as kv
from repro_torch.configs import get_config
from repro_torch.launch import paging
from repro_torch.launch.serve import Request
from repro_torch.models import family_module, reduced
from repro_torch.models import layers as L
from repro_torch.models.tree import leaves, params_from_numpy

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                                # pragma: no cover
    HAVE_HYPOTHESIS = False


# ---------------------------------------------------------------------------
# allocator and scheduler: op for op against the reference
# ---------------------------------------------------------------------------

def _alloc_trace(mod, n_pages, page_size, seed, n_ops):
    """Every result (or exception type) of a seeded random op sequence."""
    alloc = mod.PageAllocator(n_pages, page_size)
    rng = np.random.default_rng(seed)
    live, out = [], []
    for _ in range(n_ops):
        r = rng.random()
        try:
            if live and r < 0.35:
                pages = live.pop(int(rng.integers(len(live))))
                alloc.free(pages)
                out.append(("free", alloc.free_pages))
            elif r < 0.45:
                out.append(("free-foreign", alloc.free(
                    [int(rng.integers(n_pages + 2))])))
            else:
                pages = alloc.alloc(int(rng.integers(0, n_pages + 2)))
                live.append(pages)
                out.append(("alloc", pages,
                            alloc.rows(pages, len(pages) * page_size)))
        except (MemoryError, ValueError) as e:
            out.append(type(e).__name__)
        out.append((alloc.n_free, alloc.pages_for(int(rng.integers(40)))))
    return out


def _sched_trace(mod, make, n_slots, age_steps, seed, n_ops):
    """A seeded random sequence of scheduler calls and what each returned
    (rids for requests, the exception type where one is raised)."""
    s = mod.PriorityScheduler(n_slots, max_concurrency=n_slots - 1 or None,
                              age_steps=age_steps)
    rng = np.random.default_rng(seed)
    rid = 0
    out = []
    for _ in range(n_ops):
        op = int(rng.integers(8))
        try:
            if op == 0:
                s.submit(make(rid, np.arange(1, 3, dtype=np.int32), 2,
                              priority=int(rng.integers(3))))
                rid += 1
            elif op == 1:
                s.tick()
            elif op == 2:
                req = s.peek()
                out.append(None if req is None else
                           (req.rid, s.effective_priority(req)))
                if req is not None and rng.random() < 0.7:
                    out.append(s.place(req))
            elif op == 3 and s.active:
                out.append(s.retire(int(rng.choice(sorted(s.active)))).rid)
            elif op == 4 and s.active:
                req = s.preempt(int(rng.choice(sorted(s.active))))
                out.append((req.rid, req.preemptions))
            elif op == 5:
                out.append(s.least_deserving())
                if s.active:
                    slot = int(rng.choice(sorted(s.active)))
                    out.append(s.admit_key(slot))
                    out.append(s.least_deserving(s.admit_key(slot)))
            elif op == 6 and s.waiting():
                out.append(s.remove(s.waiting()[0]))
            elif op == 7:
                out.append(s.free_slot())
        except ValueError as e:
            out.append(str(e))
        out.append((s.n_active, s.n_waiting, s.has_work(),
                    sorted((k, r.rid) for k, r in s.active.items()),
                    sorted(r.rid for r in s.waiting())))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_allocator_matches_the_reference(seed):
    args = (9, 3, seed, 80)
    assert _alloc_trace(paging, *args) == _alloc_trace(jpaging, *args)


@pytest.mark.parametrize("seed", range(4))
def test_scheduler_matches_the_reference(seed):
    for n_slots, age in ((3, 4), (1, 0), (4, 32)):
        args = (n_slots, age, seed, 120)
        assert _sched_trace(paging, Request, *args) == \
            _sched_trace(jpaging, jserve.Request, *args)


if HAVE_HYPOTHESIS:

    @given(st.integers(1, 16), st.integers(1, 8), st.integers(0, 2**31 - 1),
           st.integers(1, 80))
    @settings(max_examples=40, deadline=None)
    def test_allocator_matches_the_reference_property(n, ps, seed, n_ops):
        args = (n, ps, seed, n_ops)
        assert _alloc_trace(paging, *args) == _alloc_trace(jpaging, *args)

    @given(st.integers(1, 5), st.integers(0, 6), st.integers(0, 2**31 - 1))
    @settings(max_examples=40, deadline=None)
    def test_scheduler_matches_the_reference_property(n_slots, age, seed):
        args = (n_slots, age, seed, 60)
        assert _sched_trace(paging, Request, *args) == \
            _sched_trace(jpaging, jserve.Request, *args)


# ---------------------------------------------------------------------------
# gather_pages and the scratch row
# ---------------------------------------------------------------------------

def _random_paged_layout(rng, n_pages=6, page_size=3, slots=3, max_seq=12):
    """A pool written through a page table grown in random interleaved
    order, with retirement and page reuse (tests/test_paged_kv.py)."""
    alloc = paging.PageAllocator(n_pages, page_size)
    pool = np.zeros((n_pages * page_size, 2, 2), np.float32)
    row_map = np.full((slots, max_seq), -1, np.int32)
    pages = [[] for _ in range(slots)]
    used = np.zeros(slots, np.int32)
    stamp = 1.0
    for _ in range(60):
        s = int(rng.integers(slots))
        if rng.random() < 0.15 and pages[s]:
            alloc.free(pages[s])
            pages[s], used[s] = [], 0
            row_map[s, :] = -1
            continue
        if used[s] >= max_seq:
            continue
        if len(pages[s]) * page_size <= used[s]:
            if not alloc.n_free:
                continue
            pages[s] += alloc.alloc(1)
            mapped = min(len(pages[s]) * page_size, max_seq)
            row_map[s, :mapped] = alloc.rows(pages[s], mapped)
        pool[row_map[s, used[s]]] = stamp
        stamp += 1.0
        used[s] += 1
    return pool, row_map


@pytest.mark.parametrize("seed", range(4))
def test_gather_pages_matches_the_reference(seed):
    pool, row_map = _random_paged_layout(np.random.default_rng(seed))
    want = np.asarray(JL.gather_pages(jnp.asarray(pool),
                                      jnp.asarray(row_map)))
    got = L.gather_pages(torch.from_numpy(pool), row_map).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[row_map < 0] == 0).all()


if HAVE_HYPOTHESIS:

    @given(st.integers(0, 2**31 - 1), st.integers(1, 8), st.integers(1, 4))
    @settings(max_examples=15, deadline=None)
    def test_gather_pages_matches_the_reference_property(seed, n, ps):
        pool, row_map = _random_paged_layout(np.random.default_rng(seed),
                                             n_pages=n, page_size=ps,
                                             slots=2, max_seq=8)
        want = np.asarray(JL.gather_pages(jnp.asarray(pool),
                                          jnp.asarray(row_map)))
        got = L.gather_pages(torch.from_numpy(pool), row_map).numpy()
        np.testing.assert_array_equal(got, want)


def test_pool_rows_send_every_dropped_write_to_the_scratch_row():
    row_map = np.array([[4, 5, -1, -1], [-1, -1, -1, -1]], np.int32)
    cpos = torch.tensor([1, 4])                     # slot 1 parked at L
    got = L._pool_rows(row_map, cpos, 3, scratch=99)
    assert got.tolist() == [[5, 99, 99], [99, 99, 99]]
    # a step's page table names the pool's last row, the scratch row
    pages = L.page_table(row_map, cpos, 3, "cpu")
    assert pages.write.tolist() == [[5, -1, -1], [-1, -1, -1]]
    assert pages.map.tolist() == row_map.tolist()


@functools.lru_cache(maxsize=None)
def _family(arch, over=(), dtype="float32"):
    over = dict(over, dtype=dtype)
    jcfg = jreduced(jget_config(arch), **over)
    jparams = jfamily(jcfg).init(jcfg, jax.random.PRNGKey(0), tp=1)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    return reduced(get_config(arch), **over), jcfg, jparams, params


def test_parked_lane_cannot_touch_the_pool():
    """A lane with an all -1 page table at the idle position writes only
    the scratch row past the pool; the live lane writes only its row."""
    cfg, _, _, params = _family("qwen3-8b", dtype="bfloat16")
    mod = family_module(cfg)
    max_seq, rows = 16, 16
    cache = mod.init_paged_cache(cfg, 2, rows, max_seq, device="cpu")
    assert cache["all"]["k"].shape[1] == rows + 1
    for leaf in leaves(cache):
        leaf.normal_()
    row_map = np.full((2, max_seq), -1, np.int32)
    row_map[0, :4] = [2, 3, 0, 1]                  # slot 0 maps 2 pages
    before = {k: v.clone() for k, v in cache["all"].items()}
    mod.decode_step(params, cfg, cache, torch.tensor([[5], [9]]),
                    [1, max_seq], impl="torch", row_map=row_map)
    for name in ("k", "v"):
        moved = (cache["all"][name] != before[name]).flatten(2).any(-1)
        touched = set(torch.nonzero(moved.any(0)).flatten().tolist())
        assert touched <= {3, rows}, f"{name}: wrote rows {touched}"
        assert 3 in touched


# ---------------------------------------------------------------------------
# paged decode: the batch-1 dense oracle, and the reference's paged path
# ---------------------------------------------------------------------------

def _dense_teacher_forced(cfg, mod, params, prompt, max_new, max_seq):
    cache = mod.init_cache(cfg, 1, max_seq, device="cpu")
    logits = None
    for t, tok in enumerate(prompt):
        logits, cache = mod.decode_step(params, cfg, cache,
                                        torch.tensor([[int(tok)]]), [t],
                                        impl="torch")
    toks = [int(torch.argmax(logits[0, -1]))]
    pos = len(prompt)
    while len(toks) < max_new and pos < max_seq:
        logits, cache = mod.decode_step(params, cfg, cache,
                                        torch.tensor([[toks[-1]]]), [pos],
                                        impl="torch")
        toks.append(int(torch.argmax(logits[0, -1])))
        pos += 1
    return toks


def _paged_lockstep(step, init_cache, has_pool, prompts, max_new, max_seq,
                    page_size):
    """Lockstep greedy decode of several prompts through a paged path: one
    shared pool, pages allocated on demand, so the physical layout
    interleaves the slots (tests/test_paged_kv.py)."""
    slots = len(prompts)
    n_pages = -(-max_seq // page_size) * slots
    alloc = paging.PageAllocator(n_pages, page_size)
    cache = init_cache(slots, n_pages * page_size)
    row_map = np.full((slots, max_seq), -1, np.int32)
    pages = [[] for _ in range(slots)]
    pos = np.zeros(slots, np.int64)
    outs = [[] for _ in range(slots)]

    def live(s):
        return len(outs[s]) < max_new and pos[s] < max_seq

    while any(live(s) for s in range(slots)):
        toks = np.zeros((slots, 1), np.int64)
        step_pos = np.full(slots, max_seq, np.int64)
        for s, prompt in enumerate(prompts):
            if not live(s):
                continue
            if has_pool and len(pages[s]) * page_size < pos[s] + 1:
                pages[s] += alloc.alloc(1)
                mapped = min(len(pages[s]) * page_size, max_seq)
                row_map[s, :mapped] = alloc.rows(pages[s], mapped)
            toks[s, 0] = prompt[pos[s]] if pos[s] < len(prompt) \
                else outs[s][-1]
            step_pos[s] = pos[s]
        logits, cache = step(cache, toks, step_pos, row_map)
        nxt = np.asarray(logits[:, -1]).argmax(-1)
        for s, prompt in enumerate(prompts):
            if step_pos[s] == max_seq:
                continue
            pos[s] += 1
            if pos[s] >= len(prompt):
                outs[s].append(int(nxt[s]))
    return outs


PAGED_ORACLE_CASES = [("qwen3-8b", ()),
                      ("gemma2-2b", (("local_window", 5), ("n_layers", 4)))]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("page_size", [2, 5])
@pytest.mark.parametrize("arch,over", PAGED_ORACLE_CASES,
                         ids=[c[0] for c in PAGED_ORACLE_CASES])
def test_paged_decode_matches_batch1_dense_decode(arch, over, page_size,
                                                  dtype):
    """Bit-identical tokens to batch-1 dense decode (the reference's bf16
    oracle); in float32 also the reference's paged path, token for token."""
    cfg, jcfg, jparams, params = _family(arch, over, dtype)
    mod, jmod = family_module(cfg), jfamily(jcfg)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (7, 3, 9)]
    max_new, max_seq = 5, 24

    def step(cache, toks, pos, row_map):
        with torch.no_grad():
            logits, cache = mod.decode_step(params, cfg, cache,
                                            torch.from_numpy(toks), pos,
                                            impl="torch", row_map=row_map)
        return logits.float().numpy(), cache

    outs = _paged_lockstep(
        step, lambda b, r: mod.init_paged_cache(cfg, b, r, max_seq,
                                                device="cpu"),
        True, prompts, max_new, max_seq, page_size)
    oracle = [_dense_teacher_forced(cfg, mod, params, p, max_new, max_seq)
              for p in prompts]
    assert outs == oracle
    if dtype == "float32":
        def jstep(cache, toks, pos, row_map):
            return jmod.decode_step(
                jparams, jcfg, cache, jnp.asarray(toks, jnp.int32),
                jnp.asarray(pos, jnp.int32), tp=1, impl="xla",
                row_map=jnp.asarray(row_map))
        want = _paged_lockstep(
            jstep, lambda b, r: jmod.init_paged_cache(jcfg, b, r, max_seq,
                                                      1),
            True, prompts, max_new, max_seq, page_size)
        assert outs == want


# ---------------------------------------------------------------------------
# kv sanitizer: the reference's findings on the reference's test states
# ---------------------------------------------------------------------------

def _findings(mod, **over):
    s = akv._state()
    s.update(over)
    return [(f.rule, f.site, f.detail) for f in mod.check_paged_state(
        s["row_map"], s["pos"], s["pages"], n_pages=s["n_pages"],
        page_size=s["page_size"], free_pages=s["free_pages"],
        held_pages=s["held_pages"], max_seq=s["max_seq"])]


def _corrupt(i, j, v):
    rm = akv._state()["row_map"]
    rm[i, j] = v
    return {"row_map": rm}


SANITIZER_STATES = {
    "valid": {},
    "double-mapped-row": _corrupt(1, 0, 1),
    "leaked-page": {"free_pages": set(), "held_pages": {0, 1, 2}},
    "negative-row": _corrupt(0, 1, -2),
    "unmapped-live": _corrupt(0, 1, -1),
    "free-and-held": {"free_pages": {1, 3}},
    "foreign-page": {"held_pages": {0, 1}},
    "row-out-of-range": _corrupt(0, 0, 8),
    "row-on-unheld-page": _corrupt(1, 1, 6),
    "page-double-owned": {"pages": [[0, 1], [1]], "held_pages": {0, 1},
                          "free_pages": {2, 3}},
    "pos-out-of-range": {"pos": np.array([5, 2])},
}


@pytest.mark.parametrize("name", sorted(SANITIZER_STATES))
def test_sanitizer_findings_equal_the_reference(name):
    over = SANITIZER_STATES[name]
    got = _findings(kv, **over)
    assert got == _findings(jkv, **over)
    assert (got == []) == (name == "valid")


@pytest.mark.parametrize("seed", range(3))
def test_trace_checker_equals_the_reference(seed):
    ops = akv._random_trace(np.random.default_rng(seed))
    ops.append({"op": "alloc", "slot": 1, "pages": [0]})  # may steal
    ops.append({"op": "map", "slot": 1, "rows": 2})

    def run(mod):
        tc = mod.TraceChecker(n_pages=8, page_size=2, slots=3, max_seq=6)
        return [(f.rule, f.site, f.detail) for f in tc.check_trace(
            [dict(op) for op in ops])]

    assert run(kv) == run(jkv)
