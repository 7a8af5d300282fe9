"""Continuous-batching serving engines (DESIGN.md §11, §12), in PyTorch.

Port of ``repro/launch/serve.py``.  Requests arrive
with prompts of different lengths; an FCFS scheduler packs them into a fixed
number of decode *slots*.  Admission runs one prefill over the whole prompt
(a single causal forward whose K/V are scattered into that slot alone) and
every decode step advances all active slots at once, each at its own
absolute position.

Invariant (the per-slot position contract): slot ``s`` holds a request whose
next token will be written at ``pos[s]``; its cache rows ``< pos[s]``
describe exactly its own prompt + generated prefix and nothing else.
Admission re-establishes the invariant by *replacing* the whole slot slice,
so a retired tenant's leftovers can never leak into the next request.  A
slot that is idle still takes part in the batched decode step: its writes
land past the cache (``pos == max_seq``) and are dropped.

The paged engine (:class:`PagedServeEngine`, DESIGN.md §12) keeps the same
per-slot position contract but virtualizes the KV rows themselves: full-length
attention KV lives in one physical pool of fixed-size pages, a per-slot page
table (``row_map``) supplies the slot -> row indirection, admission is gated on
free *pages* rather than free slots, prefill is chunked and interleaved with
decode, and low-priority requests are preempted (swapped out to host memory,
bit-exactly) under page pressure.

Tensor-parallel serving (``mesh=``, ``--mesh data=D,model=T``) is SPMD:
every rank runs the same host scheduler on the same requests, on its own
shard of the params and caches (``distributed.local``); the logits reach
every rank whole, so every rank commits the same tokens.  Rank 0 prints.
The data axis replicates the engine (each data rank serves every slot).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      --smoke --device cpu [--paged --page-size 8 --pages 24 --sanitize]
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
      --smoke --device cpu --mesh data=1,model=2
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.analysis.kv_sanitizer import assert_engine
from repro_torch.configs import MODEL_IDS, get_config
from repro_torch.ft import ProgressWatchdog, inject
from repro_torch.ft.inject import InjectedFault
from repro_torch.launch.paging import PageAllocator, PriorityScheduler
from repro_torch.distributed.sharding import tp_size
from repro_torch.launch.steps import (make_cache, make_decode_step,
                                      make_prefill_step, resolve_tp,
                                      shard_params)
from repro_torch.models import family_module, reduced
from repro_torch.models.tree import leaves, tree_map

#: Terminal request statuses (DESIGN.md §14).  Every submitted request ends
#: in exactly one of these; ``PENDING`` is the only non-terminal state.
TERMINAL_STATUSES = ("OK", "CANCELLED", "EXPIRED", "REJECTED", "FAILED")

# the reference's name for the TP degree of a mesh-hosted engine
_resolve_mesh_tp = resolve_tp


class EngineStalledError(RuntimeError):
    """``run()`` made no progress for ``stall_limit`` consecutive engine
    steps: fail-stop with a diagnosable snapshot instead of an infinite
    loop (``.diagnostics`` holds queue/slot state at the stall)."""

    def __init__(self, msg: str, diagnostics: dict | None = None):
        super().__init__(msg)
        self.diagnostics = diagnostics or {}


@dataclasses.dataclass
class Request:
    """One generation request.  ``next_token`` is −1 until prefill seeds
    it, then always the token the next decode step consumes.  ``priority``
    is a small non-negative int, 0 = most urgent (paged engine only; the
    FCFS engine ignores it).  ``deadline_s`` is an optional relative
    deadline (seconds from engine submit); the engine stamps
    ``deadline_at`` and enforces it at admission and per step.  ``status``
    is ``PENDING`` until the request reaches exactly one terminal status
    (:data:`TERMINAL_STATUSES`)."""

    rid: int
    prompt: np.ndarray
    max_new: int
    max_seq: int | None = None     # per-request context budget (rows of KV)
    priority: int = 0
    deadline_s: float | None = None    # relative deadline, stamped at submit
    next_token: int = -1
    out: list[int] = dataclasses.field(default_factory=list)
    submit_seq: int = -1           # stamped by the scheduler at submit
    preemptions: int = 0
    status: str = "PENDING"
    deadline_at: float | None = None   # absolute, on the engine's clock
    submit_time: float | None = None
    admit_time: float | None = None    # first slot placement (queue exit)
    first_token_time: float | None = None
    finish_time: float | None = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32)
        if self.prompt.ndim != 1 or self.prompt.size == 0:
            raise ValueError(
                f"request {self.rid}: prompt must be a non-empty 1-D token "
                f"array (zero-length prompts have no logits to seed decode)")
        if self.max_new < 1:
            raise ValueError(f"request {self.rid}: max_new must be >= 1")
        if not isinstance(self.priority, (int, np.integer)) \
                or isinstance(self.priority, bool) or self.priority < 0:
            raise ValueError(f"request {self.rid}: priority must be a "
                             f"non-negative int, got {self.priority!r}")
        self.priority = int(self.priority)

    @property
    def queue_latency(self) -> float | None:
        """Wall-clock submit → first token, None until the first token."""
        if self.submit_time is None or self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time


# -- request-lifecycle telemetry (DESIGN.md §13) ----------------------------
# Each helper is a single obs.state() read when tracing is disabled: args
# dicts and metric lookups only happen behind the `st is not None` guard.


def _obs_submit(req: Request) -> None:
    if req.submit_time is None:
        req.submit_time = time.time()
    st = obs.state()
    if st is not None:
        st.tracer.instant("req.submit", {"rid": req.rid,
                                         "prompt": len(req.prompt),
                                         "priority": req.priority})
        st.metrics.counter("serve.submitted").inc()


def _obs_admit(req: Request, slot: int, resumed: bool = False) -> None:
    first = req.admit_time is None
    if first:
        req.admit_time = time.time()
    st = obs.state()
    if st is not None:
        st.tracer.instant("req.resume" if resumed else "req.admit",
                          {"rid": req.rid, "slot": slot})
        if resumed:
            st.metrics.counter("serve.resumes").inc()
        if first and req.submit_time is not None:
            st.metrics.histogram("serve.queue_wait_s").observe(
                req.admit_time - req.submit_time)


def _obs_first_token(req: Request) -> None:
    if req.first_token_time is not None:
        return
    req.first_token_time = time.time()
    st = obs.state()
    if st is not None:
        st.tracer.instant("req.first_token", {"rid": req.rid})
        if req.submit_time is not None:
            st.metrics.histogram("serve.ttft_s").observe(
                req.first_token_time - req.submit_time)


def _obs_finish(req: Request) -> None:
    if req.status != "PENDING":   # terminal transition is exactly-once
        return
    req.status = "OK"
    req.finish_time = time.time()
    st = obs.state()
    if st is not None:
        st.tracer.instant("req.retire", {"rid": req.rid,
                                         "tokens": len(req.out)})
        st.metrics.counter("serve.retired").inc()
        if req.submit_time is not None:
            st.metrics.histogram("serve.e2e_s").observe(
                req.finish_time - req.submit_time)


def _obs_degrade(req: Request, status: str, detail: str = "") -> bool:
    """Exactly-once degraded terminal transition (CANCELLED / EXPIRED /
    REJECTED / FAILED); False (and no telemetry) if ``req`` is already
    terminal."""
    if req.status != "PENDING":
        return False
    assert status in TERMINAL_STATUSES and status != "OK", status
    req.status = status
    req.finish_time = time.time()
    st = obs.state()
    if st is not None:
        args = {"rid": req.rid, "status": status}
        if detail:
            args["detail"] = detail
        st.tracer.instant("req.degrade", args)
        st.metrics.counter(f"serve.requests_{status.lower()}").inc()
    return True


class FCFSScheduler:
    """First-come-first-served slot scheduler: pure bookkeeping, no model.

    Owns the waiting queue and the slot occupancy table.  The engine asks
    :meth:`admit` which requests enter which slots (lowest free slot first,
    queue order preserved) and calls :meth:`retire` when a request finishes;
    ``max_concurrency`` caps simultaneously active requests (1 == the
    sequential one-request-at-a-time baseline).
    """

    def __init__(self, n_slots: int, max_concurrency: int | None = None):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = n_slots
        self.max_concurrency = min(max_concurrency or n_slots, n_slots)
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: list[Request | None] = [None] * n_slots

    @property
    def active(self) -> dict[int, Request]:
        return {s: r for s, r in enumerate(self.slots) if r is not None}

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.slots)

    def has_work(self) -> bool:
        return bool(self.queue) or self.n_active > 0

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def waiting(self) -> list[Request]:
        return list(self.queue)

    def remove(self, req: Request) -> bool:
        """Pull a waiting request out of the queue (cancellation / deadline
        expiry); False if it was not waiting."""
        if req in self.queue:
            self.queue.remove(req)
            return True
        return False

    def admit(self) -> list[tuple[int, Request]]:
        """Assign queued requests to free slots, FCFS, up to the
        concurrency cap.  Returns the new (slot, request) pairs."""
        placed = []
        for slot in range(self.n_slots):
            if not self.queue or self.n_active >= self.max_concurrency:
                break
            if self.slots[slot] is None:
                req = self.queue.popleft()
                self.slots[slot] = req
                placed.append((slot, req))
        return placed

    def retire(self, slot: int) -> Request:
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} is not occupied")
        self.slots[slot] = None
        return req


def _write_slot(cache, slot_cache, slot: int, axes, prows=None) -> None:
    """Copy a batch-1 packed prefill cache into slot ``slot`` of the shared
    cache, in place: per-slot leaves replace the slot's whole slice (the
    KV/state reset of DESIGN.md §11); pool leaves (axis ``"pool"``, the
    paged cache) land at the slot's page-table rows ``prows``."""
    def wr(c, pc, ax):
        if ax == "pool":
            c[:, prows] = pc.select(1, 0).to(c.dtype)
        else:
            c.select(ax, slot).copy_(pc.select(ax, 0))

    tree_map(wr, cache, slot_cache, axes)


class ServeEngine:
    """Per-slot continuous batching around one model + one shared cache,
    on the device that holds ``params``.

    Lifecycle per request: ``submit`` → (scheduler) → admission prefill
    (one forward over the prompt; the packed slot cache *replaces* the slot
    slice, resetting any stale KV; ``pos[slot]`` := prompt length; the
    prompt's last logits seed ``out[0]``) → batched decode steps (each
    active slot consumes its ``next_token`` at its own ``pos``, emits one
    token, ``pos[slot] += 1``) → retirement when ``len(out) == max_new`` or
    the per-request context budget is exhausted.
    """

    def __init__(self, cfg, params, *, slots: int = 4, max_seq: int = 64,
                 tp: int = 1, impl: str = "cuda",
                 max_concurrency: int | None = None, mesh=None,
                 clock=time.monotonic, stall_limit: int = 256):
        if cfg.embed_inputs:
            raise ValueError(f"{cfg.name} is encoder-only: no decode loop "
                             f"(DESIGN.md §5)")
        self.cfg, self.mod, self.mesh = cfg, family_module(cfg), mesh
        if mesh is not None:
            # whole params (padded for the mesh's 'model' axis) or
            # DTensors -> this rank's compute view
            tp = _resolve_mesh_tp(mesh, tp)
            params = shard_params(cfg, params, mesh)
        self.params = params
        self.device = params["embed"]["table"].device
        self.n_slots, self.max_seq = slots, max_seq
        self.scheduler = FCFSScheduler(slots, max_concurrency)
        self._decode = make_decode_step(cfg, tp=tp, impl=impl, mesh=mesh)
        self._prefill = make_prefill_step(cfg, tp=tp, impl=impl,
                                          cache_len=max_seq, mesh=mesh)
        self._axes = self.mod.cache_slot_axes(cfg)
        self.cache = make_cache(
            cfg, mesh, lambda dev: self.mod.init_cache(cfg, slots, max_seq,
                                                       tp, device=dev),
            self.mod.cache_specs(cfg), self.device)
        self.pos = np.zeros(slots, np.int64)   # per-slot next write position
        self.clock = clock
        self.stall_limit = stall_limit
        self.terminal: list[Request] = []   # degraded terminals, undrained
        self.decode_steps = 0
        self.prefill_tokens = 0
        self.generated = 0

    # -- request intake ----------------------------------------------------

    def _budget(self, req: Request) -> int:
        return min(self.max_seq, req.max_seq or self.max_seq)

    def submit(self, req: Request) -> bool:
        """Queue ``req``; False when it can never be served (status becomes
        REJECTED and it is reported through ``run()`` like any terminal)."""
        _obs_submit(req)
        if len(req.prompt) >= self._budget(req):
            self._finish_terminal(req, "REJECTED", f"prompt "
                                  f"({len(req.prompt)} tokens) must leave "
                                  f"room under its context budget "
                                  f"{self._budget(req)}")
            return False
        if req.deadline_s is not None:
            req.deadline_at = self.clock() + req.deadline_s
        self.scheduler.submit(req)
        return True

    # -- graceful degradation (DESIGN.md §14) ------------------------------

    def _finish_terminal(self, req: Request, status: str,
                         detail: str = "") -> None:
        _obs_degrade(req, status, detail)
        self.terminal.append(req)

    def cancel(self, rid: int) -> bool:
        """Cancel a waiting or active request; False if ``rid`` is unknown
        or already terminal.  The slot (if any) frees immediately."""
        for req in self.scheduler.waiting():
            if req.rid == rid:
                self.scheduler.remove(req)
                self._finish_terminal(req, "CANCELLED")
                return True
        for slot, req in list(self.scheduler.active.items()):
            if req.rid == rid:
                self.scheduler.retire(slot)
                self._finish_terminal(req, "CANCELLED")
                return True
        return False

    def _purge_expired(self) -> None:
        """Drop every request past its deadline, waiting or active, at the
        top of each step (admission control + per-step enforcement)."""
        now = self.clock()
        for req in self.scheduler.waiting():
            if req.deadline_at is not None and now >= req.deadline_at:
                self.scheduler.remove(req)
                self._finish_terminal(req, "EXPIRED")
        for slot, req in list(self.scheduler.active.items()):
            if req.deadline_at is not None and now >= req.deadline_at:
                self.scheduler.retire(slot)
                self._finish_terminal(req, "EXPIRED")

    # -- the serving loop --------------------------------------------------

    @torch.no_grad()
    def _admit(self) -> list[Request]:
        """Prefill newly admitted requests into their slots; returns any
        that finish immediately (max_new == 1)."""
        finished = []
        for slot, req in self.scheduler.admit():
            _obs_admit(req, slot)
            prompt = torch.as_tensor(req.prompt[None, :], dtype=torch.int64,
                                     device=self.device)
            with obs.span("serve.prefill"):
                logits, slot_cache = self._prefill(self.params, prompt)
                _write_slot(self.cache, slot_cache, slot, self._axes)
            self.pos[slot] = len(req.prompt)
            tok = int(torch.argmax(logits[0, -1]))
            req.next_token = tok
            req.out.append(tok)
            _obs_first_token(req)
            self.prefill_tokens += len(req.prompt)
            self.generated += 1
            if len(req.out) >= req.max_new:
                _obs_finish(req)
                finished.append(self.scheduler.retire(slot))
        return finished

    @torch.no_grad()
    def step(self) -> list[Request]:
        """Admit what fits, then run one batched decode step over every
        slot (idle slots included).  Returns the requests that finished
        this step."""
        self._purge_expired()
        finished = self._admit()
        active = self.scheduler.active
        if not active:
            return finished
        toks = np.zeros((self.n_slots, 1), np.int64)
        for slot, req in active.items():
            toks[slot, 0] = req.next_token
        with obs.span("serve.decode_step"):
            logits, self.cache = self._decode(
                self.params, self.cache,
                torch.as_tensor(toks, device=self.device), self.pos)
        self.decode_steps += 1
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        for slot, req in active.items():
            tok = int(nxt[slot])
            req.out.append(tok)
            req.next_token = tok
            self.pos[slot] += 1
            self.generated += 1
            if len(req.out) >= req.max_new \
                    or self.pos[slot] >= self._budget(req):
                _obs_finish(req)
                finished.append(self.scheduler.retire(slot))
        st = obs.state()
        if st is not None:
            st.metrics.histogram(
                "serve.decode_batch",
                obs.DEFAULT_COUNT_EDGES).observe(len(active))
        return finished

    def run(self) -> list[Request]:
        """Serve until queue and slots drain.  Returns every submitted
        request in rid order, finished (status OK) and degraded terminals
        alike.  A no-progress stall raises :class:`EngineStalledError`
        instead of looping forever."""
        done: list[Request] = []
        dog = ProgressWatchdog(self.stall_limit)
        while self.scheduler.has_work():
            done.extend(self.step())
            dog.beat((self.generated, self.prefill_tokens,
                      len(done) + len(self.terminal)))
            if dog.stalled:
                raise EngineStalledError(
                    f"no progress in {self.stall_limit} engine steps",
                    diagnostics={
                        "stall_limit": self.stall_limit,
                        "waiting": [r.rid for r in self.scheduler.waiting()],
                        "active": {s: r.rid for s, r in
                                   self.scheduler.active.items()},
                        "generated": self.generated,
                    })
        done.extend(self.terminal)
        self.terminal = []
        return sorted(done, key=lambda r: r.rid)


@dataclasses.dataclass
class _Prefill:
    """An in-flight chunked prefill: a private batch-1 full-length dense
    cache advanced ``prefill_chunk`` tokens per engine step through the same
    decode step (row_map=None -> dense path).  The cache covers the whole
    prompt so every chunk's queries see their exact causal (and sliding-
    window) context; KV only moves into the shared pool at commit."""
    req: Request
    cache: object
    done: int = 0


class PagedServeEngine:
    """Paged continuous batching (DESIGN.md §12), on the device that holds
    ``params``.

    KV virtualization: full-length attention KV lives in one physical pool
    of ``n_pages`` pages of ``page_size`` rows; ``row_map[slot, i]`` maps a
    slot's logical row ``i`` to its physical pool row (−1 = unmapped).
    Sliding-window rings and recurrent state stay per-slot (already O(1) in
    request length).  Admission is gated on free pages, prefill is chunked
    and interleaved with decode, and page pressure preempts the least
    deserving active request: its pool rows and per-slot state are copied
    out to host memory and restored bit-exactly on resume (no recompute,
    so preemption can never change a request's output).
    """

    def __init__(self, cfg, params, *, slots: int = 4, max_seq: int = 64,
                 page_size: int = 8, n_pages: int | None = None,
                 prefill_chunk: int = 16, tp: int = 1, impl: str = "cuda",
                 max_concurrency: int | None = None, mesh=None,
                 age_steps: int = 32,
                 clock=time.monotonic, stall_limit: int = 256,
                 sanitize: bool = False):
        if cfg.embed_inputs:
            raise ValueError(f"{cfg.name} is encoder-only: no decode loop "
                             f"(DESIGN.md §5)")
        self.cfg, self.mod, self.mesh = cfg, family_module(cfg), mesh
        if mesh is not None:
            tp = _resolve_mesh_tp(mesh, tp)
            params = shard_params(cfg, params, mesh)
        self.params = params
        self.device = params["embed"]["table"].device
        self.n_slots, self.max_seq = slots, max_seq
        self.prefill_chunk = max(1, prefill_chunk)
        self._tp = tp
        if n_pages is None:   # default: same KV capacity as the dense engine
            n_pages = -(-max_seq // page_size) * slots
        self.alloc = PageAllocator(n_pages, page_size)
        self.scheduler = PriorityScheduler(slots, max_concurrency, age_steps)
        # chunked prefill and batched decode run the same decode step: on a
        # private dense cache (no row_map) and on the paged cache
        self._decode = make_decode_step(cfg, tp=tp, impl=impl, mesh=mesh)
        self._axes = self.mod.paged_slot_axes(cfg)
        self._has_pool = "pool" in leaves(self._axes)
        self.cache = make_cache(
            cfg, mesh, lambda dev: self.mod.init_paged_cache(
                cfg, slots, n_pages * page_size, max_seq, tp, device=dev),
            self.mod.paged_cache_specs(cfg), self.device)
        self.row_map = np.full((slots, max_seq), -1, np.int32)
        # pos sentinel max_seq: an idle/prefilling slot's decode-batch lane
        # writes past the page table, onto the pool's scratch row
        self.pos = np.full(slots, max_seq, np.int64)
        self._pages: list[list[int]] = [[] for _ in range(slots)]
        self._prefills: dict[int, _Prefill] = {}
        self._suspended: dict[int, tuple[int, object]] = {}   # rid -> swap
        self.clock = clock
        self.stall_limit = stall_limit
        # debug mode: re-check the page-table/allocator invariants after
        # every tick (analysis.kv_sanitizer; raises PagedStateError)
        self.sanitize = sanitize
        self.terminal: list[Request] = []   # degraded terminals, undrained
        self.decode_steps = 0
        self.prefill_tokens = 0
        self.generated = 0
        self.preemptions = 0

    # -- request intake ----------------------------------------------------

    def _budget(self, req: Request) -> int:
        return min(self.max_seq, req.max_seq or self.max_seq)

    def submit(self, req: Request) -> bool:
        """Queue ``req``; False when it can never be served (status becomes
        REJECTED and it is reported through ``run()`` like any terminal)."""
        _obs_submit(req)
        if len(req.prompt) >= self._budget(req):
            self._finish_terminal(req, "REJECTED", f"prompt "
                                  f"({len(req.prompt)} tokens) must leave "
                                  f"room under its context budget "
                                  f"{self._budget(req)}")
            return False
        if self._has_pool:
            # a request admitted alone must always fit: its peak row count
            # is bounded by both its budget and prompt + max_new - 1
            peak = min(len(req.prompt) + req.max_new - 1, self._budget(req))
            if self.alloc.pages_for(peak) > self.alloc.n_pages:
                self._finish_terminal(
                    req, "REJECTED",
                    f"needs {self.alloc.pages_for(peak)} pages at peak, "
                    f"pool only has {self.alloc.n_pages}")
                return False
        if req.deadline_s is not None:
            req.deadline_at = self.clock() + req.deadline_s
        self.scheduler.submit(req)
        return True

    # -- graceful degradation (DESIGN.md §14) ------------------------------

    def _finish_terminal(self, req: Request, status: str,
                         detail: str = "") -> None:
        _obs_degrade(req, status, detail)
        self.terminal.append(req)

    def _drop_slot(self, slot: int) -> Request:
        """Tear down an active slot without completing its request: the
        in-flight prefill (if any) is discarded and every page returns to
        the pool."""
        req = self.scheduler.retire(slot)
        self._prefills.pop(slot, None)
        self._release(slot)
        return req

    def cancel(self, rid: int) -> bool:
        """Cancel a waiting, suspended, or active request; False if ``rid``
        is unknown or already terminal.  Pages free immediately."""
        for req in self.scheduler.waiting():
            if req.rid == rid:
                self.scheduler.remove(req)
                self._suspended.pop(rid, None)   # swapped-out snapshot
                self._finish_terminal(req, "CANCELLED")
                return True
        for slot, req in list(self.scheduler.active.items()):
            if req.rid == rid:
                self._drop_slot(slot)
                self._finish_terminal(req, "CANCELLED")
                return True
        return False

    def _purge_expired(self) -> None:
        """Drop every request past its deadline, waiting, suspended or
        active, at the top of each step."""
        now = self.clock()
        for req in self.scheduler.waiting():
            if req.deadline_at is not None and now >= req.deadline_at:
                self.scheduler.remove(req)
                self._suspended.pop(req.rid, None)
                self._finish_terminal(req, "EXPIRED")
        for slot, req in list(self.scheduler.active.items()):
            if req.deadline_at is not None and now >= req.deadline_at:
                self._drop_slot(slot)
                self._finish_terminal(req, "EXPIRED")

    # -- paging ------------------------------------------------------------

    def _need_pages(self, req: Request) -> int:
        """Free pages required to (re)start ``req`` and take one decode
        step: prompt rows + 1 fresh, suspended rows + 1 on resume."""
        if not self._has_pool:
            return 0
        rows = self._suspended[req.rid][0] if req.rid in self._suspended \
            else len(req.prompt)
        return self.alloc.pages_for(min(rows + 1, self._budget(req)))

    def _release(self, slot: int) -> None:
        if self._pages[slot]:
            self.alloc.free(self._pages[slot])
        self._pages[slot] = []
        self.row_map[slot, :] = -1
        self.pos[slot] = self.max_seq

    def _map_pages(self, slot: int, pages: list[int]) -> None:
        """Append ``pages`` to the slot's table, mapping their rows."""
        ps = self.alloc.page_size
        start = len(self._pages[slot]) * ps
        self._pages[slot].extend(pages)
        stop = min(len(self._pages[slot]) * ps, self.max_seq)
        self.row_map[slot, start:stop] = np.asarray(
            self.alloc.rows(self._pages[slot], stop)[start:], np.int32)

    def _slot_rows(self, slot: int, n: int) -> torch.Tensor:
        """The slot's first ``n`` physical pool rows, on the device."""
        return torch.as_tensor(self.row_map[slot, :n].astype(np.int64),
                               device=self.device)

    def _reclaim(self, need: int, challenger: int) -> bool:
        """Preempt strictly less deserving page-holding slots until ``need``
        pages are free; False if no such victim remains."""
        while self.alloc.n_free < need:
            key = self.scheduler.admit_key(challenger)
            cands = [(self.scheduler.admit_key(s), s)
                     for s in list(self.scheduler.active)
                     if s != challenger and self._pages[s]]
            if not cands:
                return False
            vkey, victim = max(cands)
            if vkey <= key:
                return False
            self._preempt(victim)
        return True

    def _grow(self, slot: int) -> bool:
        """Ensure the slot's next write row is mapped, allocating (and under
        pressure reclaiming) pages; False = the slot itself was preempted."""
        if not self._has_pool:
            return True
        ps = self.alloc.page_size
        while len(self._pages[slot]) * ps < self.pos[slot] + 1:
            if self.alloc.n_free < 1 and not self._reclaim(1, slot):
                self._preempt(slot)
                return False
            try:
                pages = self.alloc.alloc(1)
            except MemoryError:
                # injected (or genuine) allocation failure degrades exactly
                # like page pressure: swap out bit-exactly, retry later
                self._preempt(slot)
                return False
            self._map_pages(slot, pages)
        return True

    # -- preemption: swap-out / swap-in (bit-exact, no recompute) ----------

    def _preempt(self, slot: int) -> None:
        req = self.scheduler.slots[slot]
        if slot in self._prefills:
            del self._prefills[slot]     # partial prefill restarts on resume
        else:
            self._swap_out(slot, req)
        self._requeue(slot, req)

    def _requeue(self, slot: int, req: Request) -> None:
        """Free the slot and its pages and send its request back to the
        waiting queue, counted as one preemption (engine and telemetry)."""
        self._release(slot)
        self.scheduler.preempt(slot)
        self.preemptions += 1
        st = obs.state()
        if st is not None:
            st.tracer.instant("req.preempt", {"rid": req.rid, "slot": slot})
            st.metrics.counter("serve.preemptions").inc()

    def _swap_out(self, slot: int, req: Request) -> None:
        """Copy the slot's pool rows and per-slot state to host memory: a
        copy, never a view, since the cache is written in place and the
        next tenant of these pages and this slot overwrites them."""
        rows = int(self.pos[slot])
        prows = self._slot_rows(slot, rows)

        def grab(c, ax):
            part = c[:, prows] if ax == "pool" else c.select(ax, slot)
            return part.to("cpu", copy=True)

        self._suspended[req.rid] = (rows, tree_map(grab, self.cache,
                                                   self._axes))

    def _swap_in(self, slot: int, req: Request) -> None:
        rows, snap = self._suspended[req.rid]
        if self._has_pool:
            # allocate BEFORE dropping the host snapshot: an (injected)
            # MemoryError here leaves the suspension intact, so the caller
            # can requeue the request without losing its state
            self._map_pages(slot, self.alloc.alloc(
                self.alloc.pages_for(rows)))
        prows = self._slot_rows(slot, rows)
        del self._suspended[req.rid]

        def put(c, s, ax):
            if ax == "pool":
                c[:, prows] = s.to(c.device)
            else:
                c.select(ax, slot).copy_(s)

        tree_map(put, self.cache, snap, self._axes)
        self.pos[slot] = rows

    # -- the serving loop --------------------------------------------------

    def _start(self, slot: int, req: Request) -> None:
        # preemptions > 0 without a swap snapshot means the request was
        # preempted mid-prefill: the restart is still a resume of its
        # lifecycle, not a fresh admission
        _obs_admit(req, slot,
                   resumed=req.rid in self._suspended or req.preemptions > 0)
        if req.rid in self._suspended:
            self._swap_in(slot, req)
            return
        self.pos[slot] = self.max_seq
        self._prefills[slot] = _Prefill(req, make_cache(
            self.cfg, self.mesh,
            lambda dev: self.mod.init_prefill_cache(
                self.cfg, 1, len(req.prompt), self._tp, device=dev),
            self.mod.cache_specs(self.cfg), self.device))

    def _admit_new(self) -> None:
        """Admit waiting requests in (effective priority, submit) order,
        gated on a free slot AND enough free pages; a strictly lower
        effective-priority active request is preempted to make room."""
        while True:
            req = self.scheduler.peek()
            if req is None:
                return
            if self.scheduler.free_slot() is not None \
                    and self.alloc.n_free >= self._need_pages(req):
                slot = self.scheduler.place(req)
                try:
                    self._start(slot, req)
                except MemoryError:
                    # injected page fault while re-admitting: undo the
                    # placement and yield to the next step (retrying
                    # inside this tick could livelock on a rate-based
                    # fault schedule)
                    self._prefills.pop(slot, None)
                    self._requeue(slot, req)
                    return
                continue
            victim = self.scheduler.least_deserving()
            if victim is None or self.scheduler.admit_key(victim)[0] <= \
                    self.scheduler.effective_priority(req):
                return
            self._preempt(victim)

    def _prefill_tick(self, finished: list[Request]) -> None:
        """Advance every in-flight prefill by one chunk; commit finished
        ones into pool pages + slot state."""
        for slot in sorted(self._prefills):
            pf = self._prefills[slot]
            req = pf.req
            try:
                inject.check("serve.prefill")
            except InjectedFault as e:
                # fail-stop for this request alone: the private prefill
                # cache is discarded and the slot torn down, so by the
                # per-slot position contract survivors are bit-identical
                self._drop_slot(slot)
                self._finish_terminal(req, "FAILED", str(e))
                continue
            chunk = min(self.prefill_chunk, len(req.prompt) - pf.done)
            toks = torch.as_tensor(req.prompt[None, pf.done:pf.done + chunk],
                                   dtype=torch.int64, device=self.device)
            with obs.span("serve.prefill_chunk"):
                logits, pf.cache = self._decode(self.params, pf.cache, toks,
                                                [pf.done])
            pf.done += chunk
            self.prefill_tokens += chunk
            st = obs.state()
            if st is not None:
                st.tracer.instant("req.prefill_chunk",
                                  {"rid": req.rid, "done": pf.done,
                                   "of": len(req.prompt)})
                st.metrics.counter("serve.prefill_chunks").inc()
            if pf.done < len(req.prompt):
                continue
            del self._prefills[slot]
            self._commit(slot, req, pf.cache, logits, finished)

    def _commit(self, slot: int, req: Request, pcache, logits,
                finished: list[Request]) -> None:
        """Prefill done: seed the first token, then move the prompt's KV
        into freshly allocated pool pages + the slot's per-slot leaves.

        Pages are secured BEFORE the first token is emitted: nothing is
        committed yet, so a page-pressure failure here requeues the request
        as a plain prefill restart (a swap-out would snapshot the idle
        ``pos`` sentinel, and the first token would be emitted twice when
        the prefill reruns).
        """
        n = len(req.prompt)
        # max_new == 1 finishes at commit and never touches the pool
        need = (self.alloc.pages_for(n)
                if self._has_pool and req.max_new > 1 else 0)
        pages: list[int] = []
        if need:
            ok = self.alloc.n_free >= need or self._reclaim(need, slot)
            if ok:
                try:
                    pages = self.alloc.alloc(need)
                except MemoryError:   # injected: degrade like pressure
                    ok = False
            if not ok:
                self._requeue(slot, req)
                return
        tok = int(torch.argmax(logits[0, -1]))
        req.next_token = tok
        req.out.append(tok)
        self.generated += 1
        _obs_first_token(req)
        if len(req.out) >= req.max_new:
            _obs_finish(req)
            finished.append(self.scheduler.retire(slot))
            self.pos[slot] = self.max_seq
            return
        if pages:
            self._map_pages(slot, pages)
        packed = self.mod.pack_paged_slot(self.cfg, pcache, self.max_seq, n)
        _write_slot(self.cache, packed, slot, self._axes,
                    prows=self._slot_rows(slot, n if self._has_pool else 0))
        self.pos[slot] = n

    def _decode_tick(self, finished: list[Request]) -> None:
        """One batched decode step over every committed slot, after mapping
        (or reclaiming) the pages under each slot's next write row."""
        # injection site FIRST: nothing is mutated yet, so step() can drop
        # the whole tick as a transient and retry next step
        inject.check("serve.decode")
        order = sorted((s for s in self.scheduler.active
                        if s not in self._prefills),
                       key=self.scheduler.admit_key)
        # _grow may preempt later slots as reclaim victims: skip them
        decoding = [s for s in order
                    if self.scheduler.slots[s] is not None and self._grow(s)]
        if not decoding:
            return
        toks = np.zeros((self.n_slots, 1), np.int64)
        pos = np.full(self.n_slots, self.max_seq, np.int64)
        for s in decoding:
            toks[s, 0] = self.scheduler.slots[s].next_token
            pos[s] = self.pos[s]
        with obs.span("serve.decode_step"):
            logits, self.cache = self._decode(
                self.params, self.cache,
                torch.as_tensor(toks, device=self.device), pos,
                row_map=self.row_map)
        self.decode_steps += 1
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        for s in decoding:
            req = self.scheduler.slots[s]
            tok = int(nxt[s])
            req.out.append(tok)
            req.next_token = tok
            self.pos[s] += 1
            self.generated += 1
            if len(req.out) >= req.max_new \
                    or self.pos[s] >= self._budget(req):
                _obs_finish(req)
                finished.append(self.scheduler.retire(s))
                self._release(s)
        st = obs.state()
        if st is not None:
            st.metrics.histogram(
                "serve.decode_batch",
                obs.DEFAULT_COUNT_EDGES).observe(len(decoding))

    @torch.no_grad()
    def step(self) -> list[Request]:
        """One engine tick: admissions, one prefill chunk per prefilling
        slot, one batched decode step.  Returns requests finished now."""
        self.scheduler.tick()
        finished: list[Request] = []
        with obs.span("serve.step"):
            self._purge_expired()
            with obs.span("serve.admit"):
                self._admit_new()
            with obs.span("serve.prefill_tick"):
                self._prefill_tick(finished)
            with obs.span("serve.decode_tick"):
                try:
                    self._decode_tick(finished)
                except InjectedFault:
                    # transient tick fault: the injection site is the
                    # tick's first statement, so nothing was mutated; drop
                    # the tick.  A persistent schedule turns into a stall,
                    # which run()'s watchdog converts to fail-stop
                    st = obs.state()
                    if st is not None:
                        st.metrics.counter("serve.tick_faults").inc()
        st = obs.state()
        if st is not None:
            m = st.metrics
            m.gauge("serve.pages_free").set(self.alloc.n_free)
            m.gauge("serve.slots_active").set(self.scheduler.n_active)
            m.gauge("serve.waiting").set(self.scheduler.n_waiting)
        if self.sanitize and self._has_pool:
            # a family with no pool leaf (rwkv6) maps no row, so its live
            # slots would read as unmapped: there is nothing paged to check
            assert_engine(self, site=f"tick{self.decode_steps}")
        return finished

    def run(self) -> list[Request]:
        """Serve until queue and slots drain.  Returns every submitted
        request in rid order, finished (status OK) and degraded terminals
        alike.  A no-progress stall (a persistent fault schedule, or a
        preemption livelock) raises :class:`EngineStalledError` instead of
        looping forever."""
        done: list[Request] = []
        dog = ProgressWatchdog(self.stall_limit)
        while self.scheduler.has_work():
            done.extend(self.step())
            # progress = tokens moved or a request reaching a terminal
            # status; preemption counts are deliberately excluded (they
            # keep incrementing during a livelock)
            dog.beat((self.generated, self.prefill_tokens,
                      len(done) + len(self.terminal)))
            if dog.stalled:
                raise EngineStalledError(
                    f"no progress in {self.stall_limit} engine steps",
                    diagnostics={
                        "stall_limit": self.stall_limit,
                        "waiting": [r.rid for r in self.scheduler.waiting()],
                        "active": {s: r.rid for s, r in
                                   self.scheduler.active.items()},
                        "prefills": sorted(self._prefills),
                        "suspended": sorted(self._suspended),
                        "pages_free": self.alloc.n_free,
                        "preemptions": self.preemptions,
                    })
        done.extend(self.terminal)
        self.terminal = []
        return sorted(done, key=lambda r: r.rid)


def _latency_summary(done: list[Request]) -> dict:
    """Per-run latency summaries through the fixed-bucket histograms
    (DESIGN.md §13): ``ttft_s`` (submit → first token) and ``queue_wait_s``
    (submit → first slot placement).  Buckets span the observed range at
    1/512 resolution."""
    from repro_torch.obs.metrics import Histogram, linear_edges

    def summarize(vals: list[float | None]) -> dict:
        vals = [v for v in vals if v is not None]
        if not vals:
            return {"count": 0, "mean": None,
                    "p50": None, "p95": None, "p99": None}
        lo, hi = min(vals), max(vals)
        if hi <= lo:   # degenerate range: every quantile is the value
            return {"count": len(vals), "mean": lo,
                    "p50": lo, "p95": lo, "p99": lo}
        h = Histogram(linear_edges(lo, hi, 512))
        for v in vals:
            h.observe(v)
        return {"count": h.count, "mean": h.mean, "p50": h.quantile(0.5),
                "p95": h.quantile(0.95), "p99": h.quantile(0.99)}

    return {
        "ttft_s": summarize([r.queue_latency for r in done]),
        "queue_wait_s": summarize(
            [r.admit_time - r.submit_time
             if r.admit_time is not None and r.submit_time is not None
             else None for r in done]),
    }


def serve_requests(cfg, params, requests, *, slots: int = 4,
                   max_seq: int = 64, tp: int = 1, impl: str = "cuda",
                   max_concurrency: int | None = None, paged: bool = False,
                   page_size: int = 8, n_pages: int | None = None,
                   prefill_chunk: int = 16, age_steps: int = 32,
                   stall_limit: int = 256, mesh=None, sanitize: bool = False
                   ) -> tuple[list[Request], dict]:
    """Submit ``requests``, drain the engine, return ``(requests, stats)``:
    every submitted request comes back with a terminal ``status``, counted
    once in ``stats["status_counts"]``.  ``max_concurrency=1`` is the
    sequential one-request-at-a-time baseline (identical math and shapes,
    no batching across requests); ``paged=True`` runs the page-table
    engine of DESIGN.md §12 instead of the slot-pinned one."""
    if paged:
        eng = PagedServeEngine(
            cfg, params, slots=slots, max_seq=max_seq, tp=tp, impl=impl,
            max_concurrency=max_concurrency, page_size=page_size,
            n_pages=n_pages, prefill_chunk=prefill_chunk,
            age_steps=age_steps, stall_limit=stall_limit, mesh=mesh,
            sanitize=sanitize)
    else:
        eng = ServeEngine(cfg, params, slots=slots, max_seq=max_seq, tp=tp,
                          impl=impl, max_concurrency=max_concurrency,
                          stall_limit=stall_limit, mesh=mesh)
    for req in requests:
        eng.submit(req)
    done = eng.run()
    status_counts = collections.Counter(r.status for r in done)
    return done, {"decode_steps": eng.decode_steps,
                  "prefill_tokens": eng.prefill_tokens,
                  "generated": eng.generated,
                  "preemptions": getattr(eng, "preemptions", 0),
                  "status_counts": dict(sorted(status_counts.items())),
                  **_latency_summary(done)}


def make_requests(cfg, n: int, max_new: int, seed: int = 0,
                  lengths: tuple[int, int] = (3, 12), long_every: int = 0,
                  long_lengths: tuple[int, int] = (24, 33),
                  priorities: tuple[int, ...] = (0,),
                  max_new_spread: int = 0) -> list[Request]:
    """Synthetic traffic, the reference's stream bit for bit:
    ``long_every=k`` makes every k-th request a long prompt drawn from
    ``long_lengths``, ``priorities`` cycles per request, and
    ``max_new_spread=s`` draws max_new from ``[max_new-s, max_new+s]``."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        is_long = long_every and (i % long_every) == long_every - 1
        size = int(rng.integers(*(long_lengths if is_long else lengths)))
        mn = max_new if not max_new_spread else int(rng.integers(
            max(1, max_new - max_new_spread), max_new + max_new_spread + 1))
        reqs.append(Request(i, rng.integers(0, cfg.vocab, size=size)
                            .astype(np.int32), mn,
                            priority=priorities[i % len(priorities)]))
    return reqs


def parse_mesh_flag(spec: str, device="cpu"):
    """``--mesh data=1,model=8`` -> a host ('data', 'model') mesh.  Both
    axes must be named, and their product must equal the process group's
    rank count (launch the ranks with ``torchrun``)."""
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    import torch.distributed as dist

    shape: dict[str, int] = {}
    for part in spec.split(","):
        k, sep, v = part.partition("=")
        if not sep or not v.strip().isdigit():
            raise ValueError(f"--mesh expects axis=size pairs, got {part!r}")
        shape[k.strip()] = int(v)
    if sorted(shape) != ["data", "model"]:
        raise ValueError(f"--mesh must name exactly data= and model=, "
                         f"got {sorted(shape)}")
    init_distributed(device)
    n = dist.get_world_size()
    if shape["data"] * shape["model"] != n:
        raise ValueError(f"mesh {spec} wants {shape['data'] * shape['model']}"
                         f" ranks, the process group has {n}")
    return make_host_mesh(tp=shape["model"], device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=MODEL_IDS, default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="a reduced same-family config")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default the card; 'cpu' "
                         "runs the plain versions)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sequential", action="store_true",
                    help="one-request-at-a-time baseline (max_concurrency=1)")
    ap.add_argument("--paged", action="store_true",
                    help="page-table KV engine (DESIGN.md §12)")
    ap.add_argument("--page-size", type=int, default=8,
                    help="KV rows per page (paged engine)")
    ap.add_argument("--pages", type=int, default=None,
                    help="physical pool size in pages (default: dense-"
                         "equivalent capacity)")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="prompt tokens prefilled per engine step (paged)")
    ap.add_argument("--sanitize", action="store_true",
                    help="debug mode: assert the paged page-table/allocator "
                         "invariants after every engine tick "
                         "(repro_torch.analysis.kv_sanitizer)")
    ap.add_argument("--mesh", default=None, metavar="data=D,model=T",
                    help="serve tensor-parallel over a device mesh, e.g. "
                         "data=1,model=2 (its product must equal the "
                         "process group's rank count: launch with torchrun)")
    ap.add_argument("--long-every", type=int, default=0,
                    help="every k-th request gets a long prompt (mixed "
                         "traffic; 0 = homogeneous)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request relative deadline in seconds; "
                         "overdue requests expire gracefully")
    ap.add_argument("--stall-limit", type=int, default=256,
                    help="engine steps without progress before fail-stop")
    ap.add_argument("--inject", action="append", default=[],
                    metavar="SITE=RATE",
                    help="arm a fault-injection site at a seeded failure "
                         "rate (repeatable; DESIGN.md §14)")
    ap.add_argument("--inject-at", action="append", default=[],
                    metavar="SITE=I,J",
                    help="inject at exact call indices of a site "
                         "(repeatable)")
    ap.add_argument("--inject-seed", type=int, default=0,
                    help="seed for the fault-injection schedules")
    ap.add_argument("--tuning-db", default=None,
                    help="tuning database (tuner/db.py); defaults to "
                         "artifacts/torch_tuning_db.json")
    ap.add_argument("--tuned-app", default=None,
                    help="co-design app whose tuned kernel blocks to "
                         "install (default: the arch name)")
    ap.add_argument("--trace", action="store_true",
                    help="enable the observability layer (DESIGN.md §13) "
                         "and export telemetry + a Perfetto trace")
    ap.add_argument("--telemetry-out", default=None,
                    help="telemetry artifact path (default: "
                         "artifacts/telemetry.json)")
    ap.add_argument("--trace-out", default=None,
                    help="Chrome trace path (default: artifacts/trace.json)")
    args = ap.parse_args(argv)

    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: serve on the card, or pass "
                         "--device cpu")
    if args.trace:
        obs.enable()
    if args.inject or args.inject_at:
        rates = {}
        for spec in args.inject:
            site, _, rate = spec.partition("=")
            rates[site] = float(rate) if rate else 1.0
        at = {}
        for spec in args.inject_at:
            site, _, idxs = spec.partition("=")
            at[site] = [int(x) for x in idxs.split(",") if x]
        inject.arm(seed=args.inject_seed, rates=rates, at=at)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    # measured-autotuning pickup (DESIGN.md §8.4): install the app's tuned
    # block shapes as dispatch defaults; shape-exact DB records still win
    from repro_torch.kernels import ops
    tuned = ops.configure(app=args.tuned_app or args.arch,
                          db_path=args.tuning_db)
    if tuned:
        print(f"tuned kernel blocks installed: gemm={tuned['gemm']}")
    if cfg.embed_inputs:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode loop "
                         f"(DESIGN.md §5)")
    mesh = None
    if args.mesh:
        try:
            mesh = parse_mesh_flag(args.mesh, args.device)
        except ValueError as e:
            raise SystemExit(str(e))
    import torch.distributed as dist
    rank0 = mesh is None or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    if mesh is not None:
        from repro_torch.launch.mesh import describe
        say(f"mesh: {describe(mesh)}")
    tp = 1 if mesh is None else tp_size(mesh)
    mod = family_module(cfg)
    # every rank makes the same whole params from the seed, keeps its shard
    params = mod.init(cfg, seed=args.seed, tp=tp, device=args.device)
    requests = make_requests(cfg, args.requests, args.max_new, args.seed,
                             long_every=args.long_every)
    if args.deadline_s is not None:
        for req in requests:
            req.deadline_s = args.deadline_s

    impl = "cuda" if torch.device(args.device).type == "cuda" else "torch"
    t0 = time.time()
    done, stats = serve_requests(
        cfg, params, requests, slots=args.slots, max_seq=args.max_seq,
        tp=tp, mesh=mesh, impl=impl,
        max_concurrency=1 if args.sequential else None,
        paged=args.paged, page_size=args.page_size, n_pages=args.pages,
        prefill_chunk=args.prefill_chunk, stall_limit=args.stall_limit,
        sanitize=args.sanitize and args.paged)
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    for req in done:
        tail = "" if req.status == "OK" else f"  [{req.status}]"
        say(f"req {req.rid}: prompt[{len(req.prompt)}] -> "
              f"{req.out}{tail}")
    say(f"{len(done)} requests, {stats['generated']} tokens in "
          f"{stats['decode_steps']} decode steps "
          f"({stats['preemptions']} preemptions), "
          f"{stats['generated'] / dt:.1f} tok/s on {args.device}")
    say("status: " + ", ".join(f"{k}={v}" for k, v in
                                 stats["status_counts"].items()))
    plan = inject.plan()
    if plan is not None:
        say(f"fault injection: {plan.summary()}")
    ttft = stats["ttft_s"]
    if ttft["count"]:
        say(f"ttft p50={ttft['p50']:.4f}s p95={ttft['p95']:.4f}s "
              f"p99={ttft['p99']:.4f}s")
    if args.trace:
        tpath = obs.export_telemetry(args.telemetry_out)
        cpath = obs.export_chrome_trace(args.trace_out)
        st = obs.state()
        say(f"telemetry: {len(st.tracer)} events "
              f"({st.tracer.dropped} dropped), {len(st.metrics)} metrics "
              f"-> {tpath} + {cpath} (open in ui.perfetto.dev)")
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
