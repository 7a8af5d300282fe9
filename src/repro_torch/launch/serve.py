"""Continuous-batching serving engine (DESIGN.md §11), in PyTorch.

Port of the dense engine of ``repro/launch/serve.py``.  Requests arrive
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

Not ported yet (ROADMAP A.5): the paged engine (``--paged``), the KV
sanitizer (``--sanitize``) and tensor-parallel serving (``--mesh``); each
raises rather than being ignored.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      --smoke --device cpu
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.ft import ProgressWatchdog, inject
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import family_module, reduced

#: Terminal request statuses (DESIGN.md §14).  Every submitted request ends
#: in exactly one of these; ``PENDING`` is the only non-terminal state.
TERMINAL_STATUSES = ("OK", "CANCELLED", "EXPIRED", "REJECTED", "FAILED")

# flags of the reference's CLI whose code is not ported yet: they raise
_DEFERRED_FLAGS = {
    "paged": "the paged engine is not ported yet (ROADMAP A.5)",
    "sanitize": "the KV sanitizer is not ported yet (ROADMAP A.5)",
    "mesh": "tensor-parallel serving is not ported yet (ROADMAP A.8)",
}


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


def _obs_admit(req: Request, slot: int) -> None:
    req.admit_time = time.time()
    st = obs.state()
    if st is not None:
        st.tracer.instant("req.admit", {"rid": req.rid, "slot": slot})
        if req.submit_time is not None:
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


def _write_slot(cache, slot_cache, slot: int, axes) -> None:
    """Copy a batch-1 packed prefill cache into slot ``slot`` of the shared
    cache, in place (it replaces the slot's whole slice)."""
    for name, c in cache.items():
        if isinstance(c, dict):
            _write_slot(c, slot_cache[name], slot, axes[name])
        else:
            c.select(axes[name], slot).copy_(
                slot_cache[name].select(axes[name], 0))


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
        if mesh is not None:
            raise NotImplementedError("tensor-parallel serving is not ported "
                                      "yet (ROADMAP A.8)")
        self.cfg, self.params = cfg, params
        self.mod = family_module(cfg)
        self.device = params["embed"]["table"].device
        self.n_slots, self.max_seq = slots, max_seq
        self.scheduler = FCFSScheduler(slots, max_concurrency)
        self._decode = make_decode_step(cfg, tp=tp, impl=impl)
        self._prefill = make_prefill_step(cfg, tp=tp, impl=impl,
                                          cache_len=max_seq)
        self._axes = self.mod.cache_slot_axes(cfg)
        self.cache = self.mod.init_cache(cfg, slots, max_seq, tp,
                                         device=self.device)
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
                   stall_limit: int = 256, mesh=None
                   ) -> tuple[list[Request], dict]:
    """Submit ``requests`` to a :class:`ServeEngine`, drain it, return
    ``(requests, stats)``: every submitted request comes back with a
    terminal ``status``, counted once in ``stats["status_counts"]``.
    ``max_concurrency=1`` is the sequential one-request-at-a-time baseline
    (identical math and shapes, no batching across requests)."""
    if paged:
        raise NotImplementedError(_DEFERRED_FLAGS["paged"])
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-8b")
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
                    help=_DEFERRED_FLAGS["paged"])
    ap.add_argument("--sanitize", action="store_true",
                    help=_DEFERRED_FLAGS["sanitize"])
    ap.add_argument("--mesh", default=None, metavar="data=D,model=T",
                    help=_DEFERRED_FLAGS["mesh"])
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
    ap.add_argument("--trace", action="store_true",
                    help="enable the observability layer (DESIGN.md §13) "
                         "and export telemetry + a Perfetto trace")
    ap.add_argument("--telemetry-out", default=None,
                    help="telemetry artifact path (default: "
                         "artifacts/telemetry.json)")
    ap.add_argument("--trace-out", default=None,
                    help="Chrome trace path (default: artifacts/trace.json)")
    args = ap.parse_args(argv)

    for flag, why in _DEFERRED_FLAGS.items():
        if getattr(args, flag):
            raise SystemExit(f"--{flag}: {why}")
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
    if cfg.embed_inputs:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode loop "
                         f"(DESIGN.md §5)")
    mod = family_module(cfg)
    params = mod.init(cfg, seed=args.seed, device=args.device)
    requests = make_requests(cfg, args.requests, args.max_new, args.seed,
                             long_every=args.long_every)
    if args.deadline_s is not None:
        for req in requests:
            req.deadline_s = args.deadline_s

    impl = "cuda" if torch.device(args.device).type == "cuda" else "torch"
    t0 = time.time()
    done, stats = serve_requests(
        cfg, params, requests, slots=args.slots, max_seq=args.max_seq,
        impl=impl, max_concurrency=1 if args.sequential else None,
        stall_limit=args.stall_limit)
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    for req in done:
        tail = "" if req.status == "OK" else f"  [{req.status}]"
        print(f"req {req.rid}: prompt[{len(req.prompt)}] -> "
              f"{req.out}{tail}")
    print(f"{len(done)} requests, {stats['generated']} tokens in "
          f"{stats['decode_steps']} decode steps, "
          f"{stats['generated'] / dt:.1f} tok/s on {args.device}")
    print("status: " + ", ".join(f"{k}={v}" for k, v in
                                 stats["status_counts"].items()))
    plan = inject.plan()
    if plan is not None:
        print(f"fault injection: {plan.summary()}")
    ttft = stats["ttft_s"]
    if ttft["count"]:
        print(f"ttft p50={ttft['p50']:.4f}s p95={ttft['p95']:.4f}s "
              f"p99={ttft['p99']:.4f}s")
    if args.trace:
        tpath = obs.export_telemetry(args.telemetry_out)
        cpath = obs.export_chrome_trace(args.trace_out)
        st = obs.state()
        print(f"telemetry: {len(st.tracer)} events "
              f"({st.tracer.dropped} dropped), {len(st.metrics)} metrics "
              f"-> {tpath} + {cpath} (open in ui.perfetto.dev)")


if __name__ == "__main__":
    main()
