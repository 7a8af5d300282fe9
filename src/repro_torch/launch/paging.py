"""Host-side KV paging + scheduling policy (DESIGN.md §12).

Two model-free pieces the paged serving engine composes:

  * :class:`PageAllocator` — owns the physical page pool's free list.  Pages
    are fixed-size groups of KV rows; the engine maps a slot's *logical*
    rows onto its pages through a per-slot page table (``row_map``), so long
    and short requests share one pool instead of each pinning a full
    ``max_seq`` slice.
  * :class:`PriorityScheduler` — priority-class admission (lower value =
    more urgent), FIFO within a class, aging so sustained high-priority load
    cannot starve low priority, and preemption bookkeeping: a preempted
    request re-enters its class queue at its original submit position.

Both are pure bookkeeping (no jax, no model) and unit-testable in
isolation; ``tests/test_paged_kv.py`` holds the property tests.
"""
from __future__ import annotations

import collections
import itertools
from typing import TYPE_CHECKING

from repro_torch import obs
from repro_torch.ft import inject

if TYPE_CHECKING:  # pragma: no cover - type-only import
    from repro_torch.launch.serve import Request


class PageAllocator:
    """Free-list allocator over ``n_pages`` fixed-size KV pages.

    Lowest-numbered free pages are handed out first, so allocation order is
    deterministic (same request stream -> same physical layout -> the
    bit-exactness gates stay meaningful).  Double-allocation and foreign /
    double frees raise rather than corrupt the pool.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError("need n_pages >= 1 and page_size >= 1")
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: list[int] = list(range(n_pages))   # ascending
        self._held: set[int] = set()

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def free_pages(self) -> tuple[int, ...]:
        return tuple(self._free)

    def pages_for(self, rows: int) -> int:
        """Pages needed to hold ``rows`` KV rows."""
        return -(-max(0, rows) // self.page_size)

    def alloc(self, n: int) -> list[int]:
        if n < 0:
            raise ValueError("cannot allocate a negative page count")
        # fault-injection site (DESIGN.md §14): fires BEFORE any free-list
        # mutation, so an injected MemoryError is indistinguishable from a
        # genuine exhaustion and leaves the pool consistent
        inject.check("page.alloc", MemoryError)
        if n > len(self._free):
            raise MemoryError(
                f"allocation of {n} pages exceeds {len(self._free)} free")
        pages, self._free = self._free[:n], self._free[n:]
        self._held.update(pages)
        st = obs.state()
        if st is not None:
            st.metrics.counter("pages.alloc").inc(n)
            st.metrics.gauge("pages.free").set(len(self._free))
        return pages

    def free(self, pages: list[int]) -> None:
        for p in pages:
            if p not in self._held:
                raise ValueError(f"page {p} is not currently allocated")
            self._held.discard(p)
        self._free = sorted(self._free + list(pages))
        st = obs.state()
        if st is not None:
            st.metrics.counter("pages.freed").inc(len(pages))
            st.metrics.gauge("pages.free").set(len(self._free))

    def rows(self, pages: list[int], n_rows: int) -> list[int]:
        """Physical row index for each of the first ``n_rows`` logical rows
        stored on ``pages`` (page-major, ``page * page_size + offset``)."""
        ps = self.page_size
        out = [p * ps + i for p in pages for i in range(ps)]
        if n_rows > len(out):
            raise ValueError(f"{n_rows} rows exceed {len(pages)} pages")
        return out[:n_rows]


class PriorityScheduler:
    """Priority-class slot scheduler with aging and preemption requeue.

    ``priority`` is a small non-negative int, 0 = most urgent.  Admission
    order is (effective priority, submit order): FIFO within a class, and a
    waiting request's effective priority improves by one class every
    ``age_steps`` scheduler ticks — ties break on submit order, so an aged
    low-priority request eventually outranks freshly submitted high-priority
    traffic (the no-starvation guarantee).

    The scheduler only does bookkeeping; *page* admission control and victim
    selection policy live in the engine, which asks :meth:`least_deserving`
    for the preemption candidate.
    """

    def __init__(self, n_slots: int, max_concurrency: int | None = None,
                 age_steps: int = 32):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = n_slots
        self.max_concurrency = min(max_concurrency or n_slots, n_slots)
        self.age_steps = age_steps
        self.now = 0
        self.queues: dict[int, collections.deque[Request]] = {}
        self.slots: list[Request | None] = [None] * n_slots
        self._seq = itertools.count()
        self._admit_seq = itertools.count()
        self._enqueued_at: dict[int, int] = {}       # rid -> tick
        self._admitted: dict[int, int] = {}          # slot -> admit seq

    # -- state ------------------------------------------------------------

    @property
    def active(self) -> dict[int, "Request"]:
        return {s: r for s, r in enumerate(self.slots) if r is not None}

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.slots)

    @property
    def n_waiting(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def has_work(self) -> bool:
        return self.n_waiting > 0 or self.n_active > 0

    def tick(self) -> None:
        self.now += 1

    def effective_priority(self, req: "Request") -> int:
        """Class after aging: one class better per ``age_steps`` ticks
        waited (0 disables aging)."""
        if not self.age_steps:
            return req.priority
        waited = self.now - self._enqueued_at.get(req.rid, self.now)
        return max(0, req.priority - waited // self.age_steps)

    # -- queue ------------------------------------------------------------

    def submit(self, req: "Request") -> None:
        req.submit_seq = next(self._seq)
        self._enqueue(req)

    def _enqueue(self, req: "Request") -> None:
        self._enqueued_at.setdefault(req.rid, self.now)
        q = self.queues.setdefault(req.priority, collections.deque())
        # keep each class queue sorted by submit order; a preempted request
        # (older seq than anything still waiting) lands back at the front
        i = len(q)
        while i > 0 and q[i - 1].submit_seq > req.submit_seq:
            i -= 1
        q.insert(i, req)

    def peek(self) -> "Request | None":
        """Best waiting request: lowest (effective priority, submit order)."""
        heads = [q[0] for q in self.queues.values() if q]
        if not heads:
            return None
        return min(heads, key=lambda r: (self.effective_priority(r),
                                         r.submit_seq))

    def waiting(self) -> list["Request"]:
        """Every waiting request, across all class queues (queue order
        within a class; no cross-class ordering implied)."""
        return [r for q in self.queues.values() for r in q]

    def remove(self, req: "Request") -> bool:
        """Pull a waiting request out of its class queue (cancellation /
        deadline expiry); False if it was not waiting."""
        q = self.queues.get(req.priority)
        if q is not None and req in q:
            q.remove(req)
            return True
        return False

    # -- slots ------------------------------------------------------------

    def free_slot(self) -> int | None:
        if self.n_active >= self.max_concurrency:
            return None
        for slot, r in enumerate(self.slots):
            if r is None:
                return slot
        return None

    def place(self, req: "Request") -> int:
        """Move ``req`` from its queue into the lowest free slot."""
        slot = self.free_slot()
        if slot is None:
            raise ValueError("no free slot")
        q = self.queues.get(req.priority)
        if not q or req not in q:
            raise ValueError(f"request {req.rid} is not waiting")
        st = obs.state()
        if st is not None and self.effective_priority(req) < req.priority:
            # the no-starvation mechanism actually fired: this placement
            # was earned through aging, not nominal class
            st.metrics.counter("sched.aged_admits").inc()
        q.remove(req)
        # _enqueued_at is deliberately KEPT: the aging clock runs from first
        # submission across preemptions, so an aged-in low-priority request
        # keeps its earned effective priority and cannot be re-starved by a
        # preempt/requeue cycle.
        self.slots[slot] = req
        self._admitted[slot] = next(self._admit_seq)
        return slot

    def retire(self, slot: int) -> "Request":
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} is not occupied")
        self.slots[slot] = None
        self._admitted.pop(slot, None)
        return req

    def preempt(self, slot: int) -> "Request":
        """Evict the request in ``slot`` back into its class queue (at its
        original submit position, so intra-class FIFO order is preserved)."""
        req = self.retire(slot)
        req.preemptions += 1
        self._enqueue(req)
        return req

    def least_deserving(self, than: tuple[int, int] | None = None
                        ) -> int | None:
        """Slot of the least-deserving active request — highest *effective*
        priority value, most recently admitted on ties.  With ``than`` =
        (priority, admit_seq), only a strictly less deserving victim is
        returned."""
        cands = [(self.effective_priority(r), self._admitted[s], s)
                 for s, r in self.active.items()]
        if not cands:
            return None
        prio, seq, slot = max(cands)
        if than is not None and (prio, seq) <= than:
            return None
        return slot

    def admit_key(self, slot: int) -> tuple[int, int]:
        """(effective priority, admit order) deservingness key for the slot
        holder — effective, not nominal, so an aged-in low-priority request
        is as preemption-proof as the class it aged into."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} is not occupied")
        return (self.effective_priority(req), self._admitted[slot])
