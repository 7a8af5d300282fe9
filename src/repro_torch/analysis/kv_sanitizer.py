"""Paged-KV aliasing sanitizer (DESIGN.md §16.5).

A checkable model of the invariants ``PagedServeEngine`` maintains between
its page table (``row_map``), per-slot page lists, and the
``PageAllocator`` free list (DESIGN.md §12):

  * page accounting closes: free-list ∪ slot-held = all pages, with no page
    simultaneously free and held, held by two slots, or held by nobody
    (leak);
  * no physical row is owned by two live slots, and every row a slot maps
    lies on a page that slot actually holds;
  * no negative-index wrap hazard: −1 is the only legal "unmapped" value
    (XLA's ``mode="drop"`` scatter drops indices ≥ size but *wraps*
    negatives — a known class of bug), and every row below a live slot's
    write position is mapped;
  * write positions stay within [0, max_seq] (max_seq is the idle
    sentinel).

Three entry points share the rules: :func:`check_paged_state` validates one
snapshot of engine state, :func:`check_engine` adapts a live
``PagedServeEngine`` (the engine's ``sanitize=True`` debug mode calls it
once per tick and raises :class:`PagedStateError` on errors), and
:class:`TraceChecker` replays a recorded alloc/map/release/suspend/resume
trace op by op, reporting the first op that broke the pool.

Pure numpy — no jax, importable anywhere.
"""
from __future__ import annotations

import numpy as np

from .findings import Finding, errors, rule

R_NEG_ROW = rule(
    "kv/negative-row",
    "row_map entry below −1: a negative physical row index wraps under the "
    "scatter's mode='drop' and corrupts the tail of the pool")
R_ROW_RANGE = rule(
    "kv/row-out-of-range",
    "row_map entry addresses a physical row beyond the pool")
R_ROW_DOUBLE = rule(
    "kv/row-double-owned",
    "the same physical row is mapped by two live logical rows: decode "
    "writes of one request would clobber another's KV")
R_ROW_UNMAPPED = rule(
    "kv/row-unmapped-live",
    "a live slot has an unmapped (−1) row below its write position: "
    "attention would read garbage for that position")
R_ROW_FOREIGN = rule(
    "kv/row-not-owned",
    "a slot maps a row on a page it does not hold")
R_PAGE_DOUBLE = rule(
    "kv/page-double-owned",
    "the same physical page appears in two slots' page lists (or twice in "
    "one)")
R_PAGE_FREE_HELD = rule(
    "kv/page-free-and-held",
    "a page is simultaneously on the allocator free list and held by a "
    "slot")
R_PAGE_LEAK = rule(
    "kv/page-leak",
    "a page is neither free nor held by any slot: the pool has leaked "
    "capacity (free ∪ mapped ≠ all pages)")
R_PAGE_FOREIGN = rule(
    "kv/page-foreign",
    "a slot holds a page the allocator does not consider allocated")
R_POS_RANGE = rule(
    "kv/pos-out-of-range",
    "slot write position outside [0, max_seq] (max_seq = idle sentinel)")


class PagedStateError(RuntimeError):
    """Raised by the engine's debug sanitizer; carries the findings."""

    def __init__(self, findings: list[Finding]):
        self.findings = findings
        lines = "\n  ".join(str(f) for f in findings)
        super().__init__(f"paged KV state is corrupt "
                         f"({len(findings)} finding(s)):\n  {lines}")


def check_paged_state(row_map, pos, pages, *, n_pages: int, page_size: int,
                      free_pages, held_pages, max_seq: int | None = None,
                      site: str = "paged") -> list[Finding]:
    """Validate one snapshot of paged-engine state.

    ``row_map`` is the (slots, max_seq) page table (−1 = unmapped), ``pos``
    the per-slot write positions, ``pages`` the per-slot page lists;
    ``free_pages``/``held_pages`` are the allocator's view of the pool.
    """
    rm = np.asarray(row_map)
    pos = np.asarray(pos)
    slots, width = rm.shape
    max_seq = width if max_seq is None else max_seq
    pool_rows = n_pages * page_size
    free = set(int(p) for p in free_pages)
    held = set(int(p) for p in held_pages)
    out: list[Finding] = []

    # -- page accounting -----------------------------------------------------
    owner: dict[int, int] = {}
    for s in range(slots):
        for p in pages[s]:
            p = int(p)
            if p in owner:
                out.append(Finding("error", R_PAGE_DOUBLE, f"{site}/page{p}",
                                   f"page {p} held by slot {owner[p]} and "
                                   f"slot {s}"))
            else:
                owner[p] = s
            if p in free:
                out.append(Finding("error", R_PAGE_FREE_HELD,
                                   f"{site}/page{p}",
                                   f"page {p} held by slot {s} but on the "
                                   f"free list"))
            if p not in held:
                out.append(Finding("error", R_PAGE_FOREIGN, f"{site}/page{p}",
                                   f"slot {s} holds page {p} the allocator "
                                   f"does not track as allocated"))
    for p in range(n_pages):
        if p not in free and p not in owner:
            out.append(Finding("error", R_PAGE_LEAK, f"{site}/page{p}",
                               f"page {p} is neither free nor held by any "
                               f"slot"))

    # -- row_map -------------------------------------------------------------
    row_owner: dict[int, tuple[int, int]] = {}
    for s in range(slots):
        p = int(pos[s])
        if p < 0 or p > max_seq:
            out.append(Finding("error", R_POS_RANGE, f"{site}/slot{s}",
                               f"pos={p} outside [0, {max_seq}]"))
            p = min(max(p, 0), max_seq)
        live = p < max_seq
        for i in range(width):
            r = int(rm[s, i])
            if r == -1:
                if live and i < p:
                    out.append(Finding(
                        "error", R_ROW_UNMAPPED, f"{site}/slot{s}/row{i}",
                        f"row {i} unmapped below write position {p}"))
                continue
            if r < -1:
                out.append(Finding(
                    "error", R_NEG_ROW, f"{site}/slot{s}/row{i}",
                    f"physical row {r} < −1 wraps under mode='drop'"))
                continue
            if r >= pool_rows:
                out.append(Finding(
                    "error", R_ROW_RANGE, f"{site}/slot{s}/row{i}",
                    f"physical row {r} >= pool of {pool_rows} rows"))
                continue
            if r in row_owner:
                os_, oi = row_owner[r]
                out.append(Finding(
                    "error", R_ROW_DOUBLE, f"{site}/slot{s}/row{i}",
                    f"physical row {r} also mapped by slot {os_} row {oi}"))
            else:
                row_owner[r] = (s, i)
            if owner.get(r // page_size) != s:
                out.append(Finding(
                    "error", R_ROW_FOREIGN, f"{site}/slot{s}/row{i}",
                    f"physical row {r} lies on page {r // page_size}, "
                    f"which slot {s} does not hold"))
    return out


def check_engine(engine, *, site: str = "engine") -> list[Finding]:
    """Snapshot-check a live ``PagedServeEngine`` (duck-typed: row_map,
    pos, _pages, alloc, max_seq)."""
    alloc = engine.alloc
    return check_paged_state(
        engine.row_map, engine.pos, engine._pages,
        n_pages=alloc.n_pages, page_size=alloc.page_size,
        free_pages=alloc.free_pages, held_pages=alloc._held,
        max_seq=engine.max_seq, site=site)


def assert_engine(engine, *, site: str = "engine") -> None:
    """Raise :class:`PagedStateError` if the engine's paged state has any
    error-severity finding (the per-tick debug assertion)."""
    bad = errors(check_engine(engine, site=site))
    if bad:
        raise PagedStateError(bad)


class TraceChecker:
    """Standalone trace checker: replay page-pool operations against a
    model of the invariants and report the first op that breaks them.

    Ops (dicts, ``op`` key dispatches):

      {"op": "alloc",   "slot": s, "pages": [..]}   pages granted to a slot
      {"op": "map",     "slot": s, "rows": n}       map the slot's first n
                                                    logical rows page-major
      {"op": "release", "slot": s}                  free the slot's pages
      {"op": "suspend", "slot": s}                  swap out: pages freed,
                                                    rows parked off-pool
      {"op": "resume",  "slot": s, "pages": [..]}   swap in on fresh pages

    :meth:`check_trace` returns the findings (each tagged with the op
    index); a clean trace returns [].
    """

    def __init__(self, n_pages: int, page_size: int, slots: int,
                 max_seq: int):
        self.n_pages, self.page_size = n_pages, page_size
        self.slots, self.max_seq = slots, max_seq
        self._free = set(range(n_pages))
        self._pages: list[list[int]] = [[] for _ in range(slots)]
        self.row_map = np.full((slots, max_seq), -1, np.int32)
        self.pos = np.full(slots, max_seq, np.int64)

    def _held(self) -> set[int]:
        return {p for ps in self._pages for p in ps}

    def _snapshot(self, site: str) -> list[Finding]:
        return check_paged_state(
            self.row_map, self.pos, self._pages,
            n_pages=self.n_pages, page_size=self.page_size,
            free_pages=self._free, held_pages=self._held(),
            max_seq=self.max_seq, site=site)

    def apply(self, op: dict, site: str = "trace") -> list[Finding]:
        """Apply one op, then re-check the whole state."""
        kind = op["op"]
        s = int(op.get("slot", 0))
        if kind in ("alloc", "resume"):
            pages = [int(p) for p in op["pages"]]
            self._free.difference_update(pages)
            self._pages[s].extend(pages)
            if kind == "resume":
                self._map(s, int(op.get("rows", self._capacity(s))))
        elif kind == "map":
            self._map(s, int(op["rows"]))
        elif kind in ("release", "suspend"):
            self._free.update(self._pages[s])
            self._pages[s] = []
            self.row_map[s, :] = -1
            self.pos[s] = self.max_seq
        else:
            raise ValueError(f"unknown trace op {kind!r}")
        return self._snapshot(site)

    def _capacity(self, s: int) -> int:
        return min(len(self._pages[s]) * self.page_size, self.max_seq)

    def _map(self, s: int, rows: int) -> None:
        rows = min(rows, self._capacity(s))
        ps = self.page_size
        flat = [p * ps + i for p in self._pages[s] for i in range(ps)]
        self.row_map[s, :rows] = np.asarray(flat[:rows], np.int32)
        self.pos[s] = rows

    def check_trace(self, ops: list[dict]) -> list[Finding]:
        out: list[Finding] = []
        for i, op in enumerate(ops):
            out.extend(self.apply(op, site=f"trace[{i}]:{op['op']}"))
            if errors(out):
                break   # state is corrupt; later findings would be noise
        return out
