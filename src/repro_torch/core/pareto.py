"""Pareto sets, hypervolume, and the vectorized acquisition engine
(paper §V-B, §VII-C; DESIGN.md §9).

All objectives are *minimized*.  Hypervolume is measured against a reference
point that every point must dominate; exact algorithms for 2-D and 3-D (the
paper's latency/power/area case), Monte-Carlo fallback for higher dims.

Three layers:

  * scalar primitives — ``dominates``, ``pareto_mask``/``pareto_front``
    (vectorized dominance matrix), ``hypervolume`` (vectorized exact 2-D/3-D,
    MC beyond).
  * :class:`BoxDecomposition` — a partition of the region *not dominated* by
    a front (below the reference) into axis-aligned boxes, built once per
    front; ``hvi(cands)`` then scores the exclusive hypervolume contribution
    of M candidates in one array pass.  ``hvi_batch`` is the one-shot
    convenience wrapper.
  * :class:`IncrementalHV` — maintains a non-dominated front and its
    hypervolume as observations arrive, so per-trial hypervolume histories
    cost one box-decomposition query instead of a from-scratch recompute.

The pre-engine scalar implementations are kept verbatim as
``_reference_pareto_mask`` / ``_reference_hypervolume``: the property tests
and ``benchmarks/bench_acquisition.py`` assert the vectorized engine matches
them (masks exactly, hypervolume within 1e-9).
"""
from __future__ import annotations

import numpy as np

_INF = float("inf")


def dominates(a: np.ndarray, b: np.ndarray) -> bool:
    """a dominates b (minimization): a <= b everywhere, < somewhere."""
    return bool(np.all(a <= b) and np.any(a < b))


# ---------------------------------------------------------------------------
# Reference (pre-engine) implementations — parity targets, never hot-path.
# ---------------------------------------------------------------------------

def _reference_pareto_mask(points: np.ndarray) -> np.ndarray:
    """O(n^2) Python-loop non-dominated mask (the pre-engine implementation)."""
    pts = np.asarray(points, dtype=float)
    n = len(pts)
    mask = np.ones(n, dtype=bool)
    for i in range(n):
        if not mask[i]:
            continue
        dominated = np.all(pts <= pts[i], axis=1) & np.any(pts < pts[i], axis=1)
        if dominated.any():
            mask[i] = False
        else:
            # i dominates others -> knock them out early
            kills = np.all(pts[i] <= pts, axis=1) & np.any(pts[i] < pts, axis=1)
            mask &= ~kills
            mask[i] = True
    return mask


def _hv2d(front: np.ndarray, ref: np.ndarray) -> float:
    """Exact 2-D hypervolume of a non-dominated front (scalar sweep)."""
    pts = front[np.argsort(front[:, 0])]
    hv, prev_y = 0.0, ref[1]
    for x, y in pts:
        if y < prev_y:
            hv += (ref[0] - x) * (prev_y - y)
            prev_y = y
    return hv


def _hv3d(front: np.ndarray, ref: np.ndarray) -> float:
    """Exact 3-D hypervolume by sweeping the third axis (scalar slabs)."""
    pts = front[np.argsort(front[:, 2])]
    zs = np.concatenate([pts[:, 2], [ref[2]]])
    hv = 0.0
    for i in range(len(pts)):
        dz = zs[i + 1] - zs[i]
        if dz <= 0:
            continue
        # points active in this slab: z <= zs[i]
        active = pts[pts[:, 2] <= zs[i]][:, :2]
        if len(active):
            fr = active[_reference_pareto_mask(active)]
            hv += _hv2d(fr, ref[:2]) * dz
    return hv


def _reference_hypervolume(points: np.ndarray, ref: np.ndarray,
                           mc_samples: int = 200_000, seed: int = 0) -> float:
    """Hypervolume via the pre-engine scalar code paths."""
    pts = np.asarray(points, dtype=float)
    ref = np.asarray(ref, dtype=float)
    if pts.ndim != 2 or len(pts) == 0:
        return 0.0
    keep = np.all(pts < ref, axis=1)
    pts = pts[keep]
    if len(pts) == 0:
        return 0.0
    front = pts[_reference_pareto_mask(pts)]
    d = front.shape[1]
    if d == 1:
        return float(ref[0] - front.min())
    if d == 2:
        return _hv2d(front, ref)
    if d == 3:
        return _hv3d(front, ref)
    # Monte-Carlo fallback (deterministic seed)
    rng = np.random.default_rng(seed)
    lo = front.min(axis=0)
    samples = rng.uniform(lo, ref, size=(mc_samples, d))
    dominated = np.zeros(mc_samples, dtype=bool)
    for p in front:
        dominated |= np.all(samples >= p, axis=1)
    box = float(np.prod(ref - lo))
    return box * dominated.mean()


# ---------------------------------------------------------------------------
# Vectorized engine
# ---------------------------------------------------------------------------

def pareto_mask(points: np.ndarray) -> np.ndarray:
    """Boolean mask of non-dominated rows (vectorized dominance matrix).

    ``dom[i, j]`` is "row i dominates row j"; a row survives iff no other row
    dominates it.  Column-chunked so huge populations stay within a bounded
    temporary footprint.
    """
    pts = np.asarray(points, dtype=float)
    n = len(pts)
    if n == 0:
        return np.zeros(0, dtype=bool)
    d = pts.shape[1]
    mask = np.empty(n, dtype=bool)
    step = max(1, (1 << 22) // max(1, n * d))
    for j0 in range(0, n, step):
        blk = pts[j0:j0 + step]
        le = np.all(pts[:, None, :] <= blk[None, :, :], axis=-1)
        lt = np.any(pts[:, None, :] < blk[None, :, :], axis=-1)
        mask[j0:j0 + step] = ~np.any(le & lt, axis=0)
    return mask


def pareto_front(points: np.ndarray) -> np.ndarray:
    pts = np.asarray(points, dtype=float)
    return pts[pareto_mask(pts)]


def _hv2d_vec(pts: np.ndarray, ref: np.ndarray) -> float:
    """Exact 2-D hypervolume, vectorized staircase (any point set)."""
    if len(pts) == 0:
        return 0.0
    order = np.argsort(pts[:, 0], kind="stable")
    stair = np.minimum.accumulate(pts[order, 1])
    prev = np.concatenate([[ref[1]], stair[:-1]])
    return float(np.sum((ref[0] - pts[order, 0])
                        * np.clip(prev - stair, 0.0, None)))


def _hv3d_vec(front: np.ndarray, ref: np.ndarray) -> float:
    """Exact 3-D hypervolume: z-slab sweep with a vectorized 2-D staircase."""
    pts = front[np.argsort(front[:, 2], kind="stable")]
    zs = np.concatenate([pts[:, 2], [ref[2]]])
    hv = 0.0
    for i in range(len(pts)):
        dz = zs[i + 1] - zs[i]
        if dz <= 0:
            continue
        hv += _hv2d_vec(pts[: i + 1, :2], ref[:2]) * dz
    return hv


def hypervolume(points: np.ndarray, ref: np.ndarray, mc_samples: int = 200_000,
                seed: int = 0) -> float:
    """Hypervolume of the Pareto front of ``points`` w.r.t. ``ref``."""
    pts = np.asarray(points, dtype=float)
    ref = np.asarray(ref, dtype=float)
    if pts.ndim != 2 or len(pts) == 0:
        return 0.0
    # clip points that exceed the reference (contribute nothing)
    keep = np.all(pts < ref, axis=1)
    pts = pts[keep]
    if len(pts) == 0:
        return 0.0
    front = pts[pareto_mask(pts)]
    d = front.shape[1]
    if d == 1:
        return float(ref[0] - front.min())
    if d == 2:
        return _hv2d_vec(front, ref)
    if d == 3:
        return _hv3d_vec(front, ref)
    # Monte-Carlo fallback (deterministic seed; identical sampling to the
    # reference implementation, so d>3 estimates match it bit-for-bit)
    rng = np.random.default_rng(seed)
    lo = front.min(axis=0)
    samples = rng.uniform(lo, ref, size=(mc_samples, d))
    dominated = np.zeros(mc_samples, dtype=bool)
    for p in front:
        dominated |= np.all(samples >= p, axis=1)
    box = float(np.prod(ref - lo))
    return box * dominated.mean()


def _reduce_front(points: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Distinct non-dominated rows strictly below ``ref`` in every dim."""
    pts = np.asarray(points, dtype=float).reshape(-1, len(ref))
    if len(pts):
        pts = pts[np.all(np.isfinite(pts), axis=1) & np.all(pts < ref, axis=1)]
    if len(pts):
        pts = np.unique(pts, axis=0)
        pts = pts[pareto_mask(pts)]
    return pts


def _staircase_boxes(front2: np.ndarray, ref2: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
    """2-D columns partitioning the region not dominated by ``front2`` below
    ``ref2``.  Returns (lo, hi) of shape (T, 2); lower corners are -inf."""
    f = _reduce_front(front2, ref2)
    if len(f) == 0:
        return (np.array([[-_INF, -_INF]]), np.array([list(ref2)], dtype=float))
    f = f[np.argsort(f[:, 0], kind="stable")]   # x asc => y strictly desc
    xs, ys = f[:, 0], f[:, 1]
    lx = np.concatenate([[-_INF], xs])
    rx = np.concatenate([xs, [ref2[0]]])
    v = np.concatenate([[ref2[1]], ys])
    lo = np.stack([lx, np.full(len(v), -_INF)], axis=1)
    hi = np.stack([rx, v], axis=1)
    return lo[rx > lx], hi[rx > lx]


def _boxes_of(front: np.ndarray, ref: np.ndarray
              ) -> tuple[np.ndarray, np.ndarray]:
    """Box partition of the non-dominated region below ``ref`` (d <= 3)."""
    d = len(ref)
    if d == 1:
        hi = ref[0] if len(front) == 0 else float(front.min())
        return np.array([[-_INF]]), np.array([[hi]])
    if d == 2:
        return _staircase_boxes(front, ref)
    # d == 3: staircase columns per z-slab
    los, his = [], []
    zs = np.unique(front[:, 2]) if len(front) else np.empty(0)
    zb = np.concatenate([[-_INF], zs, [ref[2]]])
    for s in range(len(zb) - 1):
        z0, z1 = zb[s], zb[s + 1]
        if z1 <= z0:
            continue
        active = front[front[:, 2] <= z0][:, :2] if len(front) else front
        lo2, hi2 = _staircase_boxes(active, ref[:2])
        los.append(np.column_stack([lo2, np.full(len(lo2), z0)]))
        his.append(np.column_stack([hi2, np.full(len(hi2), z1)]))
    return np.concatenate(los), np.concatenate(his)


class BoxDecomposition:
    """Box partition of the region *not dominated* by ``front`` below ``ref``.

    Built once per front (the per-trial precompute of the acquisition
    engine); :meth:`hvi` then scores the exclusive hypervolume contribution
    of M candidate points in one vectorized pass: each candidate's
    contribution is the sum over boxes of ``vol([cand, ref] ∩ box)``.

    Exact for d <= 3 (2-D staircase columns, 3-D staircase × z-slabs);
    Monte-Carlo for d > 3 with a deterministic seed (samples are drawn per
    :meth:`hvi` call so the sampling box can cover the candidates).
    """

    def __init__(self, front: np.ndarray, ref: np.ndarray, *,
                 mc_samples: int = 50_000, seed: int = 0):
        self.ref = np.asarray(ref, dtype=float).reshape(-1)
        self.d = len(self.ref)
        self.front = _reduce_front(front, self.ref)
        self.mc_samples = int(mc_samples)
        self.seed = int(seed)
        if self.d <= 3:
            self._lo, self._hi = _boxes_of(self.front, self.ref)

    @property
    def n_boxes(self) -> int:
        return len(self._lo) if self.d <= 3 else 0

    def hvi(self, cands: np.ndarray, chunk: int = 1 << 22) -> np.ndarray:
        """Exclusive hypervolume contribution of each candidate row, i.e.
        ``hypervolume(front ∪ {c}) - hypervolume(front)``, shape (M,)."""
        C = np.asarray(cands, dtype=float).reshape(-1, self.d)
        # non-finite candidates (failed/imputed draws) contribute nothing
        C = np.where(np.isfinite(C), C, _INF)
        if self.d > 3:
            return self._hvi_mc(C)
        lo, hi = self._lo, self._hi
        out = np.empty(len(C))
        step = max(1, chunk // max(1, len(lo) * self.d))
        for i0 in range(0, len(C), step):
            blk = C[i0:i0 + step]
            w = hi[None, :, :] - np.maximum(lo[None, :, :], blk[:, None, :])
            out[i0:i0 + step] = np.clip(w, 0.0, None).prod(axis=-1).sum(axis=-1)
        return out

    def _hvi_mc(self, C: np.ndarray) -> np.ndarray:
        fin = np.all(np.isfinite(C), axis=1)
        if not fin.any():
            return np.zeros(len(C))
        lo = C[fin].min(axis=0)
        if len(self.front):
            lo = np.minimum(lo, self.front.min(axis=0))
        rng = np.random.default_rng(self.seed)
        samples = rng.uniform(lo, self.ref, size=(self.mc_samples, self.d))
        front_dom = np.zeros(self.mc_samples, dtype=bool)
        for p in self.front:
            front_dom |= np.all(samples >= p, axis=1)
        free = ~front_dom
        box = float(np.prod(self.ref - lo))
        out = np.zeros(len(C))
        step = max(1, (1 << 24) // max(1, self.mc_samples))
        idx = np.flatnonzero(fin)
        for i0 in range(0, len(idx), step):
            blk = idx[i0:i0 + step]
            newly = np.all(samples[None, :, :] >= C[blk, None, :], axis=-1)
            out[blk] = box * (newly & free[None, :]).mean(axis=1)
        return out


def hvi_batch(front: np.ndarray, ref: np.ndarray, cands: np.ndarray, *,
              mc_samples: int = 50_000, seed: int = 0) -> np.ndarray:
    """One-shot batched hypervolume improvement: decompose once, score M
    candidates in one pass.  Callers scoring several batches against the same
    front should hold a :class:`BoxDecomposition` (or :class:`IncrementalHV`)
    instead of re-decomposing per batch."""
    return BoxDecomposition(front, ref, mc_samples=mc_samples,
                            seed=seed).hvi(cands)


class IncrementalHV:
    """Non-dominated front + hypervolume maintained incrementally.

    ``add(y)`` folds one observation in: its hypervolume gain is scored
    against the current front's box decomposition (exact for d <= 3) and the
    front is updated in place, so a T-trial hypervolume history costs T
    decomposition queries instead of T from-scratch recomputes.  For d > 3
    the tracker recomputes the MC estimate on the (small) current front so
    histories match ``hypervolume`` exactly rather than accumulating MC
    noise.
    """

    def __init__(self, ref: np.ndarray, *, mc_samples: int = 200_000,
                 seed: int = 0):
        self.ref = np.asarray(ref, dtype=float).reshape(-1)
        self.d = len(self.ref)
        self.mc_samples = int(mc_samples)
        self.seed = int(seed)
        self.front = np.empty((0, self.d))
        self._hv = 0.0
        self._decomp: BoxDecomposition | None = None

    @property
    def hv(self) -> float:
        return self._hv

    @property
    def decomposition(self) -> BoxDecomposition:
        if self._decomp is None:
            self._decomp = BoxDecomposition(self.front, self.ref,
                                            mc_samples=self.mc_samples,
                                            seed=self.seed)
        return self._decomp

    def copy(self) -> "IncrementalHV":
        out = IncrementalHV(self.ref, mc_samples=self.mc_samples,
                            seed=self.seed)
        out.front = self.front.copy()
        out._hv = self._hv
        out._decomp = self._decomp   # immutable once built; add() re-derives
        return out

    def add(self, y: np.ndarray) -> float:
        """Fold one observation in; returns the updated hypervolume."""
        y = np.asarray(y, dtype=float).reshape(-1)
        if not (np.all(np.isfinite(y)) and np.all(y < self.ref)):
            return self._hv          # contributes nothing, front unchanged
        if len(self.front):
            dominated = np.any(np.all(self.front <= y, axis=1)
                               & np.any(self.front < y, axis=1))
            if dominated or np.any(np.all(self.front == y, axis=1)):
                return self._hv      # gain is exactly zero
        if self.d <= 3:
            self._hv += float(self.decomposition.hvi(y[None])[0])
        if len(self.front):
            keep = ~(np.all(y <= self.front, axis=1)
                     & np.any(y < self.front, axis=1))
            self.front = np.vstack([self.front[keep], y[None]])
        else:
            self.front = y[None].copy()
        self._decomp = None
        if self.d > 3:
            self._hv = hypervolume(self.front, self.ref, self.mc_samples,
                                   self.seed)
        return self._hv


def default_reference(points: np.ndarray, margin: float = 1.1) -> np.ndarray:
    """A reference point slightly beyond the observed worst per objective."""
    pts = np.asarray(points, dtype=float)
    worst = pts.max(axis=0)
    best = pts.min(axis=0)
    span = np.where(worst > best, worst - best, np.abs(worst) + 1e-9)
    return worst + (margin - 1.0) * span + 1e-12
