"""Deterministic synthetic LM data pipeline.

Port of ``repro/data/pipeline.py`` (numpy only, so its batches are the
reference's bit for bit):
  * step-indexed determinism: batch(step) is a pure function of (seed,
    step), so restarts resume bit-identically with no data state to
    checkpoint;
  * background prefetch of the next batch while the step runs.

The per-host sharded batch (``global_arrays``, ``make_global_batch``) needs
a device mesh and is not ported yet (ROADMAP A.8).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np

from repro_torch.models.layers import deferred


@dataclass
class SyntheticLM:
    """Zipf-ish synthetic token stream with next-token labels."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def _host_batch(self, step: int, lo: int, hi: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, lo]))
        n = hi - lo
        # zipf-like marginal over the vocabulary, cheap and deterministic
        u = rng.random((n, self.seq_len + 1))
        toks = np.minimum((self.vocab * u ** 2.2).astype(np.int32),
                          self.vocab - 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def batch(self, step: int) -> dict[str, np.ndarray]:
        return self._host_batch(step, 0, self.global_batch)

    global_arrays = deferred("A.8", "the per-host sharded batch on a mesh")


make_global_batch = deferred("A.8", "the per-host sharded batch on a mesh")


class Prefetcher:
    """One-deep background prefetch of batch(step+1)."""

    def __init__(self, fn, start_step: int = 0):
        self._fn = fn
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._next = start_step
        self._push()

    def _push(self):
        step = self._next
        self._next += 1
        t = threading.Thread(target=lambda: self._q.put((step, self._fn(step))),
                             daemon=True)
        t.start()

    def get(self):
        step, batch = self._q.get()
        self._push()
        return step, batch
