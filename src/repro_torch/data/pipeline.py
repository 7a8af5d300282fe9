"""Deterministic synthetic LM data pipeline.

Port of ``repro/data/pipeline.py`` (numpy only, so its batches are the
reference's bit for bit):
  * step-indexed determinism: batch(step) is a pure function of (seed,
    step), so restarts resume bit-identically with no data state to
    checkpoint;
  * background prefetch of the next batch while the step runs.

On a mesh, ``global_arrays`` gives each rank only its own rows of the
global batch, made on that rank: the generator is advanced past the rows
before them, so they are ``batch(step)``'s rows bit for bit, on any mesh.
(The reference seeds each shard with its first row instead, so its global
batch changes with the mesh.)
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np

from repro_torch.distributed.sharding import BATCH_AXES, P


@dataclass
class SyntheticLM:
    """Zipf-ish synthetic token stream with next-token labels."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def _rows(self, step: int, lo: int, n: int) -> dict[str, np.ndarray]:
        """Rows ``lo .. lo + n`` of ``batch(step)``, drawing only those:
        each row takes ``seq_len + 1`` doubles, one generator step each."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, 0]))
        rng.bit_generator.advance(lo * (self.seq_len + 1))
        u = rng.random((n, self.seq_len + 1))
        toks = np.minimum((self.vocab * u ** 2.2).astype(np.int32),
                          self.vocab - 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def batch(self, step: int) -> dict[str, np.ndarray]:
        return self._rows(step, 0, self.global_batch)

    def global_arrays(self, step: int, mesh,
                      batch_axes=BATCH_AXES) -> dict[str, np.ndarray]:
        """This rank's rows of the global batch, the batch dim split over
        the mesh's ``batch_axes`` (DTensor's chunk rule)."""
        from repro_torch.distributed.local import shard_slices

        rows = shard_slices((self.global_batch, self.seq_len),
                            P(batch_axes, None), mesh)[0]
        return self._rows(step, rows.start, rows.stop - rows.start)


def make_global_batch(source: SyntheticLM, mesh, step: int):
    return source.global_arrays(step, mesh)


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
