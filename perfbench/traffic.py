"""The one generator of traffic: it takes a mix's parameters (its file in
``perfbench/traffic/``) and draws the requests from ``--seed``.

A request is found by its index alone (its own stream of draws), so every
run of one seed sends the same requests in the same order, however many
the window holds; the warm-up draws from a stream of its own.
"""
from __future__ import annotations

import numpy as np

from perfbench.weights import sub_seed


class TokenStream:
    """Rows of token ids, uniform over the vocabulary: request ``i`` is a
    (batch, seq_len) int64 array."""

    def __init__(self, mix: dict, seed: int, vocab: int,
                 stream: str = "requests"):
        if mix.get("tokens", "uniform") != "uniform":
            raise ValueError(f"unknown token distribution {mix['tokens']!r}")
        self.shape = (int(mix["batch"]), int(mix["seq_len"]))
        self.vocab = vocab
        self.base = sub_seed(seed, stream)

    def get(self, i: int) -> np.ndarray:
        rng = np.random.default_rng([self.base, i])
        return rng.integers(0, self.vocab, size=self.shape, dtype=np.int64)


def sample(seed: int, n: int, k: int) -> list[int]:
    """``k`` of the indices 0..n-1 (all if fewer), drawn from the seed,
    always with the last one: the request that closed the window."""
    if n <= k:
        return list(range(n))
    rng = np.random.default_rng(sub_seed(seed, "sample"))
    rest = rng.choice(n - 1, size=k - 1, replace=False)
    return sorted(int(i) for i in rest) + [n - 1]
