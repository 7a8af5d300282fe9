"""Step builders: the prefill step (both forms) and the decode (serve)
step, shared by the server and ``chip_smoke.py``.

Port of ``repro/launch/steps.py``.  The training step, its loss and
``cross_entropy`` come with the training slice (ROADMAP A.7).
"""
from __future__ import annotations

import torch

from repro_torch.models import family_module
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, *, tp: int = 1, impl: str = "cuda",
                      cache_len: int | None = None):
    """Prefill step builder.

    Without ``cache_len`` (prefill scoring): a plain full-sequence forward
    returning logits; its attention runs ``impl`` ('cuda': the flash
    kernel; see ``models.layers`` for the other choices).

    With ``cache_len`` (serving): one causal forward over ``tokens (1, S)``
    through the decode path against a fresh batch-1 cache on the tokens'
    device, returning ``(logits, slot_cache)`` where ``slot_cache`` is
    packed into the serving layout (length ``cache_len``, ring folds
    applied): what S sequential decode steps would have left.
    """
    mod = family_module(cfg)

    if cache_len is None:
        def prefill_step(params, batch):
            return mod.forward(params, cfg, batch, tp=tp, impl=impl)

        return prefill_step

    def slot_prefill_step(params, tokens):
        b, s = tokens.shape
        pcache = mod.init_prefill_cache(cfg, b, s, tp, device=tokens.device)
        logits, pcache = mod.decode_step(
            params, cfg, pcache, tokens, torch.zeros(b, dtype=torch.int64),
            tp=tp, impl=impl)
        return logits, mod.pack_slot_cache(cfg, pcache, cache_len, s)

    return slot_prefill_step


def make_decode_step(cfg: ModelConfig, *, tp: int = 1, impl: str = "cuda"):
    mod = family_module(cfg)

    def decode_step(params, cache, tokens, pos, row_map=None):
        """tokens (B, S); pos (B,) per-slot absolute positions (scalar
        broadcasts).  The cache is written in place and returned."""
        return mod.decode_step(params, cfg, cache, tokens, pos,
                               tp=tp, impl=impl, row_map=row_map)

    return decode_step
