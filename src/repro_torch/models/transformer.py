"""Unified transformer family in PyTorch: dense GQA LMs (qwen3-8b,
deepseek-*), gemma2 (alternating local/global layers, softcaps, sandwich
norms, ring-buffer caches) and the hubert encoder, selected by ModelConfig
flags.

Port of ``repro/models/transformer.py`` with its parameter layout: layers
stacked on a leading axis (``{"all": ...}``, or ``{"local", "global"}`` for
gemma2's alternation), so ``_run_layers`` is a loop over layer indices.
Not ported yet (ROADMAP A.5): MoE blocks, the internvl2 patch prefix
(``vis_tokens``) and the paged-cache functions.
"""
from __future__ import annotations

from functools import partial
from typing import Any

import numpy as np
import torch

from . import layers as L
from .config import ModelConfig
from .tree import params_from_numpy  # noqa: F401  (re-exported for callers)
from .tree import layer, pad_rows, stacked_init, tree_map

Params = dict[str, Any]


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.n_experts:
        raise NotImplementedError(L._DEFERRED.format(what="MoE layer"))
    if cfg.vis_tokens:
        raise NotImplementedError(
            L._DEFERRED.format(what="internvl2 patch prefix"))


# ---------------------------------------------------------------------------
# One transformer block
# ---------------------------------------------------------------------------

def _block_init(gen, cfg: ModelConfig, tp: int, dtype, device) -> Params:
    norm = torch.zeros if cfg.sandwich_norm else torch.ones
    p: Params = {
        "ln_attn": norm((cfg.d_model,), dtype=dtype, device=device),
        "ln_mlp": norm((cfg.d_model,), dtype=dtype, device=device),
        "attn": L.attn_init(gen, cfg, tp, dtype, device),
    }
    if cfg.sandwich_norm:
        p["ln_attn_post"] = torch.zeros((cfg.d_model,), dtype=dtype,
                                        device=device)
        p["ln_mlp_post"] = torch.zeros((cfg.d_model,), dtype=dtype,
                                       device=device)
    p["mlp"] = L.mlp_init(gen, cfg, dtype, device)
    return p


def _block(p: Params, cfg: ModelConfig, x, *, positions, tp, impl, window,
           cache=None, cache_pos=None):
    plus_one = cfg.sandwich_norm  # gemma-style (1+w) norms
    h = L.rms_norm(x, p["ln_attn"], plus_one=plus_one)
    attn_out, cache = L.attention(
        p["attn"], cfg, h, positions=positions, tp=tp, impl=impl,
        window=window, cache=cache, cache_pos=cache_pos)
    if cfg.sandwich_norm:
        attn_out = L.rms_norm(attn_out, p["ln_attn_post"], plus_one=True)
    x = x + attn_out
    h = L.rms_norm(x, p["ln_mlp"], plus_one=plus_one)
    mlp_out = L.mlp(p["mlp"], h, gelu=cfg.gelu_mlp)
    if cfg.sandwich_norm:
        mlp_out = L.rms_norm(mlp_out, p["ln_mlp_post"], plus_one=True)
    return x + mlp_out, cache


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, seed: int = 0, tp: int = 1,
         device="cuda") -> Params:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on
    ``device``, with the reference's shapes and scales (not its numbers:
    the two generators differ; carry the reference's weights in with
    :func:`params_from_numpy`)."""
    _check_supported(cfg)
    device = torch.device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    block = partial(_block_init, gen, cfg, tp, dtype, device)
    if cfg.alt_local_global:
        n = cfg.n_layers // 2
        layers = {"local": stacked_init((n,), block),
                  "global": stacked_init((n,), block)}
    else:
        layers = {"all": stacked_init((cfg.n_layers,), block)}
    p: Params = {
        "embed": L.embed_init(gen, cfg, tp, dtype, device),
        "layers": layers,
        "final_norm": (torch.zeros if cfg.sandwich_norm else torch.ones)(
            (cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.name.startswith("gemma"):   # gemma ties head to the embedding
        p["head"] = {"table": L._normal(gen, (cfg.padded(tp).vocab,
                                              cfg.d_model), 0.02, dtype,
                                        device)}
    return p


def _run_layers(params, cfg: ModelConfig, x, *, positions, tp, impl,
                caches=None, cache_pos=None):
    """Run the block stack in order; returns (x, caches), the caches
    written in place."""
    kw = dict(positions=positions, tp=tp, impl=impl, cache_pos=cache_pos)
    if cfg.alt_local_global:
        groups = [("local", cfg.local_window), ("global", 0)]
        n = cfg.n_layers // 2
        order = [(name, i, w) for i in range(n) for name, w in groups]
    else:
        order = [("all", i, cfg.local_window) for i in range(cfg.n_layers)]
    for name, i, window in order:
        cache = None if caches is None else layer(caches[name], i)
        x, _ = _block(layer(params["layers"][name], i), cfg, x,
                      window=window, cache=cache, **kw)
    return x, caches


def _embed_inputs(params, cfg: ModelConfig, inputs: Params) -> torch.Tensor:
    if cfg.embed_inputs:                       # hubert: precomputed frames
        return inputs["frames"]
    return L.embed(params["embed"], inputs["tokens"],
                   scale=cfg.name.startswith("gemma"))


def forward(params: Params, cfg: ModelConfig, inputs: Params, *,
            tp: int = 1, impl: str = "cuda") -> torch.Tensor:
    """Full-sequence forward -> logits (prefill scoring / encoder).  Every
    layer's attention goes through ``ops.attention`` (the flash kernel when
    ``impl='cuda'``)."""
    _check_supported(cfg)
    x = _embed_inputs(params, cfg, inputs)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    x, _ = _run_layers(params, cfg, x, positions=positions, tp=tp, impl=impl)
    x = L.rms_norm(x, params["final_norm"], plus_one=cfg.sandwich_norm)
    head = params.get("head", params["embed"])
    return L.unembed(head, x, cfg.vocab, cap=cfg.final_softcap)


def _stack_of(cfg: ModelConfig, n: int, batch: int, seq: int, tp: int,
              dtype, device) -> Params:
    return tree_map(lambda x: torch.zeros((n, *x.shape), dtype=x.dtype,
                                      device=device),
                L.init_kv_cache(cfg, batch, seq, tp, dtype, device="meta"))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, tp: int = 1,
               dtype=torch.bfloat16, device="cuda") -> Params:
    if cfg.alt_local_global:
        n = cfg.n_layers // 2
        # sliding-window layers carry a ring buffer of `window` slots
        local_seq = min(max_seq, cfg.local_window or max_seq)
        return {"local": _stack_of(cfg, n, batch, local_seq, tp, dtype,
                                   device),
                "global": _stack_of(cfg, n, batch, max_seq, tp, dtype,
                                    device)}
    return {"all": _stack_of(cfg, cfg.n_layers, batch, max_seq, tp, dtype,
                             device)}


def init_prefill_cache(cfg: ModelConfig, batch: int, seq: int, tp: int = 1,
                       dtype=torch.bfloat16, device="cuda") -> Params:
    """Full-length caches for a one-shot slot prefill: sliding-window layers
    get the whole sequence rather than their ring, so every query position
    sees its exact window; :func:`pack_slot_cache` folds the result back
    into the serving ring layout afterwards."""
    if cfg.alt_local_global:
        n = cfg.n_layers // 2
        return {"local": _stack_of(cfg, n, batch, seq, tp, dtype, device),
                "global": _stack_of(cfg, n, batch, seq, tp, dtype, device)}
    return {"all": _stack_of(cfg, cfg.n_layers, batch, seq, tp, dtype,
                             device)}


def pack_slot_cache(cfg: ModelConfig, pcache: Params, max_seq: int,
                    seq_len: int) -> Params:
    """Repack a batch-1 prefill cache (length ``seq_len``) into one slot of
    the serving cache layout: plain KV is right-padded to ``max_seq``;
    sliding-window groups are folded into their ring layout (slot
    ``p % window`` holds position ``p`` of the last ``window`` positions,
    exactly what sequential decode would have left)."""
    if seq_len > max_seq:
        raise ValueError(f"prompt length {seq_len} exceeds max_seq {max_seq}")

    def one(tree, target, use_ring):
        if use_ring:
            return tree_map(lambda x: _fold_ring(x, target, seq_len), tree)
        return tree_map(lambda x: pad_rows(x, target), tree)

    if cfg.alt_local_global:
        local_seq = min(max_seq, cfg.local_window or max_seq)
        return {"local": one(pcache["local"], local_seq,
                             local_seq == cfg.local_window),
                "global": one(pcache["global"], max_seq, False)}
    return {"all": one(pcache["all"], max_seq, False)}


def _fold_ring(leaf: torch.Tensor, window: int,
               seq_len: int) -> torch.Tensor:
    last = seq_len - 1
    j = np.arange(window)
    p = last - (last - j) % window              # absolute position per slot
    idx = torch.as_tensor(np.clip(p, 0, seq_len - 1), device=leaf.device)
    rows = leaf.index_select(2, idx)
    valid = torch.as_tensor(p >= 0, device=leaf.device).reshape(
        (1, 1, window) + (1,) * (leaf.dim() - 3))
    return torch.where(valid, rows, torch.zeros_like(rows))


def cache_slot_axes(cfg: ModelConfig) -> Params:
    """Batch(=slot)-axis index of every cache leaf: the scatter map the
    serving engine uses to write one slot's prefill into the shared cache."""
    names = ("k", "v", "k_scale", "v_scale") if cfg.kv_int8 else ("k", "v")
    one = {n: 1 for n in names}
    if cfg.alt_local_global:
        return {"local": dict(one), "global": dict(one)}
    return {"all": one}


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, pos, *, tp: int = 1,
                impl: str = "cuda", row_map=None
                ) -> tuple[torch.Tensor, Params]:
    """One autoregressive step: tokens (B, S) at per-slot absolute positions
    ``pos`` ((B,) ints, host data; a scalar broadcasts).  S=1 is the serving
    decode step; S>1 is a slot prefill (one causal forward whose K/V land in
    the cache at ``pos .. pos+S-1``).  The cache is written in place and
    returned."""
    _check_supported(cfg)
    if row_map is not None:
        raise NotImplementedError(L._DEFERRED.format(what="paged KV pool"))
    x = L.embed(params["embed"], tokens, scale=cfg.name.startswith("gemma"))
    b, s, _ = x.shape
    cpos = L._positions_host(pos, b)
    positions = L._to_device(cpos[:, None] + torch.arange(s), x.device)
    x, cache = _run_layers(params, cfg, x, positions=positions, tp=tp,
                           impl=impl, caches=cache, cache_pos=cpos)
    x = L.rms_norm(x, params["final_norm"], plus_one=cfg.sandwich_norm)
    head = params.get("head", params["embed"])
    logits = L.unembed(head, x, cfg.vocab, cap=cfg.final_softcap)
    return logits, cache
