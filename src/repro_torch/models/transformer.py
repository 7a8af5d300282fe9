"""Unified transformer family in PyTorch: dense GQA LMs (qwen3-8b,
deepseek-*, the internvl2 backbone with its patch prefix), gemma2
(alternating local/global layers, softcaps, sandwich norms, ring-buffer
caches), MoE LMs (granite, moonshot) and the hubert encoder, selected by
ModelConfig flags.

Port of ``repro/models/transformer.py`` with its parameter layout: layers
stacked on a leading axis (``{"all": ...}``, or ``{"local", "global"}`` for
gemma2's alternation), so ``_run_layers`` is a loop over layer indices.
The paged cache keeps full-length KV in one physical pool per layer stack
(``layers.init_paged_kv_pool``) and gemma2's rings per slot.

``specs``, ``cache_specs`` and ``paged_cache_specs`` are the reference's
spec trees; under a mesh the model runs on each rank's compute view of its
params (``distributed.local``; each layer's weights, the embedding and
the head read through ``local.take``, which gathers them over 'data'
under FSDP), and a full-sequence forward of token
inputs lays its residual stream out as the activation context says
(sequence-parallel over 'model' under ``DEFAULT_TRAIN_SPEC``).
"""
from __future__ import annotations

from functools import partial
from typing import Any

import numpy as np
import torch

from repro_torch.distributed import local
from repro_torch.distributed.sharding import P, spec_map

from . import layers as L
from .config import ModelConfig
from .tree import params_from_numpy  # noqa: F401  (re-exported for callers)
from .tree import layer, pad_rows, stacked_init, tree_map

Params = dict[str, Any]


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
    if cfg.n_experts:
        p["moe"] = L.moe_init(gen, cfg, tp, dtype, device)
    else:
        p["mlp"] = L.mlp_init(gen, cfg, dtype, device)
    return p


def _block_specs(cfg: ModelConfig) -> Params:
    p: Params = {"ln_attn": P(None), "ln_mlp": P(None),
                 "attn": L.attn_specs(cfg)}
    if cfg.sandwich_norm:
        p["ln_attn_post"] = P(None)
        p["ln_mlp_post"] = P(None)
    if cfg.n_experts:
        p["moe"] = L.moe_specs()
    else:
        p["mlp"] = L.mlp_specs()
    return p


def _stacked_specs(tree):
    """Specs of a layer stack: a leading replicated axis."""
    return spec_map(lambda s: P(None, *s), tree)


def _block(p: Params, cfg: ModelConfig, x, *, positions, tp, impl, window,
           cache=None, cache_pos=None, pages=None):
    plus_one = cfg.sandwich_norm  # gemma-style (1+w) norms
    sp = local.seq_param          # the norms see this rank's tokens
    h = L.rms_norm(x, sp(p["ln_attn"]), plus_one=plus_one)
    attn_out, cache = L.attention(
        p["attn"], cfg, h, positions=positions, tp=tp, impl=impl,
        window=window, cache=cache, cache_pos=cache_pos, pages=pages)
    if cfg.sandwich_norm:
        attn_out = L.rms_norm(attn_out, sp(p["ln_attn_post"]),
                              plus_one=True)
    x = x + attn_out
    h = L.rms_norm(x, sp(p["ln_mlp"]), plus_one=plus_one)
    if cfg.n_experts:
        mlp_out = L.moe(p["moe"], cfg, h, tp)
    else:
        mlp_out = L.mlp(p["mlp"], h, gelu=cfg.gelu_mlp)
    if cfg.sandwich_norm:
        mlp_out = L.rms_norm(mlp_out, sp(p["ln_mlp_post"]), plus_one=True)
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


def specs(cfg: ModelConfig) -> Params:
    blk = _block_specs(cfg)
    if cfg.alt_local_global:
        layers = {"local": _stacked_specs(blk), "global": _stacked_specs(blk)}
    else:
        layers = {"all": _stacked_specs(blk)}
    p: Params = {"embed": L.embed_specs(), "layers": layers,
                 "final_norm": P(None)}
    if not cfg.name.startswith("gemma"):
        p["head"] = L.embed_specs()
    return p


def compute_segments(cfg: ModelConfig, tp: int) -> dict:
    """No concatenated dims (``distributed.local``)."""
    return {}


def _run_layers(params, cfg: ModelConfig, x, *, positions, tp, impl,
                caches=None, cache_pos=None, pages=None):
    """Run the block stack in order; returns (x, caches), the caches
    written in place.  ``pages`` is the step's page table, shared by
    every paged layer."""
    kw = dict(positions=positions, tp=tp, impl=impl, cache_pos=cache_pos,
              pages=pages)
    if cfg.alt_local_global:
        groups = [("local", cfg.local_window), ("global", 0)]
        n = cfg.n_layers // 2
        order = [(name, i, w) for i in range(n) for name, w in groups]
    else:
        order = [("all", i, cfg.local_window) for i in range(cfg.n_layers)]
    for name, i, window in order:
        cache = None if caches is None else layer(caches[name], i)
        x, _ = _block(local.take(params, ("layers", name), (i,)), cfg, x,
                      window=window, cache=cache, **kw)
    return x, caches


def _embed_inputs(params, cfg: ModelConfig, inputs: Params) -> torch.Tensor:
    if cfg.embed_inputs:                       # hubert: precomputed frames
        return inputs["frames"]
    x = L.embed(local.take(params, ("embed",)), inputs["tokens"],
                scale=cfg.name.startswith("gemma"))
    if cfg.vis_tokens:                         # internvl2: patch prefix
        x = torch.cat([inputs["patches"].to(x.dtype), x], dim=1)
    return x


def _head(params: Params) -> Params:
    """The unembedding (gemma ties it to the embedding)."""
    return local.take(params, ("head",) if "head" in params else ("embed",))


def forward(params: Params, cfg: ModelConfig, inputs: Params, *,
            tp: int = 1, impl: str = "cuda") -> torch.Tensor:
    """Full-sequence forward -> logits (prefill scoring / encoder).  Every
    layer's attention goes through ``ops.attention`` (the flash kernel when
    ``impl='cuda'``).  Token inputs may run sequence-parallel under a
    mesh (module docstring); frames and patch prefixes never do."""
    tokens_only = not (cfg.embed_inputs or cfg.vis_tokens)
    with local.residual_layout(inputs["tokens"].shape[1] if tokens_only
                               else 0):
        x = _embed_inputs(params, cfg, inputs)
        b, s = x.shape[0], (inputs["tokens"].shape[1] if tokens_only
                            else x.shape[1])
        positions = torch.arange(s, device=x.device).expand(b, s)
        x, _ = _run_layers(params, cfg, x, positions=positions, tp=tp,
                           impl=impl)
        x = L.rms_norm(x, local.seq_param(params["final_norm"]),
                       plus_one=cfg.sandwich_norm)
        return L.unembed(_head(params), x, cfg.vocab, cap=cfg.final_softcap)


def _stacked(n: int, leaves: Params, device) -> Params:
    """``n`` zero copies of the (meta) ``leaves`` stacked on a leading
    axis, on ``device``."""
    return tree_map(lambda x: torch.zeros((n, *x.shape), dtype=x.dtype,
                                          device=device), leaves)


def _stack_of(cfg: ModelConfig, n: int, batch: int, seq: int, tp: int,
              dtype, device) -> Params:
    return _stacked(n, L.init_kv_cache(cfg, batch, seq, tp, dtype,
                                       device="meta"), device)


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


def cache_specs(cfg: ModelConfig) -> Params:
    base = _stacked_specs(L.kv_cache_specs(cfg))
    if cfg.alt_local_global:
        return {"local": base, "global": base}
    return {"all": base}


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


def init_paged_cache(cfg: ModelConfig, slots: int, rows: int, max_seq: int,
                     tp: int = 1, dtype=torch.bfloat16,
                     device="cuda") -> Params:
    """Paged serving cache: full-length attention KV lives in one physical
    pool of ``rows`` page-resident rows (plus the scratch row) shared by
    every slot, indexed through the engine's page table.  Sliding-window
    ring layers keep their fixed per-slot ring: a ring is already
    O(window) per slot, so paging it frees nothing."""
    def pool(n):
        return _stacked(n, L.init_paged_kv_pool(cfg, rows, tp, dtype,
                                                device="meta"), device)

    if cfg.alt_local_global:
        n = cfg.n_layers // 2
        local_seq = min(max_seq, cfg.local_window or max_seq)
        return {"local": _stack_of(cfg, n, slots, local_seq, tp, dtype,
                                   device),
                "global": pool(n)}
    return {"all": pool(cfg.n_layers)}


def paged_cache_specs(cfg: ModelConfig) -> Params:
    """Specs mirroring :func:`init_paged_cache`: pool leaves gain the layer
    axis over the kv-pool specs; gemma2's local rings keep the dense
    per-slot specs."""
    pool = _stacked_specs(L.paged_kv_pool_specs(cfg))
    if cfg.alt_local_global:
        return {"local": _stacked_specs(L.kv_cache_specs(cfg)),
                "global": pool}
    return {"all": pool}


def paged_slot_axes(cfg: ModelConfig) -> Params:
    """Scatter map for the paged cache: ``"pool"`` marks leaves living in
    the shared physical pool (written through page-table rows); ints are
    the slot-axis index of per-slot dense leaves, as in
    :func:`cache_slot_axes`."""
    axes = cache_slot_axes(cfg)
    pooled = "global" if cfg.alt_local_global else "all"
    axes[pooled] = {name: "pool" for name in axes[pooled]}
    return axes


def pack_paged_slot(cfg: ModelConfig, pcache: Params, max_seq: int,
                    seq_len: int) -> Params:
    """Repack a batch-1 prefill cache for the paged layout: ring leaves are
    folded exactly as in :func:`pack_slot_cache`; pool leaves keep their raw
    ``seq_len`` rows (the engine scatters them at page-table rows, so no
    right-padding to ``max_seq`` ever exists)."""
    if seq_len > max_seq:
        raise ValueError(f"prompt length {seq_len} exceeds max_seq {max_seq}")
    if cfg.alt_local_global:
        local_seq = min(max_seq, cfg.local_window or max_seq)
        if local_seq == cfg.local_window:
            local = tree_map(lambda x: _fold_ring(x, local_seq, seq_len),
                             pcache["local"])
        else:
            local = tree_map(lambda x: pad_rows(x, local_seq),
                             pcache["local"])
        return {"local": local, "global": pcache["global"]}
    return {"all": pcache["all"]}


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, pos, *, tp: int = 1,
                impl: str = "cuda", row_map=None
                ) -> tuple[torch.Tensor, Params]:
    """One autoregressive step: tokens (B, S) at per-slot absolute positions
    ``pos`` ((B,) ints, host data; a scalar broadcasts).  S=1 is the serving
    decode step; S>1 is a slot prefill (one causal forward whose K/V land in
    the cache at ``pos .. pos+S-1``).  ``row_map`` ((B, L) host ints)
    routes pooled KV leaves through the paged engine's page table.  The
    cache is written in place and returned."""
    x = L.embed(local.take(params, ("embed",)), tokens,
                scale=cfg.name.startswith("gemma"))
    b, s, _ = x.shape
    cpos = L._positions_host(pos, b)
    positions = L._to_device(cpos[:, None] + torch.arange(s), x.device)
    pages = None if row_map is None else L.page_table(row_map, cpos, s,
                                                      x.device)
    x, cache = _run_layers(params, cfg, x, positions=positions, tp=tp,
                           impl=impl, caches=cache, cache_pos=cpos,
                           pages=pages)
    x = L.rms_norm(x, params["final_norm"], plus_one=cfg.sandwich_norm)
    logits = L.unembed(_head(params), x, cfg.vocab, cap=cfg.final_softcap)
    return logits, cache
