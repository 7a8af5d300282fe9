"""Zamba2 hybrid LM (zamba2-2.7b) in PyTorch: a Mamba-2 backbone plus one
*shared* attention block applied after every ``attn_every`` Mamba layers
(its weights reused by every call, each call with its own KV cache).

Port of ``repro/models/zamba2.py`` with its parameter layout (Mamba blocks
stacked on two leading axes, (groups, per group)) and its simplifications
(the shared block sees the hidden state only; no per-call LoRA adapters).
Mamba-2 mixer per layer: in_proj -> [z | x | B | C | dt], a short causal
depthwise conv on (x | B | C) with its carried tail, the SSD recurrence
through ``ops.mamba2`` (the CUDA kernel with ``impl='cuda'``) with per-head
scalar decay a = dt * (-exp(A_log)), the D skip, silu(z) gating, RMS norm,
out_proj.  B and C (one group) reach the kernel as stride-0 ``expand``
views over the head axis, where the reference materialises them per head.
The shared block reuses ``layers.attention`` / ``layers.mlp``: in the
full-sequence forward its attention is the flash kernel at head_dim 80.

Decode carries (conv tail, SSD state) per layer and the KV cache per
shared-block call, written in place.  Not ported (ROADMAP A.6): the paged
cache and the tensor-parallel specs; they raise.
"""
from __future__ import annotations

from functools import partial
from typing import Any

import torch
import torch.nn.functional as F

from . import layers as L
from .config import ModelConfig
from .tree import layer, pad_rows, stacked_init, tree_map

Params = dict[str, Any]
CONV_K = 4


def _dims(cfg: ModelConfig, tp: int):
    d_in = cfg.ssm_expand * cfg.d_model
    heads = cfg.padded(tp).ssm_heads or d_in // cfg.ssm_head_dim
    return d_in, heads, cfg.ssm_state


def _n_groups(cfg: ModelConfig) -> int:
    return max(1, cfg.n_layers // max(1, cfg.attn_every))


def _mamba_init(gen, cfg: ModelConfig, tp: int, dtype, device) -> Params:
    d = cfg.d_model
    _, h, n = _dims(cfg, tp)
    hp = h * cfg.ssm_head_dim              # padded inner width
    conv_dim = hp + 2 * n
    logical_h = (cfg.ssm_expand * d) // cfg.ssm_head_dim
    normal = partial(L._normal, gen, dtype=dtype, device=device)
    f32 = partial(torch.zeros, dtype=torch.float32, device=device)
    p = {
        "ln": torch.ones((d,), dtype=dtype, device=device),
        # [z (hp) | x (hp) | B (n) | C (n) | dt (h)]
        "in_proj": normal((d, 2 * hp + 2 * n + h), d ** -0.5),
        "conv_w": normal((CONV_K, conv_dim), 0.3),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "a_log": f32((h,)),
        "dt_bias": f32((h,)),
        "d_skip": torch.ones((h,), device=device),
        "norm": torch.ones((hp,), dtype=dtype, device=device),
        "out_proj": normal((hp, d), hp ** -0.5),
    }
    if h > logical_h:  # exact padding: zero out_proj rows for extra heads
        mask = (torch.arange(h, device=device) < logical_h) \
            .repeat_interleave(cfg.ssm_head_dim)[:, None]
        p["out_proj"] = (p["out_proj"] * mask).to(dtype)
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor | None = None):
    """Depthwise causal conv, window CONV_K, by shift-and-add.  x: (B, S,
    C); tail: (B, CONV_K - 1, C), the carry for decode.  Returns (y,
    new_tail)."""
    if tail is None:
        tail = x.new_zeros((x.shape[0], CONV_K - 1, x.shape[2]))
    ext = torch.cat([tail, x], dim=1)                 # (B, S+K-1, C)
    s = x.shape[1]
    y = sum(ext[:, i:i + s] * w[i] for i in range(CONV_K)) + b
    return F.silu(y), ext[:, -(CONV_K - 1):]


def _mamba_block(p: Params, cfg: ModelConfig, x, tp: int, impl,
                 state: Params | None = None):
    bsz, s, _ = x.shape
    _, h, n = _dims(cfg, tp)
    ph = cfg.ssm_head_dim
    hp = h * ph
    st = state or {}

    zxbcdt = L.rms_norm(x, p["ln"]) @ p["in_proj"]
    z = zxbcdt[..., :hp]
    xbc = zxbcdt[..., hp:hp + hp + 2 * n]
    dt_raw = zxbcdt[..., -h:]

    xbc, new_tail = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                 st.get("conv"))
    xs = xbc[..., :hp].reshape(bsz, s, h, ph)
    bmat = xbc[..., hp:hp + n]                        # (B, S, N), one group
    cmat = xbc[..., hp + n:]

    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    log_decay = -dt * torch.exp(p["a_log"])           # (B, S, H) <= 0
    x_scaled = (xs.float() * dt[..., None]).to(x.dtype)
    bh = bmat[:, :, None, :].expand(bsz, s, h, n)     # stride 0 over heads
    ch = cmat[:, :, None, :].expand(bsz, s, h, n)

    if s == 1:
        # decode fast path: one SSD recurrence step
        h0 = st.get("ssd")
        if h0 is None:
            h0 = torch.zeros((bsz, h, n, ph), device=x.device)
        xf = x_scaled[:, 0].float()
        bf, cf = bh[:, 0].float(), ch[:, 0].float()
        h1 = torch.exp(log_decay[:, 0])[..., None, None] * h0 \
            + bf[..., :, None] * xf[..., None, :]
        y = torch.einsum("bhn,bhnp->bhp", cf, h1)[:, None].to(x.dtype)
        new_ssd = h1
    else:
        y, new_ssd = L.op(impl, "mamba2")(x_scaled, log_decay.to(x.dtype),
                                          bh, ch, st.get("ssd"))

    y = y + xs * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, hp)
    y = L.rms_norm(y * F.silu(z), p["norm"])
    return x + y @ p["out_proj"], {"conv": new_tail, "ssd": new_ssd}


def _shared_attn(shared: Params, cfg: ModelConfig, x, *, positions, tp,
                 impl, cache=None, cache_pos=None):
    h = L.rms_norm(x, shared["ln_attn"])
    att, _ = L.attention(shared["attn"], cfg, h, positions=positions, tp=tp,
                         impl=impl, cache=cache, cache_pos=cache_pos)
    x = x + att
    return x + L.mlp(shared["mlp"], L.rms_norm(x, shared["ln_mlp"]))


# ---------------------------------------------------------------------------
# Model: groups of (attn_every Mamba blocks) + one shared attention block
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, seed: int = 0, tp: int = 1,
         device="cuda") -> Params:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on
    ``device``, with the reference's shapes, dtypes and scales (not its
    numbers; carry those in with ``tree.params_from_numpy``)."""
    device = torch.device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    g = _n_groups(cfg)
    layers = stacked_init((g, cfg.n_layers // g),
                          partial(_mamba_init, gen, cfg, tp, dtype, device))
    ones = partial(torch.ones, (cfg.d_model,), dtype=dtype, device=device)
    shared = {"ln_attn": ones(), "ln_mlp": ones(),
              "attn": L.attn_init(gen, cfg, tp, dtype, device),
              "mlp": L.mlp_init(gen, cfg, dtype, device)}
    return {
        "embed": L.embed_init(gen, cfg, tp, dtype, device),
        "layers": layers,                       # (G, per, ...)
        "shared": shared,
        "final_norm": ones(),
        "head": {"table": L._normal(gen, (cfg.padded(tp).vocab, cfg.d_model),
                                    0.02, dtype, device)},
    }


def _run(params: Params, cfg: ModelConfig, x, *, positions, tp, impl,
         cache: Params | None = None, cache_pos=None):
    """The groups in order: each group's Mamba blocks, then the shared
    block; with a cache, every state is read and written in place."""
    g = _n_groups(cfg)
    per = cfg.n_layers // g
    for gi in range(g):
        for li in range(per):
            st = None if cache is None else layer(
                {"conv": cache["conv"], "ssd": cache["ssd"]}, gi, li)
            x, new = _mamba_block(layer(params["layers"], gi, li), cfg, x,
                                  tp, impl, state=st)
            if st is not None:
                for name, t in new.items():
                    st[name].copy_(t)
        x = _shared_attn(params["shared"], cfg, x, positions=positions,
                         tp=tp, impl=impl,
                         cache=None if cache is None
                         else layer(cache["attn"], gi),
                         cache_pos=cache_pos)
    x = L.rms_norm(x, params["final_norm"])
    return L.unembed(params["head"], x, cfg.vocab)


def forward(params: Params, cfg: ModelConfig, inputs: Params, *,
            tp: int = 1, impl="cuda") -> torch.Tensor:
    """Full-sequence forward -> logits: every Mamba layer's recurrence goes
    through ``ops.mamba2`` and every shared-block call's attention through
    ``ops.attention`` (the kernels when ``impl='cuda'``)."""
    x = L.embed(params["embed"], inputs["tokens"])
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    return _run(params, cfg, x, positions=positions, tp=tp, impl=impl)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, tp: int = 1,
               dtype=None, device="cuda") -> Params:
    """Per layer the conv tail (in ``dtype``, default the config's) and the
    SSD state (float32); per shared-block call a KV cache of ``max_seq``
    rows in ``dtype``."""
    dtype = dtype or getattr(torch, cfg.dtype)
    _, h, n = _dims(cfg, tp)
    hp = h * cfg.ssm_head_dim
    g = _n_groups(cfg)
    per = cfg.n_layers // g
    return {
        "conv": torch.zeros((g, per, batch, CONV_K - 1, hp + 2 * n),
                            dtype=dtype, device=device),
        "ssd": torch.zeros((g, per, batch, h, n, cfg.ssm_head_dim),
                           device=device),
        "attn": tree_map(lambda x: torch.zeros((g, *x.shape), dtype=x.dtype,
                                               device=device),
                         L.init_kv_cache(cfg, batch, max_seq, tp, dtype,
                                         device="meta")),
    }


def init_prefill_cache(cfg: ModelConfig, batch: int, seq: int, tp: int = 1,
                       dtype=None, device="cuda") -> Params:
    """Batch-1 prefill caches: conv/SSD states are O(1) in sequence length;
    only the shared-attention KV needs the prompt length."""
    return init_cache(cfg, batch, seq, tp, dtype, device)


def pack_slot_cache(cfg: ModelConfig, pcache: Params, max_seq: int,
                    seq_len: int) -> Params:
    """Repack a batch-1 prefill cache into one serving slot: the conv/SSD
    states carry over as they are, the attention KV pads to ``max_seq``."""
    if seq_len > max_seq:
        raise ValueError(f"prompt length {seq_len} exceeds max_seq {max_seq}")
    return {"conv": pcache["conv"], "ssd": pcache["ssd"],
            "attn": tree_map(lambda x: pad_rows(x, max_seq), pcache["attn"])}


def cache_slot_axes(cfg: ModelConfig) -> Params:
    """Batch(=slot)-axis index of every cache leaf (serving scatter map)."""
    names = ("k", "v", "k_scale", "v_scale") if cfg.kv_int8 else ("k", "v")
    return {"conv": 2, "ssd": 2, "attn": {name: 1 for name in names}}


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, pos, *, tp: int = 1, impl="cuda",
                row_map=None) -> tuple[torch.Tensor, Params]:
    """Decode ``tokens (B, S)`` at per-slot positions ``pos`` ((B,) ints,
    host data; a scalar broadcasts); S > 1 is a slot prefill (the Mamba
    layers through the kernel, the shared block's attention against its
    cache).  The cache is written in place and returned."""
    if row_map is not None:
        raise NotImplementedError("not ported yet (ROADMAP A.6: paged cache)")
    x = L.embed(params["embed"], tokens)
    b, s, _ = x.shape
    cpos = L._positions_host(pos, b)
    positions = L._to_device(cpos[:, None] + torch.arange(s), x.device)
    return _run(params, cfg, x, positions=positions, tp=tp, impl=impl,
                cache=cache, cache_pos=cpos), cache


specs = cache_specs = L.deferred("A.6", "tensor-parallel specs")
init_paged_cache = paged_cache_specs = paged_slot_axes = pack_paged_slot = \
    L.deferred("A.6", "paged cache")
