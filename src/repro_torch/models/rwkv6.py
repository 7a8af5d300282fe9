"""RWKV-6 "Finch" LM (rwkv6-3b) in PyTorch: attention-free, with a
data-dependent per-channel decay.

Port of ``repro/models/rwkv6.py`` with its parameter layout (blocks stacked
on a leading axis) and its simplification: the token-shift mixing
coefficients are static per-channel ``mu`` rather than data-dependent
ddlerp.  Block = time-mix (the WKV recurrence through ``ops.rwkv6``, the
CUDA kernel with ``impl='cuda'``) + channel-mix.  The elementwise and
row-norm work between the matrix products goes through six ops
(``ops.rwkv6_time_in``, ``rwkv6_decay``, ``rwkv6_head_out``,
``rwkv6_channel_in``, ``rwkv6_relu2``, ``rwkv6_channel_out``: one kernel
launch each with ``impl='cuda'``, the reference's expressions under
``impl=kernels.plain``).  Cast points kept from the reference: the
log-decay is computed in float32 and cast to x's dtype before the kernel,
``u`` goes in its parameter dtype, and the one-token decode step keeps the
log-decay in float32 and runs the recurrence step as einsums (no recurrence
kernel).

The cache is the recurrent state, O(1) in sequence length, written in
place; the paged engine pages nothing of it (its paged cache is the dense
cache).

Under a mesh each rank runs its own heads (``specs``: ``wr``/``wk``/``wv``/
``wg``, ``w_lora_b`` and ``wck``/``wcr`` column-parallel, ``wo``/``wcv``
row-parallel; ``u``, ``w0`` and the per-head group norm ``ln_x`` local to
the heads), the token-shift mixing replicated.  The channel mix's
receptance ``xr @ wcr`` is column-split, so it is all-gathered before its
sigmoid gates the row-parallel sum.
"""
from __future__ import annotations

from functools import partial
from typing import Any

import torch

from repro_torch import obs
from repro_torch.distributed import local
from repro_torch.distributed.sharding import FSDP, TP, P, spec_map

from . import layers as L
from .config import ModelConfig
from .tree import layer, stacked_init

Params = dict[str, Any]
LORA_RANK = 64


def _heads(cfg: ModelConfig, tp: int) -> int:
    return cfg.padded(tp).rwkv_heads or cfg.d_model // cfg.rwkv_head_dim


def _block_init(gen, cfg: ModelConfig, tp: int, dtype, device) -> Params:
    d, dh = cfg.d_model, cfg.rwkv_head_dim
    h = _heads(cfg, tp)
    hd = h * dh
    sc = d ** -0.5
    normal = partial(L._normal, gen, dtype=dtype, device=device)
    ones = partial(torch.ones, dtype=dtype, device=device)
    p = {
        "ln1": ones((d,)), "ln2": ones((d,)),
        # time-mix
        "mu": normal((5, d), 0.02) + 0.5,                     # r,k,v,g,w
        "wr": normal((d, hd), sc),
        "wk": normal((d, hd), sc),
        "wv": normal((d, hd), sc),
        "wg": normal((d, hd), sc),
        "wo": normal((hd, d), hd ** -0.5),
        "w0": torch.full((hd,), -1.0, dtype=dtype, device=device),
        "w_lora_a": normal((d, LORA_RANK), sc),
        "w_lora_b": normal((LORA_RANK, hd), LORA_RANK ** -0.5),
        "u": normal((h, dh), 0.5),
        "ln_x": ones((h, dh)),
        # channel-mix
        "mu_c": normal((2, d), 0.02) + 0.5,                   # k, r
        "wck": normal((d, cfg.d_ff), sc),
        "wcv": normal((cfg.d_ff, d), cfg.d_ff ** -0.5),
        "wcr": normal((d, d), sc),
    }
    logical = cfg.d_model // cfg.rwkv_head_dim
    if h > logical:  # exact padding: zero output rows for the extra heads
        mask = (torch.arange(h, device=device) < logical) \
            .repeat_interleave(dh)[:, None]
        p["wo"] = (p["wo"] * mask).to(dtype)
    return p


def _block_specs(cfg: ModelConfig) -> Params:
    return {
        "ln1": P(None), "ln2": P(None),
        "mu": P(None, None),
        "wr": P(FSDP, TP), "wk": P(FSDP, TP), "wv": P(FSDP, TP),
        "wg": P(FSDP, TP), "wo": P(TP, FSDP),
        "w0": P(TP), "w_lora_a": P(FSDP, None), "w_lora_b": P(None, TP),
        "u": P(TP, None), "ln_x": P(TP, None),
        "mu_c": P(None, None),
        "wck": P(FSDP, TP), "wcv": P(TP, FSDP), "wcr": P(FSDP, TP),
    }


def _time_mix(p: Params, cfg: ModelConfig, mixed, tp: int, impl,
              wkv_state=None):
    xr, xk, xv, xg, xw = mixed
    b, s, _ = xr.shape
    dh = cfg.rwkv_head_dim
    h = _heads(cfg, tp) // local.tp_degree()       # this rank's heads
    col = local.column_in

    r = (col(xr) @ p["wr"]).reshape(b, s, h, dh)
    k = (col(xk) @ p["wk"]).reshape(b, s, h, dh)
    v = (col(xv) @ p["wv"]).reshape(b, s, h, dh)
    g_pre = col(xg) @ p["wg"]
    # data-dependent decay (Finch): log-decay = -exp(w0 + lora(x_w)) <= 0,
    # in x's dtype for the kernel, float32 for the decode step
    lora = col(torch.tanh(xw @ p["w_lora_a"])) @ p["w_lora_b"]
    logw = L.op(impl, "rwkv6_decay")(
        p["w0"], lora, torch.float32 if s == 1 else xr.dtype)
    logw = logw.reshape(b, s, h, dh)

    if s == 1:
        # decode fast path: one recurrence step, no recurrence kernel
        st = wkv_state if wkv_state is not None else torch.zeros(
            (b, h, dh, dh), device=xr.device)
        r1, k1, v1 = (z[:, 0].float() for z in (r, k, v))
        kv = k1[..., :, None] * v1[..., None, :]
        u_f = p["u"].float()
        o1 = torch.einsum("bhk,bhkv->bhv", r1, st + u_f[None, :, :, None] * kv)
        new_state = torch.exp(logw[:, 0])[..., None] * st + kv
        out = o1[:, None].to(xr.dtype)
    else:
        out, new_state = L.op(impl, "rwkv6")(r, k, v, logw, p["u"], wkv_state)
    # per-head group norm, then gate and project
    out = L.op(impl, "rwkv6_head_out")(out, p["ln_x"], g_pre)
    return local.row_out(out @ p["wo"]), new_state


def _channel_mix(p: Params, xk, xr, impl):
    """-> (the receptance's pre-activation, gathered over 'model'; the
    projected hidden layer, summed over 'model')."""
    hidden = L.op(impl, "rwkv6_relu2")(local.column_in(xk) @ p["wck"])
    r_pre = local.gather_from_model(local.column_in(xr) @ p["wcr"], -1)
    return r_pre, local.row_out(hidden @ p["wcv"])


def _block(p: Params, cfg: ModelConfig, x, tp, impl, state=None, layer=0):
    st = state or {}
    # spans on the whole-sequence forward; a serving step, which carries
    # state, records none
    rec = obs.recording() if state is None else None
    time_mix, channel_mix = (obs.NULL_SPAN,) * 2 if rec is None else (
        rec.tracer.span(name, {"layer": layer}, x.device)
        for name in ("rwkv6.time_mix", "rwkv6.channel_mix"))
    with time_mix:
        # ln1, the token shift and the five mixes; the carry is the last
        # normed row
        *mixed, sh_t = L.op(impl, "rwkv6_time_in")(x, p["ln1"], p["mu"],
                                                   st.get("shift_t"))
        att, wkv = _time_mix(p, cfg, mixed, tp, impl, st.get("wkv"))
    with channel_mix:
        # the residual x + att, ln2, the shift and the two mixes
        x, xk, xr, sh_c = L.op(impl, "rwkv6_channel_in")(
            x, att, p["ln2"], p["mu_c"], st.get("shift_c"))
        x = L.op(impl, "rwkv6_channel_out")(x, *_channel_mix(p, xk, xr, impl))
    return x, {"wkv": wkv, "shift_t": sh_t, "shift_c": sh_c}


# ---------------------------------------------------------------------------
# Model API
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, seed: int = 0, tp: int = 1,
         device="cuda") -> Params:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on
    ``device``, with the reference's shapes, dtypes and scales (not its
    numbers; carry those in with ``tree.params_from_numpy``)."""
    device = torch.device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    layers = stacked_init((cfg.n_layers,),
                          partial(_block_init, gen, cfg, tp, dtype, device))
    return {
        "embed": L.embed_init(gen, cfg, tp, dtype, device),
        "layers": layers,
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "head": {"table": L._normal(gen, (cfg.padded(tp).vocab, cfg.d_model),
                                    0.02, dtype, device)},
    }


def specs(cfg: ModelConfig) -> Params:
    blk = spec_map(lambda s: P(None, *s), _block_specs(cfg))
    return {"embed": L.embed_specs(), "layers": blk, "final_norm": P(None),
            "head": L.embed_specs()}


def compute_segments(cfg: ModelConfig, tp: int) -> dict:
    """No concatenated dims (``distributed.local``): heads split whole."""
    return {}


def forward(params: Params, cfg: ModelConfig, inputs: Params, *,
            tp: int = 1, impl="cuda") -> torch.Tensor:
    """Full-sequence forward -> logits; every layer's recurrence goes
    through ``ops.rwkv6`` (the kernel when ``impl='cuda'``)."""
    x = L.embed(local.take(params, ("embed",)), inputs["tokens"])
    for i in range(cfg.n_layers):
        x, _ = _block(local.take(params, ("layers",), (i,)), cfg, x, tp,
                      impl, layer=i)
    x = L.rms_norm(x, params["final_norm"])
    return L.unembed(local.take(params, ("head",)), x, cfg.vocab)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, tp: int = 1,
               dtype=None, device="cuda") -> Params:
    """The recurrent state of ``batch`` slots (``max_seq`` is unused: the
    state has no sequence axis); the token-shift carries in ``dtype``
    (default the config's), the WKV state in float32."""
    dtype = dtype or getattr(torch, cfg.dtype)
    h, dh, n = _heads(cfg, tp), cfg.rwkv_head_dim, cfg.n_layers
    return {
        "wkv": torch.zeros((n, batch, h, dh, dh), device=device),
        "shift_t": torch.zeros((n, batch, cfg.d_model), dtype=dtype,
                               device=device),
        "shift_c": torch.zeros((n, batch, cfg.d_model), dtype=dtype,
                               device=device),
    }


def cache_specs(cfg: ModelConfig) -> Params:
    return {"wkv": P(None, L.BATCH_AXES, TP, None, None),
            "shift_t": P(None, L.BATCH_AXES, None),
            "shift_c": P(None, L.BATCH_AXES, None)}


def init_prefill_cache(cfg: ModelConfig, batch: int, seq: int, tp: int = 1,
                       dtype=None, device="cuda") -> Params:
    """Batch-1 prefill state: the recurrence is O(1) in sequence length, so
    the prefill cache IS the slot state."""
    return init_cache(cfg, batch, seq, tp, dtype, device)


def pack_slot_cache(cfg: ModelConfig, pcache: Params, max_seq: int,
                    seq_len: int) -> Params:
    """Identity: recurrent state has no sequence axis.  A fresh admission
    writes this state over the slot wholesale, which is exactly the
    per-slot state reset this family needs instead of position zeroing."""
    if seq_len > max_seq:
        raise ValueError(f"prompt length {seq_len} exceeds max_seq {max_seq}")
    return pcache


def cache_slot_axes(cfg: ModelConfig) -> Params:
    """Batch(=slot)-axis index of every cache leaf (serving scatter map)."""
    return {"wkv": 1, "shift_t": 1, "shift_c": 1}


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, pos, *, tp: int = 1, impl="cuda",
                row_map=None) -> tuple[torch.Tensor, Params]:
    """State-carried step, O(1) in context length.  ``tokens`` may be
    (B, 1) (decode: the einsum step) or (B, S) (slot prefill: the kernel);
    ``pos`` is accepted for API uniformity but unused, since the recurrent
    state, not a position, carries the history; ``row_map`` is likewise
    accepted and ignored (no leaf is paged).  The cache is written in place
    and returned."""
    x = L.embed(local.take(params, ("embed",)), tokens)
    for i in range(cfg.n_layers):
        st = layer(cache, i)
        x, new = _block(local.take(params, ("layers",), (i,)), cfg, x, tp,
                        impl, state=st, layer=i)
        for name, t in new.items():
            st[name].copy_(t)
    x = L.rms_norm(x, params["final_norm"])
    return L.unembed(local.take(params, ("head",)), x, cfg.vocab), cache


def init_paged_cache(cfg: ModelConfig, slots: int, rows: int, max_seq: int,
                     tp: int = 1, dtype=None, device="cuda") -> Params:
    """Paged-API alias: recurrent state is O(1) per slot, so there is
    nothing to page; the family joins the paged engine with zero pool rows
    and the same per-slot state as the dense engine."""
    return init_cache(cfg, slots, max_seq, tp, dtype, device)


def paged_cache_specs(cfg: ModelConfig) -> Params:
    """The paged cache is the dense cache, so are its specs."""
    return cache_specs(cfg)


def paged_slot_axes(cfg: ModelConfig) -> Params:
    """No pooled leaves: every leaf is per-slot, as in
    :func:`cache_slot_axes`."""
    return cache_slot_axes(cfg)


def pack_paged_slot(cfg: ModelConfig, pcache: Params, max_seq: int,
                    seq_len: int) -> Params:
    """Identity, as :func:`pack_slot_cache` (no sequence axis)."""
    return pack_slot_cache(cfg, pcache, max_seq, seq_len)

