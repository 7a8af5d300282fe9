"""RWKV-6 "Finch" LM (rwkv6-3b) in PyTorch: attention-free, with a
data-dependent per-channel decay.

Port of ``repro/models/rwkv6.py`` with its parameter layout (blocks stacked
on a leading axis) and its simplification: the token-shift mixing
coefficients are static per-channel ``mu`` rather than data-dependent
ddlerp.  Block = time-mix (the WKV recurrence through ``ops.rwkv6``, the
CUDA kernel with ``impl='cuda'``) + channel-mix.  Cast points kept from the
reference: the log-decay is computed in float32 and cast to x's dtype
before the kernel, ``u`` goes in its parameter dtype, and the one-token
decode step keeps the log-decay in float32 and runs the recurrence step as
einsums (no kernel launch).

The cache is the recurrent state, O(1) in sequence length, written in
place.  Not ported (ROADMAP A.6): the paged-cache aliases and the
tensor-parallel specs; they raise.
"""
from __future__ import annotations

from functools import partial
from typing import Any

import torch
import torch.nn.functional as F

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


def _shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """Token shift: x_{t-1}, with ``prev`` as the carry for decode."""
    if x.shape[1] == 1 and prev is not None:
        return prev[:, None, :]
    pad = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None, :]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _time_mix(p: Params, cfg: ModelConfig, x, tp: int, impl,
              wkv_state=None, shift_prev=None):
    b, s, _ = x.shape
    dh = cfg.rwkv_head_dim
    h = _heads(cfg, tp)
    xp = _shift(x, shift_prev)
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xg, xw = (x + (xp - x) * mu[i] for i in range(5))

    r = (xr @ p["wr"]).reshape(b, s, h, dh)
    k = (xk @ p["wk"]).reshape(b, s, h, dh)
    v = (xv @ p["wv"]).reshape(b, s, h, dh)
    g = F.silu(xg @ p["wg"])
    # data-dependent decay (Finch): log-decay = -exp(w0 + lora(x_w)) <= 0
    lora = torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    logw = -torch.exp(torch.clamp((p["w0"] + lora).float(), -8.0, 6.0))
    logw = logw.reshape(b, s, h, dh)

    if s == 1:
        # decode fast path: one recurrence step, no kernel launch
        st = wkv_state if wkv_state is not None else torch.zeros(
            (b, h, dh, dh), device=x.device)
        r1, k1, v1 = (z[:, 0].float() for z in (r, k, v))
        kv = k1[..., :, None] * v1[..., None, :]
        u_f = p["u"].float()
        o1 = torch.einsum("bhk,bhkv->bhv", r1, st + u_f[None, :, :, None] * kv)
        new_state = torch.exp(logw[:, 0])[..., None] * st + kv
        out = o1[:, None].to(x.dtype)
    else:
        out, new_state = L.op(impl, "rwkv6")(r, k, v, logw.to(x.dtype),
                                             p["u"], wkv_state)
    # per-head group norm, then gate and project
    out = L.rms_norm(out, p["ln_x"])
    out = out.reshape(b, s, h * dh) * g
    return out @ p["wo"], new_state, x[:, -1]


def _channel_mix(p: Params, x, shift_prev=None):
    xp = _shift(x, shift_prev)
    mu = p["mu_c"].to(x.dtype)
    xk = x + (xp - x) * mu[0]
    xr = x + (xp - x) * mu[1]
    hidden = torch.square(F.relu(xk @ p["wck"]))
    return torch.sigmoid(xr @ p["wcr"]) * (hidden @ p["wcv"]), x[:, -1]


def _block(p: Params, cfg: ModelConfig, x, tp, impl, state=None):
    st = state or {}
    att, wkv, sh_t = _time_mix(p, cfg, L.rms_norm(x, p["ln1"]), tp, impl,
                               st.get("wkv"), st.get("shift_t"))
    x = x + att
    cm, sh_c = _channel_mix(p, L.rms_norm(x, p["ln2"]), st.get("shift_c"))
    return x + cm, {"wkv": wkv, "shift_t": sh_t, "shift_c": sh_c}


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


def forward(params: Params, cfg: ModelConfig, inputs: Params, *,
            tp: int = 1, impl="cuda") -> torch.Tensor:
    """Full-sequence forward -> logits; every layer's recurrence goes
    through ``ops.rwkv6`` (the kernel when ``impl='cuda'``)."""
    x = L.embed(params["embed"], inputs["tokens"])
    for i in range(cfg.n_layers):
        x, _ = _block(layer(params["layers"], i), cfg, x, tp, impl)
    x = L.rms_norm(x, params["final_norm"])
    return L.unembed(params["head"], x, cfg.vocab)


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
    state, not a position, carries the history.  The cache is written in
    place and returned."""
    if row_map is not None:
        raise NotImplementedError("not ported yet (ROADMAP A.6: paged cache)")
    x = L.embed(params["embed"], tokens)
    for i in range(cfg.n_layers):
        st = layer(cache, i)
        x, new = _block(layer(params["layers"], i), cfg, x, tp, impl,
                        state=st)
        for name, t in new.items():
            st[name].copy_(t)
    x = L.rms_norm(x, params["final_norm"])
    return L.unembed(params["head"], x, cfg.vocab), cache


specs = cache_specs = L.deferred("A.6", "tensor-parallel specs")
init_paged_cache = paged_cache_specs = paged_slot_axes = pack_paged_slot = \
    L.deferred("A.6", "paged cache")
