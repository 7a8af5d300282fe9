"""Shared layer library of the transformer family, in PyTorch.

Port of ``repro/models/layers.py``.  Conventions kept from it:
  * params are nested dicts of tensors with the reference's names and
    layouts (``x @ w`` weights are (in, out)), so the reference's params,
    as numpy arrays, load through ``tree.params_from_numpy``;
  * ``tp`` pads heads and vocab exactly as the reference does (1 on one
    card);
  * ``impl`` selects the kernels of every family (:func:`op`): 'cuda'
    (the hand-written kernels; CUDA tensors), 'torch' (the plain versions;
    CPU tensors), or a namespace of functions, such as ``kernels.plain``
    to run the plain versions on the card for comparison.  The
    transformer's decode path is plain tensor code either way, as in the
    reference.
  * float32 upcasts and downcasts sit exactly where the reference has them
    (norms, rope, softcap, attention), so bfloat16 runs round alike.

The KV cache is updated in place (the reference returns a new cache): a
decode step writes one row per slot instead of copying the whole cache.
Not ported yet: the MoE layer and the paged KV pool (``gather_pages`` and
the ``row_map`` branch), ROADMAP A.5.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from .config import ModelConfig

Params = dict[str, Any]

_DEFERRED = "not ported yet (ROADMAP A.5: {what})"


def deferred(item: str, what: str):
    """A stand-in for a function of the reference not ported yet: calling
    it raises, naming the ROADMAP item that holds it."""
    def fn(*args, **kwargs):
        raise NotImplementedError(f"not ported yet (ROADMAP {item}: {what})")
    return fn


def op(impl, name: str):
    """The function that runs kernel op ``name`` ('attention', 'rwkv6',
    'mamba2') under ``impl``: a string is an implementation of
    ``kernels.ops`` ('cuda' or 'torch', which check the tensors' device);
    anything else is a namespace whose attribute ``name`` is used as it
    is (``kernels.plain``)."""
    if isinstance(impl, str):
        return partial(getattr(ops, name), implementation=impl)
    return getattr(impl, name)


def _normal(gen: torch.Generator, shape, scale: float, dtype,
            device) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms / activations / rope
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if plus_one else w.float()
    return (xf * scale).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, D) rotary on last dim; positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs              # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def embed_init(gen, cfg: ModelConfig, tp: int, dtype, device) -> Params:
    v = cfg.padded(tp).vocab
    return {"table": _normal(gen, (v, cfg.d_model), 0.02, dtype, device)}


def embed(params: Params, tokens: torch.Tensor,
          scale: bool = False) -> torch.Tensor:
    out = params["table"][tokens]
    if scale:
        out = out * math.sqrt(out.shape[-1])
    return out


def unembed(params: Params, x: torch.Tensor, vocab: int,
            cap: float = 0.0) -> torch.Tensor:
    logits = x @ params["table"].T
    logits = softcap(logits, cap)
    v_pad = params["table"].shape[0]
    if v_pad > vocab:  # padded vocab rows never win
        mask = torch.arange(v_pad, device=x.device) < vocab
        logits = torch.where(mask, logits, -1e30)
    return logits


# ---------------------------------------------------------------------------
# Dense attention (GQA + qk-norm + softcap + sliding window + KV cache)
# ---------------------------------------------------------------------------

def attn_init(gen, cfg: ModelConfig, tp: int, dtype, device) -> Params:
    pd = cfg.padded(tp)
    d, hd = cfg.d_model, cfg.head_dim
    h, kv = pd.n_heads, pd.n_kv_heads
    sc = d ** -0.5
    p = {
        "wq": _normal(gen, (d, h * hd), sc, dtype, device),
        "wk": _normal(gen, (d, kv * hd), sc, dtype, device),
        "wv": _normal(gen, (d, kv * hd), sc, dtype, device),
        "wo": _normal(gen, (h * hd, d), (h * hd) ** -0.5, dtype, device),
    }
    # zero the padded q-heads' output rows -> exact at initialization
    if h > cfg.n_heads:
        mask = (torch.arange(h, device=device) < cfg.n_heads) \
            .repeat_interleave(hd)[:, None]
        p["wo"] = (p["wo"] * mask).to(dtype)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def _split_heads(x, n, hd):
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd)


def _positions_host(cache_pos, bsz: int) -> torch.Tensor:
    """Per-slot write positions as a (B,) int64 CPU tensor (a scalar
    broadcasts).  They are host data in the serving engine: the index
    arithmetic stays on the host and its results reach the card through
    :func:`_to_device`, so the host never waits for the card mid-step."""
    return torch.as_tensor(cache_pos, dtype=torch.int64).cpu() \
        .reshape(-1).expand(bsz).clone()


def _to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device`` without waiting for the work queued
    there (a blocking copy to the card synchronises its stream; the
    non-blocking one stages the pageable source before returning)."""
    return t.to(device, non_blocking=True)


def gather_pages(pool: torch.Tensor, row_map: torch.Tensor):
    raise NotImplementedError(_DEFERRED.format(what="paged KV pool"))


def attention(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
              positions: torch.Tensor, tp: int = 1, impl: str = "cuda",
              window: int = 0, cache: Params | None = None,
              cache_pos=None, row_map=None):
    """Returns (out, cache).  cache = {'k','v'}: (B, S_max, KV, hd), written
    in place at ``cache_pos`` (per slot, (B,); a scalar broadcasts)."""
    if row_map is not None:
        raise NotImplementedError(_DEFERRED.format(what="paged KV pool"))
    pd = cfg.padded(tp)
    h, kv, hd = pd.n_heads, pd.n_kv_heads, cfg.head_dim

    q = _split_heads(x @ params["wq"], h, hd)
    k = _split_heads(x @ params["wk"], kv, hd)
    v = _split_heads(x @ params["wv"], kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if cache is not None:
        # decode: insert current k/v, attend over the prefix.  Sliding-window
        # layers may carry a ring buffer of `window` slots (slot = pos % W).
        cache_len = cache["k"].shape[1]
        ring = window > 0 and cache_len == window
        bsz, sq = q.shape[0], q.shape[1]
        cpos = _positions_host(cache_pos, bsz)
        dev = x.device

        # rows each slot writes; a row past the cache (a retired slot
        # parked at max_seq) is dropped, as the reference's mode="drop"
        # does -- torch indexing would raise, or wrap a negative index
        kept = min(sq, window) if ring else sq
        rows = cpos[:, None] + (sq - kept) + torch.arange(kept)
        if ring:
            rows = rows % window
        valid = (rows >= 0) & (rows < cache_len)
        b_sel, t_sel = (_to_device(i, dev)
                        for i in valid.nonzero(as_tuple=True))
        r_sel = _to_device(rows[valid], dev)

        def put(name, val):
            val = val[:, sq - kept:]     # a full ring wrap keeps the tail
            cache[name][b_sel, r_sel] = val[b_sel, t_sel].to(
                cache[name].dtype)

        if "k_scale" in cache:   # int8 KV: per-(token, head) scales
            def quant(z):
                sc = torch.amax(torch.abs(z.float()), dim=-1,
                                keepdim=True) / 127.0 + 1e-12
                return torch.round(z.float() / sc).to(torch.int8), sc[..., 0]
            kq, ks = quant(k)
            vq, vs = quant(v)
            put("k", kq)
            put("v", vq)
            put("k_scale", ks)
            put("v_scale", vs)
            ck = cache["k"].float() * cache["k_scale"][..., None]
            cv = cache["v"].float() * cache["v_scale"][..., None]
        else:
            put("k", k)
            put("v", v)
            ck, cv = cache["k"], cache["v"]

        last = cpos + sq - 1                                 # (B,)
        if ring:
            slots = torch.arange(cache_len)
            kpos = last[:, None] - torch.remainder(last[:, None] - slots,
                                                   window)
            out = _decode_attention(q, ck, cv, cfg, _to_device(last, dev),
                                    0, kpos=_to_device(kpos, dev))
        else:
            out = _decode_attention(q, ck, cv, cfg, _to_device(last, dev),
                                    window)
    else:
        out = op(impl, "attention")(q, k, v, causal=cfg.causal,
                                    softcap=cfg.attn_softcap, window=window)

    out = out.reshape(x.shape[0], x.shape[1], h * hd)
    return out @ params["wo"], cache


def _decode_attention(q, ck, cv, cfg: ModelConfig, last_pos: torch.Tensor,
                      window: int, kpos: torch.Tensor | None = None):
    """Single/few-token query against a (partially filled) cache; positions
    beyond ``last_pos`` ((B,), per slot) are masked; ``kpos`` ((B, S_kv))
    overrides slot positions (ring-buffer caches)."""
    b, sq, h, hd = q.shape
    skv, kvh = ck.shape[1], ck.shape[2]
    g = h // kvh
    dev = q.device
    qf = q.float().reshape(b, sq, kvh, g, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, ck.float())
    logits = logits * hd ** -0.5
    logits = softcap(logits, cfg.attn_softcap)
    kpos = (torch.arange(skv, device=dev).expand(b, skv) if kpos is None
            else kpos.expand(b, skv))[:, None, :]           # (B, 1, Skv)
    qpos = (last_pos[:, None] - (sq - 1)
            + torch.arange(sq, device=dev))[..., None]      # (B, Sq, 1)
    mask = (kpos <= qpos) & (kpos >= 0)                     # (B, Sq, Skv)
    if window > 0:
        mask &= kpos > qpos - window
    logits = torch.where(mask[:, None, None], logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, cv.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, tp: int = 1,
                  dtype=torch.bfloat16, device="cuda") -> Params:
    """bfloat16 by default whatever ``cfg.dtype`` is, as in the reference."""
    pd = cfg.padded(tp)
    shape = (batch, max_seq, pd.n_kv_heads, cfg.head_dim)
    if cfg.kv_int8:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], device=device),
                "v_scale": torch.zeros(shape[:3], device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def mlp_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": _normal(gen, (d, f), d ** -0.5, dtype, device),
            "w_up": _normal(gen, (d, f), d ** -0.5, dtype, device),
            "w_down": _normal(gen, (f, d), f ** -0.5, dtype, device)}


def mlp(params: Params, x: torch.Tensor, gelu: bool = False) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    gate = x @ params["w_gate"]
    act = F.gelu(gate, approximate="tanh") if gelu else F.silu(gate)
    return (act * (x @ params["w_up"])) @ params["w_down"]


def moe(params: Params, cfg: ModelConfig, x: torch.Tensor, tp: int):
    raise NotImplementedError(_DEFERRED.format(what="MoE layer"))
