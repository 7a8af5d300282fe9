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
A paged KV pool (:func:`init_paged_kv_pool`) holds one scratch row past
the rows a page table can map: every write that the reference drops
(``mode="drop"``) lands there instead, so the scatter keeps a fixed shape.
Under a device mesh (the ambient mesh of ``distributed.context.use_mesh``)
every layer computes on this rank's compute view of its params
(``distributed.local``): heads, ``d_ff``, the vocab and the experts are
split over 'model', and the layers add the collectives that GSPMD inserts
in the reference: column-parallel ``wq``/``wk``/``wv``/``w_gate``/``w_up``,
row-parallel ``wo``/``w_down`` summed over 'model', a vocab-parallel
embedding and head, experts over 'model'.  Each ``*_specs`` function gives
the reference's spec tree of its ``*_init``.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import local
from repro_torch.distributed.sharding import BATCH_AXES, FSDP, TP, P
from repro_torch.kernels import ops
from .config import ModelConfig

Params = dict[str, Any]

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


def embed_specs() -> Params:
    # vocab over TP, d_model over FSDP
    return {"table": P(TP, FSDP)}


def segment_sum_rows(grad: torch.Tensor, ids: torch.Tensor,
                     rows: int) -> torch.Tensor:
    """``out[r] = sum of grad[i] over i with ids[i] == r``, (rows, d), in
    an order fixed by the data alone: a stable sort of the ids puts each
    row's contributions in one run, in their original order, and each run
    is summed by a pairwise tree (at level ``s`` the element at in-run
    position ``j``, ``j % 2s == 0``, adds the one at ``j + s``).  No atomic
    adds (``index_add_``, ``index_put_(accumulate=True)`` and
    ``scatter_add_`` use them on the card), so the same inputs give the same
    bits on every call, on the CPU and on the card.  Sums in float32.

    Every tensor has a shape fixed by ``ids``'s: the levels run up to the
    longest possible run (``ceil(log2(len(ids)))``, a level past the
    longest actual run adds nothing), so the host never waits for the
    card."""
    d = grad.shape[-1]
    ids = ids.reshape(-1)
    n = ids.numel()
    vals = grad.reshape(-1, d).float()
    ids_sorted, order = torch.sort(ids, stable=True)
    vals = vals[order]
    at = torch.arange(n, device=ids.device)
    first = torch.ones(n, dtype=torch.bool, device=ids.device)
    first[1:] = ids_sorted[1:] != ids_sorted[:-1]
    # each element's position in its run: its index less its run's start
    pos = at - torch.cummax(torch.where(first, at, 0), 0).values
    stride = 1
    while stride < n:
        nxt = (at + stride).clamp(max=n - 1)
        recv = ((pos % (2 * stride)) == 0) & (at + stride < n) \
            & (ids_sorted[nxt] == ids_sorted)
        vals = torch.where(recv[:, None], vals + vals[nxt], vals)
        stride *= 2
    # each run's first element holds its sum: write it to its row, every
    # other element to a scratch row past the table
    out = vals.new_zeros((rows + 1, d))
    out[torch.where(first, ids_sorted, rows)] = vals
    return out[:rows]


class _Gather(torch.autograd.Function):
    """``table[ids]`` whose backward is :func:`segment_sum_rows`: the
    gradient of the table is bit-stable from call to call (the plain
    gather's backward accumulates repeated ids in a varying order)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows, ctx.dtype = table.shape[0], table.dtype
        return table[ids]

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return segment_sum_rows(grad, ids, ctx.rows).to(ctx.dtype), None


def embed(params: Params, tokens: torch.Tensor,
          scale: bool = False) -> torch.Tensor:
    """The rows of ``table`` at ``tokens``.  Under a mesh whose 'model'
    axis is T > 1 the table is this rank's vocab shard: a masked local
    lookup, then a sum over 'model' (every other rank adds zeros)."""
    table = params["table"]
    tp = local.tp_group()
    if tp is None:
        out = _Gather.apply(table, tokens)
    else:
        lo = tp.rank * table.shape[0]
        mine = (tokens >= lo) & (tokens < lo + table.shape[0])
        ids = torch.where(mine, tokens - lo, 0)
        out = _Gather.apply(table, ids) * mine[..., None].to(table.dtype)
        out = local.row_out(out)
    if scale:
        out = out * math.sqrt(out.shape[-1])
    return out


def unembed(params: Params, x: torch.Tensor, vocab: int,
            cap: float = 0.0) -> torch.Tensor:
    """Logits over the (padded) vocab.  Under a 'model' axis the table is
    this rank's vocab shard: local logits, then an all-gather on the
    vocab."""
    x = local.column_in(x)
    logits = x @ params["table"].T
    logits = softcap(logits, cap)
    rows = params["table"].shape[0]
    tp = local.tp_group()
    lo = 0 if tp is None else tp.rank * rows
    if lo + rows > vocab:  # padded vocab rows never win
        mask = torch.arange(lo, lo + rows, device=x.device) < vocab
        logits = torch.where(mask, logits, -1e30)
    return local.gather_from_model(logits, -1)


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


def attn_specs(cfg: ModelConfig) -> Params:
    p = {"wq": P(FSDP, TP), "wk": P(FSDP, TP), "wv": P(FSDP, TP),
         "wo": P(TP, FSDP)}
    if cfg.qk_norm:
        p["q_norm"] = P(None)
        p["k_norm"] = P(None)
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


def gather_pages(pool: torch.Tensor, row_map: torch.Tensor) -> torch.Tensor:
    """Page-table gather: physical pool ``(R, ...)`` -> per-slot dense view
    ``(B, L, ...)`` where row ``i`` of slot ``b`` is ``pool[row_map[b, i]]``.
    Unmapped rows (``-1``) read as zeros, so the view is bit-identical to
    the dense ``(B, L, ...)`` cache layout the non-paged engine carries."""
    row_map = torch.as_tensor(row_map).to(pool.device).long()
    valid = row_map >= 0
    rows = pool[torch.where(valid, row_map, 0)]
    valid = valid.reshape(row_map.shape + (1,) * (pool.dim() - 1))
    return torch.where(valid, rows, torch.zeros((), dtype=pool.dtype,
                                                device=pool.device))


def _pool_rows(row_map, cpos: torch.Tensor, s: int,
               scratch: int) -> torch.Tensor:
    """Physical pool rows of the ``s`` logical rows each slot writes from
    ``cpos``, (B, s) on the host.  Rows past the page table (a parked
    slot) and unmapped (negative) entries go to the pool's scratch row
    ``scratch``: left as they are, they would wrap onto the pool's last
    rows, as they do under the reference's ``mode="drop"``."""
    rm = torch.as_tensor(row_map).cpu().long()
    rows = cpos[:, None] + torch.arange(s)
    prow = rm.gather(1, rows.clamp(0, rm.shape[1] - 1))
    return torch.where((rows < rm.shape[1]) & (prow >= 0), prow, scratch)


# the pool's scratch row is its last (init_paged_kv_pool), so index -1
# names it in every pool, whatever its size
SCRATCH_ROW = -1


class PageTable(NamedTuple):
    """One step's page table on the card, shared by every paged layer:
    ``map`` (B, L) the pool row of each logical row (-1 unmapped), and
    ``write`` (B, S) the pool rows the step's S tokens land on (dropped
    writes on :data:`SCRATCH_ROW`)."""
    map: torch.Tensor
    write: torch.Tensor


def page_table(row_map, cpos: torch.Tensor, s: int, device) -> PageTable:
    """The :class:`PageTable` of a step writing ``s`` tokens per slot at
    host positions ``cpos`` through host ``row_map`` ((B, L) ints)."""
    rm = torch.as_tensor(row_map).cpu().long()
    return PageTable(_to_device(rm, device), _to_device(
        _pool_rows(rm, cpos, s, SCRATCH_ROW), device))


def attention(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
              positions: torch.Tensor, tp: int = 1, impl: str = "cuda",
              window: int = 0, cache: Params | None = None,
              cache_pos=None, pages: PageTable | None = None,
              scale: float | None = None):
    """Returns (out, cache).  cache = {'k','v'}: (B, S_max, KV, hd), written
    in place at ``cache_pos`` (per slot, (B,); a scalar broadcasts); or,
    when ``pages`` is given and the leaves are 3-D, a paged physical pool
    (R + 1, KV, hd) written and read through the page table.  Ring leaves
    stay dense, so one model can mix both.  x may be wider than d_model
    (``wq``'s rows say how wide: zamba2's concatenated input); ``scale``
    multiplies the scores (default hd^-0.5)."""
    pd = cfg.padded(tp)
    t = local.tp_degree()                   # this rank's 1/t of the heads
    h, kv, hd = pd.n_heads // t, pd.n_kv_heads // t, cfg.head_dim

    x = local.column_in(x)
    q = _split_heads(x @ params["wq"], h, hd)
    k = _split_heads(x @ params["wk"], kv, hd)
    v = _split_heads(x @ params["wv"], kv, hd)
    if cfg.qk_norm:
        # one weight for every head, and this rank sees its own heads:
        # under a 'model' axis its gradient is summed over the ranks
        q = rms_norm(q, local.copy_to_model(params["q_norm"]))
        k = rms_norm(k, local.copy_to_model(params["k_norm"]))
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if cache is not None:
        # decode: insert current k/v, attend over the prefix.  Sliding-window
        # layers may carry a ring buffer of `window` slots (slot = pos % W).
        paged = pages is not None and cache["k"].dim() == 3
        cache_len = pages.map.shape[1] if paged else cache["k"].shape[1]
        ring = not paged and window > 0 and cache_len == window
        bsz, sq = q.shape[0], q.shape[1]
        cpos = _positions_host(cache_pos, bsz)
        dev = x.device
        kept = min(sq, window) if ring else sq

        if paged:
            # every lane writes: dropped rows land on the scratch row
            def put(name, val):
                cache[name][pages.write] = val.to(cache[name].dtype)

            def full(name):
                return gather_pages(cache[name], pages.map)
        else:
            # rows each slot writes; a row past the cache (a retired slot
            # parked at max_seq) is dropped, as the reference's mode="drop"
            # does -- torch indexing would raise, or wrap a negative index
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

            def full(name):
                return cache[name]

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
            ck = full("k").float() * full("k_scale")[..., None]
            cv = full("v").float() * full("v_scale")[..., None]
        else:
            put("k", k)
            put("v", v)
            ck, cv = full("k"), full("v")

        last = cpos + sq - 1                                 # (B,)
        if ring:
            slots = torch.arange(cache_len)
            kpos = last[:, None] - torch.remainder(last[:, None] - slots,
                                                   window)
            out = _decode_attention(q, ck, cv, cfg, _to_device(last, dev),
                                    0, kpos=_to_device(kpos, dev),
                                    scale=scale)
        else:
            out = _decode_attention(q, ck, cv, cfg, _to_device(last, dev),
                                    window, scale=scale)
    else:
        out = op(impl, "attention")(q, k, v, causal=cfg.causal,
                                    softcap=cfg.attn_softcap, window=window,
                                    scale=scale)

    out = out.reshape(x.shape[0], x.shape[1], h * hd)
    return local.row_out(out @ params["wo"]), cache


def _decode_attention(q, ck, cv, cfg: ModelConfig, last_pos: torch.Tensor,
                      window: int, kpos: torch.Tensor | None = None,
                      scale: float | None = None):
    """Single/few-token query against a (partially filled) cache; positions
    beyond ``last_pos`` ((B,), per slot) are masked; ``kpos`` ((B, S_kv))
    overrides slot positions (ring-buffer caches); ``scale`` (default
    hd^-0.5) multiplies the scores."""
    b, sq, h, hd = q.shape
    skv, kvh = ck.shape[1], ck.shape[2]
    g = h // kvh
    dev = q.device
    qf = q.float().reshape(b, sq, kvh, g, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, ck.float())
    logits = logits * (hd ** -0.5 if scale is None else scale)
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


def kv_cache_specs(cfg: ModelConfig | None = None) -> Params:
    base = {"k": P(BATCH_AXES, None, TP, None),
            "v": P(BATCH_AXES, None, TP, None)}
    if cfg is not None and cfg.kv_int8:
        base["k_scale"] = P(BATCH_AXES, None, TP)
        base["v_scale"] = P(BATCH_AXES, None, TP)
    return base


def paged_kv_pool_specs(cfg: ModelConfig | None = None) -> Params:
    """Specs of :func:`init_paged_kv_pool` leaves (rows, kv_heads, hd):
    kv-heads over TP like the dense cache; the physical-row axis stays
    replicated (the host's page table addresses every row)."""
    base = {"k": P(None, TP, None), "v": P(None, TP, None)}
    if cfg is not None and cfg.kv_int8:
        base["k_scale"] = P(None, TP)
        base["v_scale"] = P(None, TP)
    return base


def init_paged_kv_pool(cfg: ModelConfig, rows: int, tp: int = 1,
                       dtype=torch.bfloat16, device="cuda") -> Params:
    """Physical KV pool of ``rows`` page-resident rows shared by every slot,
    plus one scratch row (index ``rows``) that takes the writes a page
    table does not map.  Same leaf set as :func:`init_kv_cache` minus the
    slot axis: the engine's page table supplies the slot -> row
    indirection."""
    pd = cfg.padded(tp)
    shape = (rows + 1, pd.n_kv_heads, cfg.head_dim)
    if cfg.kv_int8:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:2], device=device),
                "v_scale": torch.zeros(shape[:2], device=device)}
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


def mlp_specs() -> Params:
    return {"w_gate": P(FSDP, TP), "w_up": P(FSDP, TP),
            "w_down": P(TP, FSDP)}


def mlp(params: Params, x: torch.Tensor, gelu: bool = False) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    x = local.column_in(x)
    gate = x @ params["w_gate"]
    act = F.gelu(gate, approximate="tanh") if gelu else F.silu(gate)
    return local.row_out((act * (x @ params["w_up"])) @ params["w_down"])


# ---------------------------------------------------------------------------
# Mixture of Experts (top-k router, capacity dispatch)
# ---------------------------------------------------------------------------

def moe_init(gen, cfg: ModelConfig, tp: int, dtype, device) -> Params:
    pd = cfg.padded(tp)
    e, d, f = pd.n_experts, cfg.d_model, cfg.moe_d_ff
    # padded experts are routed -inf -> never selected (exact)
    mask = torch.where(torch.arange(e, device=device) < cfg.n_experts,
                       0.0, -1e30)
    return {
        "router": _normal(gen, (d, e), d ** -0.5, torch.float32, device),
        "router_mask": mask,
        "w_gate": _normal(gen, (e, d, f), d ** -0.5, dtype, device),
        "w_up": _normal(gen, (e, d, f), d ** -0.5, dtype, device),
        "w_down": _normal(gen, (e, f, d), f ** -0.5, dtype, device),
    }


def moe_specs() -> Params:
    return {"router": P(None, TP), "router_mask": P(TP),
            "w_gate": P(TP, FSDP, None), "w_up": P(TP, FSDP, None),
            "w_down": P(TP, None, FSDP)}


def _dispatch_group(x2, logits, k: int, cap: int):
    """Group-local top-k routing + capacity scatter, for every group (the
    batch rows) at once.  x2: (B, T, d); logits: (B, T, E).  Returns (buf
    (B, E, cap, d), flat_e, slot, keep, gates)."""
    b, t, d = x2.shape
    e = logits.shape[-1]
    # jax.lax.top_k breaks ties towards the lower index: a stable
    # descending sort does too
    top_vals, top_idx = torch.sort(logits, dim=-1, descending=True,
                                   stable=True)
    top_vals, top_idx = top_vals[..., :k], top_idx[..., :k]  # (B, T, K)
    gates = torch.softmax(top_vals, dim=-1).to(x2.dtype)
    flat_e = top_idx.reshape(b, t * k)                     # token-major
    # position-within-expert via a stable sort's ranking
    sorted_e, order = torch.sort(flat_e, dim=-1, stable=True)
    start = torch.searchsorted(
        sorted_e, torch.arange(e, device=x2.device).repeat(b, 1))
    pos_sorted = torch.arange(t * k, device=x2.device) \
        - start.gather(1, sorted_e)
    mypos = torch.zeros_like(flat_e).scatter(1, order, pos_sorted)
    keep = (mypos < cap)[..., None].to(x2.dtype)
    slot = mypos.clamp(max=cap - 1)
    xrep = x2[:, :, None, :].expand(b, t, k, d).reshape(b, t * k, d)
    # a dropped token adds zeros onto slot cap - 1: the scatter must
    # accumulate, or it would overwrite the kept token there
    g_idx = torch.arange(b, device=x2.device)[:, None].expand(b, t * k)
    buf = x2.new_zeros((b, e, cap, d)).index_put_(
        (g_idx, flat_e, slot), xrep * keep, accumulate=True)
    return buf, flat_e, slot, keep, gates


def moe(params: Params, cfg: ModelConfig, x: torch.Tensor,
        tp: int = 1) -> torch.Tensor:
    """Grouped capacity-dispatch MoE: routing, ranking and the capacity
    scatter run per batch row (a group), the expert products over every
    group's (E, cap) buffer.  FLOPs scale with top_k·T (capacity
    ``capacity_factor``), not E·T; ``cap`` depends on the sequence length,
    so a prompt prefilled in chunks may drop other tokens than prefilled
    whole.

    Under a 'model' axis each rank holds ``E / T`` experts and their
    router columns: the router's logits are all-gathered so that every
    rank routes alike, each rank runs its own experts on their slice of the
    dispatch buffer, and the combined outputs are summed over 'model'."""
    x = local.column_in(x)
    b, s, d = x.shape
    e_local = params["w_gate"].shape[0]
    tp = local.tp_group()
    lo = 0 if tp is None else tp.rank * e_local
    e = e_local * (1 if tp is None else tp.size)
    k = cfg.top_k
    cap = max(8, int(math.ceil(s * k / e * cfg.capacity_factor)))

    logits = local.gather_partial(
        x.float() @ params["router"] + params["router_mask"], -1)
    buf, flat_e, slot, keep, gates = _dispatch_group(x, logits, k, cap)
    if tp is not None:
        buf = buf[:, lo:lo + e_local]
        mine = (flat_e >= lo) & (flat_e < lo + e_local)
        keep = keep * mine[..., None].to(keep.dtype)
        flat_e = torch.where(mine, flat_e - lo, 0)
    if cfg.moe_int8_dispatch:
        # the dispatch buffer quantized to int8 as the reference does
        scale = torch.amax(torch.abs(buf.float()), dim=-1,
                           keepdim=True) / 127.0 + 1e-12
        q = torch.round(buf.float() / scale).to(torch.int8)
        buf = (q.float() * scale).to(x.dtype)
    h = (F.silu(torch.einsum("becd,edf->becf", buf, params["w_gate"]))
         * torch.einsum("becd,edf->becf", buf, params["w_up"]))
    out_buf = torch.einsum("becf,efd->becd", h, params["w_down"])
    g_idx = torch.arange(b, device=x.device)[:, None]
    out_tok = out_buf[g_idx, flat_e, slot] * keep          # (B, S*K, d)
    out = (out_tok.reshape(b, s, k, d) * gates[..., None]).sum(dim=2)
    return local.row_out(out.to(x.dtype))
