"""Zamba2 hybrid LMs in PyTorch: a Mamba-2 backbone with shared attention
blocks, in two forms.

**zamba2-2.7b as the port runs it** (``attn_every``): the port of
``repro/models/zamba2.py`` with its parameter layout (Mamba blocks stacked
on two leading axes, (groups, per group)) and its simplifications: one
shared block applied after every ``attn_every`` Mamba layers with residual
adds, on the hidden state only, no per-call adapters, one B/C group.

**The published form** (``hybrid_layer_ids``; Zamba2-7B, arXiv:2411.15242,
its ``config.json`` and ``modeling_zamba2.py``): a list of ``n_layers``
Mamba layers, stacked on one leading axis.  Before each hybrid layer j
(the j-th id of ``hybrid_layer_ids``) shared block ``j % shared_blocks``
runs on the hidden state x concatenated with the embedding output x0:

    s = norm(concat(x, x0))            (2d wide)
    a = attention(s)                   (q, k, v 2d -> heads x head_dim,
                                        RoPE over the whole head, scale
                                        (head_dim / 2)^-0.5, o -> d)
    [g | u] = W_gu n + A_j(n),  n = norm(a)   (A_j: hybrid call j's own
                                        rank-``adapter_rank`` adapter)
    t = Linear_j(down(gelu(g) * u))    (exact GELU; no residual inside)

and every layer computes x = x + Mamba2(norm(x + t)), t = 0 on a layer
that is not hybrid.  The head is tied to the embedding; every RMS norm
takes ``norm_eps``.  Each block's weights are a subtree of their own
(``shared["0"]``, ``shared["1"]``: one block's is met 7 times a token, the
other's 6 in Zamba2-7B), each hybrid call's linear and adapter are stacked
on a leading axis (``hybrid``).

Mamba-2 mixer per layer: in_proj -> [z | x | B | C | dt], a short causal
depthwise conv on (x | B | C) with its carried tail, the SSD recurrence
through ``ops.mamba2`` (the CUDA kernel with ``impl='cuda'``) with per-head
scalar decay a = dt * (-exp(A_log)), the D skip, silu(z) gating, RMS norm
(over each of ``ssm_groups`` groups of the inner width), out_proj.  The
work around the two products and the SSD is three glue ops
(``ops.mamba2_norm_in``, ``mamba2_conv_in``, ``mamba2_gate_out``: one
kernel each with ``impl='cuda'``, ``kernels/mamba2_glue.py``).  B and
C come in ``ssm_groups`` groups of ``ssm_state``, head h reading group h //
(heads / groups), and reach the kernel as (B, S, G, N) in one launch a
layer, one group (zamba2-2.7b's) too: every head reads it, where the
reference materialises it per head.  The shared block
reuses ``layers.attention``: in the full-sequence forward its attention is
the flash kernel (head_dim 80 in zamba2-2.7b, 224 in zamba2-7b).

Decode carries (conv tail, SSD state) per layer and the KV cache per
shared-block call, written in place.  The paged cache pools the
shared-attention KV and keeps the conv/SSD state per slot.

Spans (``repro_torch.obs``, on the whole-sequence forward only):
``zamba2.mamba`` around each Mamba layer (norm, mixer, residual) and
``zamba2.shared`` around each shared-block call; the counters
``zamba2.mamba_layers`` and ``zamba2.shared_calls`` count them.

Under a mesh each rank runs its own SSD heads.  ``in_proj``'s columns
``[z | x | B | C | dt]`` and the conv's channels ``[x | B | C]`` are
concatenations, so their compute view is taken segment by segment
(:func:`compute_segments`, the rule in ``distributed.local``): z, x and dt
by head, B and C (one group every head reads) whole.  B and C are then a
replicated computation that each rank reads for its own heads only, so
their gradient is summed over 'model' where they enter the SSD; and the
gated RMS norm over the whole ``hp`` sums its squares over 'model'.  Under
FSDP (``local.take``) ``in_proj`` is gathered over 'data' on its rows,
which the segments on its columns leave alone.  The published form (B/C
groups, the blocks' 2d-wide input, the adapters) has no sharding rule: it
raises under a mesh.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.distributed import context, local
from repro_torch.distributed.sharding import FSDP, TP, P, spec_map

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


def _published(cfg: ModelConfig) -> bool:
    return bool(cfg.hybrid_layer_ids)


def _n_calls(cfg: ModelConfig) -> int:
    """Shared-block calls a forward: one per hybrid layer (published form)
    or per group."""
    return len(cfg.hybrid_layer_ids) if _published(cfg) else _n_groups(cfg)


def _layer_shape(cfg: ModelConfig) -> tuple[int, ...]:
    """Leading axes of the stacked Mamba layers (and their states)."""
    if _published(cfg):
        return (cfg.n_layers,)
    g = _n_groups(cfg)
    return (g, cfg.n_layers // g)


def _no_mesh(cfg: ModelConfig) -> None:
    """The published form has no sharding rule: B/C groups (a rank would
    read some groups' heads only), the blocks' 2d-wide input, the adapters."""
    if _published(cfg) or cfg.ssm_groups > 1:
        raise ValueError(
            f"{cfg.name}: {cfg.ssm_groups} B/C groups and the published "
            f"shared blocks have no sharding rule; run it without a mesh")


def _mamba_init(gen, cfg: ModelConfig, tp: int, dtype, device) -> Params:
    d = cfg.d_model
    _, h, n = _dims(cfg, tp)
    hp = h * cfg.ssm_head_dim              # padded inner width
    n = cfg.ssm_groups * n                 # B (and C) columns, every group
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


def _mamba_specs() -> Params:
    return {
        "ln": P(None), "in_proj": P(FSDP, TP),
        "conv_w": P(None, TP), "conv_b": P(TP),
        "a_log": P(TP), "dt_bias": P(TP), "d_skip": P(TP),
        "norm": P(TP), "out_proj": P(TP, FSDP),
    }


def compute_segments(cfg: ModelConfig, tp: int) -> dict:
    """The concatenated dims (``distributed.local``): for each leaf path,
    the dim and its segments ``(length, split over 'model')``.  The conv
    tail of the cache runs over the conv's channels."""
    if tp > 1:
        _no_mesh(cfg)
    _, h, n = _dims(cfg, tp)
    hp = h * cfg.ssm_head_dim
    conv = (-1, [(hp, True), (n, False), (n, False)])
    return {("layers", "in_proj"): (-1, [(hp, True), (hp, True), (n, False),
                                         (n, False), (h, True)]),
            ("layers", "conv_w"): conv, ("layers", "conv_b"): conv,
            ("conv",): conv}


def _gated_norm_tp(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """``rms_norm(y * silu(z), w)`` over the whole ``hp`` when each rank
    holds ``1/T`` of it: the sum of squares is summed over 'model'."""
    g = y * F.silu(z)
    gf = g.float()
    ss = local.reduce_partial(torch.sum(gf * gf, dim=-1, keepdim=True))
    var = ss / (gf.shape[-1] * local.tp_degree())
    return (gf * torch.rsqrt(var + eps) * w.float()).to(g.dtype)


def _mamba_block(p: Params, cfg: ModelConfig, x, tp: int, impl,
                 state: Params | None = None, t=None):
    """x + Mamba2(norm(x + t)) (t: a hybrid call's output, else None) ->
    (x, new conv tail and SSD state).  The work around the two products
    and the SSD is three glue ops (``kernels.mamba2_glue``: one kernel each
    with ``impl='cuda'``); under a 'model' axis in_proj is split and the
    gated norm's squares are summed over ranks, so there the D skip and
    :func:`_gated_norm_tp` take the last op's place."""
    bsz, s, _ = x.shape
    _, h, n = _dims(cfg, tp)
    h //= local.tp_degree()                           # this rank's heads
    ph = cfg.ssm_head_dim
    hp = h * ph
    grp = cfg.ssm_groups
    st = state or {}
    mesh = local.tp_group() is not None

    xn = L.op(impl, "mamba2_norm_in")(x, t, p["ln"], cfg.norm_eps)
    w = p["in_proj"]
    if not mesh:
        zxbcdt = xn @ w
    else:
        # column-parallel z | x | dt; B | C a replicated product
        zx = local.column_in(xn) @ torch.cat([w[:, :2 * hp], w[:, -h:]], -1)
        zxbcdt = torch.cat([zx[..., :2 * hp], xn @ w[:, 2 * hp:-h],
                            zx[..., 2 * hp:]], -1)
    z = zxbcdt[..., :hp]
    xs, x_scaled, bmat, cmat, log_decay, new_tail = L.op(
        impl, "mamba2_conv_in")(zxbcdt, p["conv_w"], p["conv_b"],
                                p["dt_bias"], p["a_log"], st.get("conv"),
                                torch.float32 if s == 1 else x.dtype, grp)
    # (B, S, G, N); one group is read by this rank's heads only
    bmat, cmat = local.copy_to_model(bmat), local.copy_to_model(cmat)

    if s == 1:
        # decode fast path: one SSD recurrence step
        h0 = st.get("ssd")
        if h0 is None:
            h0 = torch.zeros((bsz, h, n, ph), device=x.device)
        xf = x_scaled[:, 0].float()
        bf, cf = (z[:, 0].float().repeat_interleave(h // z.shape[2], dim=1)
                  for z in (bmat, cmat))
        h1 = torch.exp(log_decay[:, 0])[..., None, None] * h0 \
            + bf[..., :, None] * xf[..., None, :]
        y = torch.einsum("bhn,bhnp->bhp", cf, h1)[:, None].to(x.dtype)
        new_ssd = h1
    else:
        y, new_ssd = L.op(impl, "mamba2")(x_scaled, log_decay, bmat, cmat,
                                          st.get("ssd"))

    if mesh:
        y = y + xs * p["d_skip"].to(x.dtype)[None, None, :, None]
        y = _gated_norm_tp(y.reshape(bsz, s, hp), z, p["norm"], cfg.norm_eps)
    else:
        y = L.op(impl, "mamba2_gate_out")(y, xs, z, p["d_skip"], p["norm"],
                                          grp, cfg.norm_eps)
    return x + local.row_out(y @ p["out_proj"]), {"conv": new_tail,
                                                  "ssd": new_ssd}


def _shared_attn(shared: Params, cfg: ModelConfig, x, *, positions, tp,
                 impl, cache=None, cache_pos=None, pages=None):
    """zamba2-2.7b's shared block as the port runs it: x + attention, then
    + MLP, both on the hidden state."""
    h = L.rms_norm(x, shared["ln_attn"])
    att, _ = L.attention(shared["attn"], cfg, h, positions=positions, tp=tp,
                         impl=impl, cache=cache, cache_pos=cache_pos,
                         pages=pages)
    x = x + att
    return x + L.mlp(shared["mlp"], L.rms_norm(x, shared["ln_mlp"]))


def _addmm_(out: torch.Tensor, a: torch.Tensor, w: torch.Tensor):
    """out += a @ w in place, one product over every leading dim."""
    out.view(-1, out.shape[-1]).addmm_(a.reshape(-1, a.shape[-1]), w)
    return out


def _hybrid_call(blk: Params, hyb: Params, cfg: ModelConfig, x, x0, *,
                 positions, tp, impl, cache=None, cache_pos=None,
                 pages=None):
    """The published form's shared block at one hybrid layer -> t, which
    joins that Mamba layer's normed input: attention on the normed
    concatenation of x and the embedding output x0, the MLP with this
    call's adapter on [gate | up], this call's linear."""
    eps = cfg.norm_eps
    s = L.rms_norm(torch.cat([x, x0], dim=-1), blk["ln_attn"], eps=eps)
    att, _ = L.attention(blk["attn"], cfg, s, positions=positions, tp=tp,
                         impl=impl, cache=cache, cache_pos=cache_pos,
                         pages=pages, scale=(cfg.head_dim / 2) ** -0.5)
    n = L.rms_norm(att, blk["ln_mlp"], eps=eps)
    mlp = blk["mlp"]
    low = n @ hyb["adapter_down"]
    gate = _addmm_(n @ mlp["w_gate"], low, hyb["adapter_gate"])
    up = _addmm_(n @ mlp["w_up"], low, hyb["adapter_up"])
    return (F.gelu(gate) * up) @ mlp["w_down"] @ hyb["linear"]


# ---------------------------------------------------------------------------
# Model: the Mamba layers and the shared blocks between them
# ---------------------------------------------------------------------------

def _shared_init(gen, cfg: ModelConfig, tp: int, dtype, device) -> Params:
    """One shared block of the published form: its attention reads the
    2d-wide concatenation and writes the d-wide residual."""
    d = cfg.d_model
    ones = partial(torch.ones, dtype=dtype, device=device)
    attn = L.attn_init(gen, dataclasses.replace(cfg, d_model=2 * d), tp,
                       dtype, device)
    attn["wo"] = attn["wo"][:, :d].contiguous()     # (heads x hd, d)
    return {"ln_attn": ones((2 * d,)), "ln_mlp": ones((d,)), "attn": attn,
            "mlp": L.mlp_init(gen, cfg, dtype, device)}


def _hybrid_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    """One hybrid call's own weights: its linear and its MLP adapter."""
    d, f, r = cfg.d_model, cfg.d_ff, cfg.adapter_rank
    normal = partial(L._normal, gen, dtype=dtype, device=device)
    return {"linear": normal((d, d), d ** -0.5),
            "adapter_down": normal((d, r), d ** -0.5),
            "adapter_gate": normal((r, f), r ** -0.5),
            "adapter_up": normal((r, f), r ** -0.5)}


def init(cfg: ModelConfig, seed: int = 0, tp: int = 1,
         device="cuda") -> Params:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on
    ``device``, with the reference's shapes, dtypes and scales (not its
    numbers; carry those in with ``tree.params_from_numpy``)."""
    device = torch.device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    layers = stacked_init(_layer_shape(cfg),
                          partial(_mamba_init, gen, cfg, tp, dtype, device))
    ones = partial(torch.ones, (cfg.d_model,), dtype=dtype, device=device)
    if _published(cfg):
        return {
            "embed": L.embed_init(gen, cfg, tp, dtype, device),
            "layers": layers,                   # (n_layers, ...)
            "shared": {str(k): _shared_init(gen, cfg, tp, dtype, device)
                       for k in range(cfg.shared_blocks)},
            "hybrid": stacked_init((_n_calls(cfg),), partial(
                _hybrid_init, gen, cfg, dtype, device)),
            "final_norm": ones(),               # the head: the embedding
        }
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


def specs(cfg: ModelConfig) -> Params:
    lead = len(_layer_shape(cfg))
    blk = spec_map(lambda s: P(*(None,) * lead, *s), _mamba_specs())
    shared = {"ln_attn": P(None), "ln_mlp": P(None),
              "attn": L.attn_specs(cfg), "mlp": L.mlp_specs()}
    if not _published(cfg):
        return {"embed": L.embed_specs(), "layers": blk, "shared": shared,
                "final_norm": P(None), "head": L.embed_specs()}
    # replicated: no mesh runs the published form (_no_mesh)
    hybrid = P(None, None, None)
    return {"embed": L.embed_specs(), "layers": blk,
            "shared": {str(k): shared for k in range(cfg.shared_blocks)},
            "hybrid": dict.fromkeys(("linear", "adapter_down", "adapter_gate",
                                     "adapter_up"), hybrid),
            "final_norm": P(None)}


def _spanned(cfg: ModelConfig, device, cache):
    """-> ``spanned(name, i, fn, *args, **kw)``: ``fn(*args, **kw)`` inside
    span ``name`` (layer ``i``) on the whole-sequence forward while
    something records; else ``fn`` alone, with no context manager entered
    (a serving step, which carries a cache, records none).  Counts the
    forward's Mamba layers and shared-block calls."""
    rec = obs.recording() if cache is None else None
    if rec is None:
        return lambda name, i, fn, *args, **kw: fn(*args, **kw)
    rec.metrics.counter("zamba2.mamba_layers").inc(cfg.n_layers)
    rec.metrics.counter("zamba2.shared_calls").inc(_n_calls(cfg))

    def spanned(name, i, fn, *args, **kw):
        with rec.tracer.span(name, {"layer": i}, device):
            return fn(*args, **kw)
    return spanned


def _run(params: Params, cfg: ModelConfig, x, *, positions, tp, impl,
         cache: Params | None = None, cache_pos=None, pages=None):
    """The layers in order; with a cache, every state is read and written
    in place."""
    if context.current_mesh() is not None:
        _no_mesh(cfg)
    spanned = _spanned(cfg, x.device, cache)
    attn_kw = dict(positions=positions, tp=tp, impl=impl, cache_pos=cache_pos,
                   pages=pages)

    def mamba(x, idx, t=None):
        st = None if cache is None else layer(
            {"conv": cache["conv"], "ssd": cache["ssd"]}, *idx)
        x, new = _mamba_block(local.take(params, ("layers",), idx), cfg, x,
                              tp, impl, state=st, t=t)
        if st is not None:
            for name, v in new.items():
                st[name].copy_(v)
        return x

    def kv(j):
        return None if cache is None else layer(cache["attn"], j)

    if _published(cfg):
        x0 = x
        calls = {lid: j for j, lid in enumerate(cfg.hybrid_layer_ids)}
        for i in range(cfg.n_layers):
            t = None
            if i in calls:
                j = calls[i]
                t = spanned(
                    "zamba2.shared", j, _hybrid_call,
                    local.take(params, ("shared",
                                        str(j % cfg.shared_blocks))),
                    local.take(params, ("hybrid",), (j,)), cfg, x, x0,
                    cache=kv(j), **attn_kw)
            x = spanned("zamba2.mamba", i, mamba, x, (i,), t)
        x = L.rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
        return L.unembed(local.take(params, ("embed",)), x, cfg.vocab)

    g, per = _layer_shape(cfg)
    for gi in range(g):
        for li in range(per):
            x = spanned("zamba2.mamba", gi * per + li, mamba, x, (gi, li))
        # the shared block's weights, gathered again at every call
        x = spanned("zamba2.shared", gi, _shared_attn,
                    local.take(params, ("shared",)), cfg, x, cache=kv(gi),
                    **attn_kw)
    x = L.rms_norm(x, params["final_norm"])
    return L.unembed(local.take(params, ("head",)), x, cfg.vocab)


def forward(params: Params, cfg: ModelConfig, inputs: Params, *,
            tp: int = 1, impl="cuda") -> torch.Tensor:
    """Full-sequence forward -> logits: every Mamba layer's recurrence goes
    through ``ops.mamba2`` and every shared-block call's attention through
    ``ops.attention`` (the kernels when ``impl='cuda'``)."""
    x = L.embed(local.take(params, ("embed",)), inputs["tokens"])
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
    lead = _layer_shape(cfg)
    return {
        "conv": torch.zeros((*lead, batch, CONV_K - 1,
                             hp + 2 * cfg.ssm_groups * n),
                            dtype=dtype, device=device),
        "ssd": torch.zeros((*lead, batch, h, n, cfg.ssm_head_dim),
                           device=device),
        "attn": tree_map(lambda x: torch.zeros((_n_calls(cfg), *x.shape),
                                               dtype=x.dtype, device=device),
                         L.init_kv_cache(cfg, batch, max_seq, tp, dtype,
                                         device="meta")),
    }


def cache_specs(cfg: ModelConfig) -> Params:
    kv = spec_map(lambda s: P(None, *s), L.kv_cache_specs(cfg))
    lead = (None,) * len(_layer_shape(cfg))
    return {"conv": P(*lead, L.BATCH_AXES, None, TP),
            "ssd": P(*lead, L.BATCH_AXES, TP, None, None),
            "attn": kv}


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
    lead = len(_layer_shape(cfg))
    return {"conv": lead, "ssd": lead, "attn": {name: 1 for name in names}}


def init_paged_cache(cfg: ModelConfig, slots: int, rows: int, max_seq: int,
                     tp: int = 1, dtype=None, device="cuda") -> Params:
    """Paged serving cache: conv/SSD states stay per slot (O(1) in sequence
    length, nothing to page); the shared-attention KV moves into one
    physical pool of ``rows`` rows (plus the scratch row) per call."""
    cache = init_cache(cfg, slots, 0, tp, dtype, device)
    dtype = dtype or getattr(torch, cfg.dtype)
    cache["attn"] = tree_map(
        lambda x: torch.zeros((_n_calls(cfg), *x.shape), dtype=x.dtype,
                              device=device),
        L.init_paged_kv_pool(cfg, rows, tp, dtype, device="meta"))
    return cache


def paged_cache_specs(cfg: ModelConfig) -> Params:
    """Specs mirroring :func:`init_paged_cache`: per-slot conv/SSD states
    keep their dense specs; the pooled attention KV gains the call axis
    over the kv-pool specs."""
    pool = spec_map(lambda s: P(None, *s), L.paged_kv_pool_specs(cfg))
    return {**cache_specs(cfg), "attn": pool}


def paged_slot_axes(cfg: ModelConfig) -> Params:
    """Scatter map for the paged cache: ``"pool"`` marks pooled KV leaves,
    ints the slot axis of per-slot recurrent leaves."""
    axes = cache_slot_axes(cfg)
    axes["attn"] = {name: "pool" for name in axes["attn"]}
    return axes


def pack_paged_slot(cfg: ModelConfig, pcache: Params, max_seq: int,
                    seq_len: int) -> Params:
    """Paged repack: recurrent states carry as they are; the attention KV
    keeps its raw ``seq_len`` rows for the engine's page-table scatter (no
    padding)."""
    if seq_len > max_seq:
        raise ValueError(f"prompt length {seq_len} exceeds max_seq {max_seq}")
    return pcache


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, pos, *, tp: int = 1, impl="cuda",
                row_map=None) -> tuple[torch.Tensor, Params]:
    """Decode ``tokens (B, S)`` at per-slot positions ``pos`` ((B,) ints,
    host data; a scalar broadcasts); S > 1 is a slot prefill (the Mamba
    layers through the kernel, the shared block's attention against its
    cache).  ``row_map`` ((B, L) host ints) routes the pooled attention KV
    through the paged engine's page table.  The cache is written in place
    and returned."""
    x = L.embed(local.take(params, ("embed",)), tokens)
    b, s, _ = x.shape
    cpos = L._positions_host(pos, b)
    positions = L._to_device(cpos[:, None] + torch.arange(s), x.device)
    pages = None if row_map is None else L.page_table(row_map, cpos, s,
                                                      x.device)
    return _run(params, cfg, x, positions=positions, tp=tp, impl=impl,
                cache=cache, cache_pos=cpos, pages=pages), cache

