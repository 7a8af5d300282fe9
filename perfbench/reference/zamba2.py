"""Plain float32 reference of Zamba2 in its published form (Zamba2-7B,
arXiv:2411.15242; the equations of ``modeling_zamba2.py`` in Hugging Face
transformers 4.57, read, not imported): a list of Mamba2 layers, some of
them hybrid, each hybrid layer running one of the alternating shared
blocks before its Mamba layer.

Each layer i, with x0 the embedding output and t = 0 on a layer that is not
hybrid:

  hybrid layer j (the j-th id of ``hybrid_layer_ids``), block j % blocks:
    s = rms_norm(concat(x, x0))                       (2d wide)
    a = attention(s) @ wo: q, k, v = s @ wq, wk, wv in heads of head_dim,
        RoPE over the whole head (halves rotated as pairs), causal,
        scale (head_dim / 2)^-0.5
    n = rms_norm(a);  [g | u] = n @ [w_gate | w_up] + (n @ A_j) @ [B_g | B_u]
    t = ((gelu(g) * u) @ w_down) @ linear_j          (exact GELU)
  every layer:  x = x + Mamba2(rms_norm(x + t))

Mamba2 on u (S, d): [z | xs | B | C | dt] = u @ in_proj; xs, B and C through
the causal depthwise conv of width 4 with bias, then silu; heads of
``ssm_head_dim`` and ``ssm_groups`` groups of B and C of ``ssm_state``, head
h reading group h // (heads / groups); dt = softplus(dt + dt_bias), a =
-exp(a_log) dt; y = SSD(xs dt, a, B, C) + d_skip xs, run once per group;
out = rms_norm_per_group(y * silu(z)) @ out_proj.  The final norm, then
the head tied to the embedding.  Every norm is an RMS norm with eps
``norm_eps`` (1e-5 published).

Departures from ``modeling_zamba2.py``, none in the mathematics:
* initial scales: weights are drawn from the seed (``param_tree``), not
  loaded or initialised as the model's ``_init_weights`` would;
* the head is tied to the embedding: ``PretrainedConfig``'s default, which
  Zamba2's config does not set;
* dt is not clamped below at ``time_step_min``: the model's CUDA path
  (``time_step_limit`` null, so no ``dt_limit``) does not clamp; its
  pure-PyTorch fallback clamps dt at 0.001, which softplus reaches only
  for inputs below -6.9;
* norms compute in float32 throughout (the model rounds the normalised
  value to its dtype before the weight's product): this is the float32
  reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import common as C
from .common import Leaf

CONV = 4


def dims(m: dict) -> dict:
    d = m["d_model"]
    din = m.get("ssm_expand", 2) * d
    ph = m["ssm_head_dim"]
    return dict(d=d, din=din, ph=ph, h=din // ph, n=m["ssm_state"],
                g=m["ssm_groups"], heads=m["n_heads"], kv=m["n_kv_heads"],
                hd=m["head_dim"], ff=m["d_ff"], r=m["adapter_rank"],
                vocab=m["vocab"], layers=m["n_layers"],
                blocks=m["shared_blocks"], ids=tuple(m["hybrid_layer_ids"]),
                eps=m["norm_eps"], theta=m.get("rope_theta", 10_000.0))


def param_tree(m: dict) -> dict:
    """The parameter tree the program's ``zamba2`` model takes in its
    published form, with the program's initial scales; ``mm_calls`` counts
    a token's products with each leaf (a shared block's, once for each
    hybrid layer that calls it)."""
    k = dims(m)
    d, din, h, ff, r = k["d"], k["din"], k["h"], k["ff"], k["r"]
    gn = k["g"] * k["n"]
    dt = m["dtype"]
    st = (k["layers"],)
    conv = din + 2 * gn
    calls = len(k["ids"])
    qd, kvd = k["heads"] * k["hd"], k["kv"] * k["hd"]

    def block(uses: int) -> dict:
        return {
            "ln_attn": Leaf((2 * d,), dt, offset=1.0),
            "ln_mlp": Leaf((d,), dt, offset=1.0),
            "attn": {
                "wq": Leaf((2 * d, qd), dt, (2 * d) ** -0.5, mm_calls=uses),
                "wk": Leaf((2 * d, kvd), dt, (2 * d) ** -0.5, mm_calls=uses),
                "wv": Leaf((2 * d, kvd), dt, (2 * d) ** -0.5, mm_calls=uses),
                "wo": Leaf((qd, d), dt, qd ** -0.5, mm_calls=uses),
            },
            "mlp": {
                "w_gate": Leaf((d, ff), dt, d ** -0.5, mm_calls=uses),
                "w_up": Leaf((d, ff), dt, d ** -0.5, mm_calls=uses),
                "w_down": Leaf((ff, d), dt, ff ** -0.5, mm_calls=uses),
            },
        }
    return {
        "embed": {"table": Leaf((k["vocab"], d), dt, 0.02, mm_calls=1)},
        "layers": {
            "ln": Leaf((*st, d), dt, offset=1.0),
            "in_proj": Leaf((*st, d, 2 * din + 2 * gn + h), dt, d ** -0.5,
                            mm_calls=1),
            "conv_w": Leaf((*st, CONV, conv), dt, 0.3),
            "conv_b": Leaf((*st, conv), dt),
            "a_log": Leaf((*st, h), "float32"),
            "dt_bias": Leaf((*st, h), "float32"),
            "d_skip": Leaf((*st, h), "float32", offset=1.0),
            "norm": Leaf((*st, din), dt, offset=1.0),
            "out_proj": Leaf((*st, din, d), dt, din ** -0.5, mm_calls=1),
        },
        "shared": {str(b): block(sum(j % k["blocks"] == b
                                     for j in range(calls)))
                   for b in range(k["blocks"])},
        "hybrid": {
            "linear": Leaf((calls, d, d), dt, d ** -0.5, mm_calls=1),
            "adapter_down": Leaf((calls, d, r), dt, d ** -0.5, mm_calls=1),
            "adapter_gate": Leaf((calls, r, ff), dt, r ** -0.5, mm_calls=1),
            "adapter_up": Leaf((calls, r, ff), dt, r ** -0.5, mm_calls=1),
        },
        "final_norm": Leaf((d,), dt, offset=1.0),
    }


def seq_ops(m: dict, s: int) -> dict:
    """Operations of one forward over ``s`` tokens besides the matrix
    products: attention, 4·H·D a causal (query, key) pair in each hybrid
    call; the SSD, 4·N·P + L·N + L·P a token and head, L = 64 (the
    kernel's chunk)."""
    k = dims(m)
    ell = 64
    pairs = s * (s + 1) // 2
    attn = 4 * k["heads"] * k["hd"] * pairs * len(k["ids"])
    per = 4 * k["n"] * k["ph"] + ell * k["n"] + ell * k["ph"]
    return {"attention": attn, "recurrence": per * k["h"] * s * k["layers"]}


def _mamba(p: dict, u, k: dict, mm):
    s = u.shape[0]
    din, h, ph, n, g = k["din"], k["h"], k["ph"], k["n"], k["g"]
    gn = g * n
    proj = mm(u, p["in_proj"])
    z, xbc, dt = proj[:, :din], proj[:, din:2 * din + 2 * gn], proj[:, -h:]
    xbc = C.causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs = xbc[:, :din].reshape(s, h, ph)
    bm = xbc[:, din:din + gn].reshape(s, g, n)
    cm = xbc[:, din + gn:].reshape(s, g, n)
    dt = F.softplus(dt + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float()) * dt                       # (S, H)
    xdt = xs * dt[..., None]
    per = h // g
    y = torch.cat([C.ssd(xdt[:, i * per:(i + 1) * per],
                         a[:, i * per:(i + 1) * per], bm[:, i], cm[:, i])
                   for i in range(g)], dim=1)
    y = (y + xs * p["d_skip"].float()[:, None]).reshape(s, din)
    gated = (y * F.silu(z)).reshape(s, g, din // g)
    normed = C.rms_norm(gated, p["norm"].reshape(g, din // g), k["eps"])
    return mm(normed.reshape(s, din), p["out_proj"])


def _attention(p: dict, u, k: dict, mm):
    """Causal attention of u (S, 2d), blocked (``common.causal_attention``,
    whose D^-0.5 becomes (D / 2)^-0.5 by scaling q by sqrt(2))."""
    s = u.shape[0]
    hd = k["hd"]
    q = C.rope(mm(u, p["wq"]).reshape(s, k["heads"], hd), k["theta"])
    kk = C.rope(mm(u, p["wk"]).reshape(s, k["kv"], hd), k["theta"])
    v = mm(u, p["wv"]).reshape(s, k["kv"], hd)
    out = C.causal_attention(q * math.sqrt(2.0), kk, v)
    return mm(out.reshape(s, k["heads"] * hd), p["wo"])


def _shared(blk: dict, hyb: dict, x, x0, k: dict, mm):
    eps = k["eps"]
    a = _attention(blk["attn"], C.rms_norm(torch.cat([x, x0], dim=-1),
                                           blk["ln_attn"], eps), k, mm)
    n = C.rms_norm(a, blk["ln_mlp"], eps)
    low = mm(n, hyb["adapter_down"])
    g = mm(n, blk["mlp"]["w_gate"]) + mm(low, hyb["adapter_gate"])
    u = mm(n, blk["mlp"]["w_up"]) + mm(low, hyb["adapter_up"])
    return mm(mm(F.gelu(g) * u, blk["mlp"]["w_down"]), hyb["linear"])


def forward(params: dict, m: dict, tokens: torch.Tensor,
            mm: C.Matmul = C.mm_f32) -> torch.Tensor:
    """Logits (S, vocab), float32, of one sequence ``tokens`` (S,); each
    layer's weights read in float32 as it runs."""
    k = dims(m)
    table = params["embed"]["table"]
    x = table[tokens].float()
    x0 = x
    calls = {lid: j for j, lid in enumerate(k["ids"])}
    lay = params["layers"]
    for i in range(k["layers"]):
        u = x
        if i in calls:
            j = calls[i]
            hyb = {name: t[j] for name, t in params["hybrid"].items()}
            u = x + _shared(params["shared"][str(j % k["blocks"])], hyb, x,
                            x0, k, mm)
        p = {name: t[i] for name, t in lay.items()}
        x = x + _mamba(p, C.rms_norm(u, p["ln"], k["eps"]), k, mm)
    x = C.rms_norm(x, params["final_norm"], k["eps"])
    return mm(x, table.T)
