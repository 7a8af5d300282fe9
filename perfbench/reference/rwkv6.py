"""Plain float32 reference of the RWKV-6 "Finch" language model as the
program states it (arXiv:2404.05892): attention-free blocks of a time mix
(the WKV recurrence with a data-dependent per-channel decay) and a
channel mix.

Simplification of the program, kept here so that both compute the same
function: the token-shift coefficients are static per channel (``mu``,
``mu_c``) rather than data-dependent; norms are RMS norms with eps 1e-6,
the per-head group norm one too.

Time mix on the normed input u (S, d), with u' the input shifted by one
token:  u_i = u + (u' - u) * mu_i for i in r, k, v, g, w;
  r, k, v = u_r @ wr, u_k @ wk, u_v @ wv (heads of 64);  g = silu(u_g @ wg)
  log-decay = -exp(clamp(w0 + tanh(u_w @ w_lora_a) @ w_lora_b, -8, 6))
  out = (rms_norm_per_head(WKV(r, k, v, log-decay, u), ln_x) * g) @ wo
Channel mix:  sigmoid(u_r @ wcr) * (relu(u_k @ wck)^2 @ wcv).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import common as C
from .common import Leaf

LORA_RANK = 64


def dims(m: dict) -> dict:
    d, dh = m["d_model"], m["rwkv_head_dim"]
    return dict(d=d, dh=dh, h=d // dh, ff=m["d_ff"], vocab=m["vocab"],
                layers=m["n_layers"])


def param_tree(m: dict) -> dict:
    """The parameter tree the program's ``rwkv6`` model takes, with the
    program's initial scales."""
    k = dims(m)
    d, h, dh, ff = k["d"], k["h"], k["dh"], k["ff"]
    hd = h * dh
    dt = m["dtype"]
    st = (k["layers"],)
    return {
        "embed": {"table": Leaf((k["vocab"], d), dt, 0.02)},
        "layers": {
            "ln1": Leaf((*st, d), dt, offset=1.0),
            "ln2": Leaf((*st, d), dt, offset=1.0),
            "mu": Leaf((*st, 5, d), dt, 0.02, 0.5),
            "wr": Leaf((*st, d, hd), dt, d ** -0.5, mm_calls=1),
            "wk": Leaf((*st, d, hd), dt, d ** -0.5, mm_calls=1),
            "wv": Leaf((*st, d, hd), dt, d ** -0.5, mm_calls=1),
            "wg": Leaf((*st, d, hd), dt, d ** -0.5, mm_calls=1),
            "wo": Leaf((*st, hd, d), dt, hd ** -0.5, mm_calls=1),
            "w0": Leaf((*st, hd), dt, offset=-1.0),
            "w_lora_a": Leaf((*st, d, LORA_RANK), dt, d ** -0.5, mm_calls=1),
            "w_lora_b": Leaf((*st, LORA_RANK, hd), dt, LORA_RANK ** -0.5,
                             mm_calls=1),
            "u": Leaf((*st, h, dh), dt, 0.5),
            "ln_x": Leaf((*st, h, dh), dt, offset=1.0),
            "mu_c": Leaf((*st, 2, d), dt, 0.02, 0.5),
            "wck": Leaf((*st, d, ff), dt, d ** -0.5, mm_calls=1),
            "wcv": Leaf((*st, ff, d), dt, ff ** -0.5, mm_calls=1),
            "wcr": Leaf((*st, d, d), dt, d ** -0.5, mm_calls=1),
        },
        "final_norm": Leaf((d,), dt, offset=1.0),
        "head": {"table": Leaf((k["vocab"], d), dt, 0.02, mm_calls=1)},
    }


def seq_ops(m: dict, s: int) -> dict:
    """Operations of one forward over ``s`` tokens besides the matrix
    products: the WKV recurrence, 4·K·V + 3·L·K + L·V a token and head,
    L = 16 (the kernel's chunk)."""
    k = dims(m)
    ell = 16
    per = 4 * k["dh"] * k["dh"] + 3 * ell * k["dh"] + ell * k["dh"]
    return {"attention": 0, "recurrence": per * k["h"] * s * k["layers"]}


def _time_mix(p: dict, u, k: dict, mm):
    s = u.shape[0]
    h, dh = k["h"], k["dh"]
    up = C.shift(u)
    mu = p["mu"].float()
    ur, uk, uv, ug, uw = (u + (up - u) * mu[i] for i in range(5))
    r = mm(ur, p["wr"]).reshape(s, h, dh)
    kk = mm(uk, p["wk"]).reshape(s, h, dh)
    v = mm(uv, p["wv"]).reshape(s, h, dh)
    g = F.silu(mm(ug, p["wg"]))
    lora = mm(torch.tanh(mm(uw, p["w_lora_a"])), p["w_lora_b"])
    logw = -torch.exp(torch.clamp(p["w0"].float() + lora, -8.0, 6.0))
    out = C.wkv6(r, kk, v, logw.reshape(s, h, dh), p["u"])
    out = C.rms_norm(out, p["ln_x"]).reshape(s, h * dh) * g
    return mm(out, p["wo"])


def _channel_mix(p: dict, u, mm):
    up = C.shift(u)
    mu = p["mu_c"].float()
    uk = u + (up - u) * mu[0]
    ur = u + (up - u) * mu[1]
    hidden = torch.square(F.relu(mm(uk, p["wck"])))
    return torch.sigmoid(mm(ur, p["wcr"])) * mm(hidden, p["wcv"])


def _block(p: dict, x, k: dict, mm):
    x = x + _time_mix(p, C.rms_norm(x, p["ln1"]), k, mm)
    return x + _channel_mix(p, C.rms_norm(x, p["ln2"]), mm)


def forward(params: dict, m: dict, tokens: torch.Tensor,
            mm: C.Matmul = C.mm_f32) -> torch.Tensor:
    """Logits (S, vocab), float32, of one sequence ``tokens`` (S,); each
    layer's weights read in float32 as it runs."""
    k = dims(m)
    x = params["embed"]["table"][tokens].float()
    lay = params["layers"]
    for i in range(k["layers"]):
        x = _block({name: t[i] for name, t in lay.items()}, x, k, mm)
    x = C.rms_norm(x, params["final_norm"])
    return mm(x, params["head"]["table"].T)
