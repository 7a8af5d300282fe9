"""The benchmark's own arithmetic: peaks of the card, exact quantiles, and
the operations and bytes of a kernel op's call and of a model's forward,
counted from shapes.

A call's bound is the larger of two times: its operations over the peak
bf16 rate, and its bytes over the peak memory rate.  Bytes count each
input read once and each output written once; an input broadcast by a
stride of 0 is read once.  Operation counts, per unit of work:

* attention: 4·H·D a causal (query, key) pair (QK^T and PV);
* rwkv6: 4·K·V + 3·L·K + L·V a token and head, L = 16;
* mamba2: 4·N·P + L·N + L·P a token and head, L = 64.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

# NVIDIA's data sheet, H100 SXM, dense rates without sparsity
PEAKS = {
    "H100": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(kind: str) -> dict:
    for key, p in PEAKS.items():
        if key in kind:
            return p
    raise KeyError(f"no peaks for the device {kind!r}")


def quantile(values, q: float) -> float:
    """The exact order statistic at ``q`` (nearest rank): the smallest
    value with at least ``q`` of all values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


@dataclass(frozen=True)
class Meta:
    """What the bound needs of a tensor argument."""
    shape: tuple
    stride: tuple
    itemsize: int

    @classmethod
    def of(cls, t) -> "Meta":
        return cls(tuple(t.shape), tuple(t.stride()), t.element_size())

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def stored(self) -> int:
        """Bytes of the distinct elements (stride-0 dims read once)."""
        return math.prod(s for s, st in zip(self.shape, self.stride)
                         if st != 0) * self.itemsize


def attention_cost(q: Meta, k: Meta, v: Meta, causal: bool = True):
    """(operations, bytes) of one attention call, q (B, Sq, H, D), k/v
    (B, Skv, Hkv, D); the output has q's shape and type."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if causal:   # query i sees keys up to i + skv - sq
        pairs = sum(min(skv, i + skv - sq + 1) for i in range(sq)) \
            if sq != skv else sq * (sq + 1) // 2
    else:
        pairs = sq * skv
    ops = 4 * h * d * pairs * b
    nbytes = q.stored + k.stored + v.stored + q.numel * q.itemsize
    return ops, nbytes


def rwkv6_cost(r: Meta, k: Meta, v: Meta, w: Meta, u: Meta,
               state: Meta | None = None, chunk: int = 16):
    """(operations, bytes) of one rwkv6 call: r/k/w (B, T, H, K), v (B, T,
    H, V), u (H, K); writes the output in v's type and the float32 state
    (B, H, K, V)."""
    b, t, h, dk = k.shape
    dv = v.shape[-1]
    ops = (4 * dk * dv + 3 * chunk * dk + chunk * dv) * b * t * h
    out = b * t * h * dv * v.itemsize + b * h * dk * dv * 4
    ins = r.stored + k.stored + v.stored + w.stored + u.stored \
        + (state.stored if state is not None else 0)
    return ops, ins + out


def mamba2_cost(x: Meta, a: Meta, b: Meta, c: Meta,
                state: Meta | None = None, chunk: int = 64):
    """(operations, bytes) of one mamba2 call: x (B, T, H, P), a (B, T,
    H), b/c (B, T, H, N) (stride 0 over H read once); writes y in x's type
    and the float32 state (B, H, N, P)."""
    bs, t, h, p = x.shape
    n = b.shape[-1]
    ops = (4 * n * p + chunk * n + chunk * p) * bs * t * h
    out = x.numel * x.itemsize + bs * h * n * p * 4
    ins = x.stored + a.stored + b.stored + c.stored \
        + (state.stored if state is not None else 0)
    return ops, ins + out


COSTS = {"attention": attention_cost, "rwkv6": rwkv6_cost,
         "mamba2": mamba2_cost}


def call_cost(name: str, args: list, kw: dict):
    """(operations, bytes) of one recorded call of op ``name``: its
    positional tensor arguments and scalar keywords (``trace.op_ranges``);
    only ``causal`` of the keywords changes the count."""
    extra = {"causal": kw["causal"]} if "causal" in kw else {}
    return COSTS[name](*args, **extra)


def bound_s(ops: int, nbytes: int, peak: dict) -> float:
    return max(ops / peak["bf16_flops"], nbytes / peak["hbm_bytes_per_s"])


def model_flops(matmul_params: int, seq_ops: dict, tokens: int) -> float:
    """Model FLOPs of a forward over ``tokens`` tokens: 2 per matrix
    weight and token, plus attention and the recurrences
    (``seq_ops``)."""
    return 2 * matmul_params * tokens + seq_ops["attention"] \
        + seq_ops["recurrence"]
