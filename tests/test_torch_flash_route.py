"""Flash attention's route rule and the tensor-core route's rounding, on the
CPU.

* ``flash_attention.route`` picks the bfloat16 tensor-core kernel ("tc")
  or the float32 SIMT kernel ("simt") from dtypes, shapes, strides and
  pointers alone, so it is asked here of CPU tensors, parametrised over
  dtype, head dim, strides and alignment.
* The tensor-core kernel's arithmetic, emulated in torch (64-key tiles,
  scores in log2 units, P rounded to bfloat16 terms, the row sum taken over
  the same terms), against the plain version and the reference's 'xla'
  attention at the card's bfloat16 limit (rtol 1e-2, atol 1e-3, q at std 3).
  P split into two bfloat16 terms stays within it; P in one term does not,
  which is why the kernel splits it.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention, xla_attention
from repro_torch.kernels.flash_attention import route

BF16_TOL = (1e-2, 1e-3)     # FLASH_TOL["bfloat16"] of chip_smoke.py
NEG_INF = -1e30


def _bf(*shape, offset=0):
    """A bfloat16 CPU tensor of ``shape`` starting ``offset`` elements into
    its storage (CPU storage is 64-byte aligned)."""
    n = math.prod(shape)
    return torch.zeros(n + offset, dtype=torch.bfloat16)[offset:].view(shape)


def _strided(shape, strides):
    return torch.zeros(2 * 10 ** 5, dtype=torch.bfloat16).as_strided(shape,
                                                                      strides)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 16, "tc"), (torch.bfloat16, 32, "tc"),
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 80, "tc"),
    (torch.bfloat16, 128, "tc"), (torch.bfloat16, 256, "tc"),
    (torch.bfloat16, 8, "simt"), (torch.bfloat16, 40, "simt"),
    (torch.bfloat16, 100, "simt"), (torch.bfloat16, 272, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
])
def test_route_by_dtype_and_head_dim(dtype, d, want):
    q = torch.zeros(2, 9, 4, d, dtype=dtype)
    k = torch.zeros(2, 9, 2, d, dtype=dtype)
    assert route(q, k, k) == want


def _packed(head_stride):
    p = _bf(2, 96, 12, head_stride)
    return (p[:, :, :8, :64], p[:, :, 8:10, :64], p[:, :, 10:, :64])


@pytest.mark.parametrize("case,want", [
    ("contiguous", "tc"),
    ("packed qkv views", "tc"),                  # strides 768/64 elements
    ("head stride 68", "simt"),                  # rows 8 bytes off 16
    ("sequence stride 132", "simt"),
    ("batch stride 1284", "simt"),
    ("q 8 bytes off 16", "simt"),
    ("k 8 bytes off 16", "simt"),
    ("v 16 bytes on", "tc"),
    ("head dim strided", "simt"),
])
def test_route_by_strides_and_alignment(case, want):
    q, k, v = _bf(1, 10, 4, 64), _bf(1, 10, 2, 64), _bf(1, 10, 2, 64)
    if case == "packed qkv views":
        q, k, v = _packed(64)
    elif case == "head stride 68":
        q, k, v = _packed(68)
    elif case == "sequence stride 132":
        q = _strided((1, 10, 2, 64), (2000, 132, 64, 1))
    elif case == "batch stride 1284":
        q = _strided((2, 10, 2, 64), (1284, 128, 64, 1))
    elif case == "q 8 bytes off 16":
        q = _bf(1, 10, 4, 64, offset=4)
    elif case == "k 8 bytes off 16":
        k = _bf(1, 10, 2, 64, offset=4)
    elif case == "v 16 bytes on":
        v = _bf(1, 10, 2, 64, offset=8)
    elif case == "head dim strided":
        q = _bf(1, 10, 64, 4).transpose(2, 3)
    assert route(q, k, v) == want


def tc_emulation(q, k, v, *, p_terms, causal=True, softcap=0.0, window=0):
    """The tensor-core kernel's arithmetic on bfloat16 (B, S, H, D) inputs:
    exact products summed in float32, 64-key tiles, scores scaled into log2
    units, P rounded to ``p_terms`` bfloat16 terms relative to the running
    max, the row sum over those same terms, one rounding of the output."""
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    qf = q.float().reshape(b, sq, hkv, h // hkv, d)
    qpos = (torch.arange(sq) + skv - sq)[:, None]
    m = torch.full((b, sq, hkv, h // hkv), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, sq, hkv, h // hkv, d))
    for k0 in range(0, skv, 64):
        kb, vb = k[:, k0:k0 + 64].float(), v[:, k0:k0 + 64].float()
        x = torch.einsum("bqhgd,bkhd->bqhgk", qf, kb) * d ** -0.5
        if softcap > 0:
            x = softcap * torch.tanh(x / softcap)
        x = x * math.log2(math.e)
        kpos = k0 + torch.arange(kb.shape[1])[None]
        mask = torch.ones(sq, kb.shape[1], dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        x = torch.where(mask[None, :, None, None], x, NEG_INF)
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.where(x > 0.5 * NEG_INF, torch.exp2(x - m_new[..., None]),
                        0.0)
        terms = p.bfloat16().float()
        if p_terms == 2:
            terms = terms + (p - terms).bfloat16().float()
        l = l * alpha + terms.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bqhgk,bkhd->bqhgd",
                                                    terms, vb)
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.reshape(b, sq, h, d).bfloat16()


def _inputs(b, sq, skv, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)) * 3.0
    k, v = (rng.standard_normal((b, skv, hkv, d)) for _ in range(2))
    return [torch.from_numpy(a.astype(np.float32)).bfloat16()
            for a in (q, k, v)]


def _violations(got, want):
    rtol, atol = BF16_TOL
    err = (got.float() - want.float()).abs()
    return int((err > atol + rtol * want.float().abs()).sum())


@pytest.mark.parametrize("p_terms,within", [(2, True), (1, False)])
def test_tc_rounding_of_p_against_the_bf16_limit(p_terms, within):
    q, k, v = _inputs(1, 1024, 1024, 8, 2, 128, seed=15)
    got = tc_emulation(q, k, v, p_terms=p_terms)
    want = xla_attention.attention(q, k, v)
    assert (_violations(got, want) == 0) is within


@pytest.mark.parametrize("shape,kw", [
    ((2, 40, 56, 4, 2, 32), {}),
    ((2, 40, 56, 4, 2, 32), dict(softcap=20.0)),
    ((2, 40, 56, 4, 2, 32), dict(window=8)),
    ((2, 40, 56, 4, 2, 32), dict(causal=False)),
    ((1, 129, 129, 8, 8, 80), dict(causal=False)),
    ((1, 100, 170, 4, 2, 256), dict(softcap=50.0, window=33)),
    ((1, 70, 30, 4, 2, 64), {}),
])
def test_tc_emulation_matches_plain_and_reference(shape, kw):
    q, k, v = _inputs(*shape, seed=sum(shape))
    got = tc_emulation(q, k, v, p_terms=2, **kw)
    assert _violations(got, xla_attention.attention(q, k, v, **kw)) == 0
    # the CPU wrapper takes the plain version
    assert torch.equal(flash_attention(q, k, v, **kw),
                       xla_attention.attention(q, k, v, **kw))
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (q, k, v))
    ref = jops.attention(jq, jk, jv, implementation="xla", **kw)
    want = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    assert _violations(got, want) == 0
