"""The Mamba-2 kernel's chunk-parallel decomposition and its rounding, on the
CPU.

``csrc/mamba2.cu`` runs three passes over spans of 64-token chunks
(``kernels/mamba2.py::plan``): each span's local state from zero, a short
pass that carries the state across the spans, and every span's outputs from
the state entering it.  Its bfloat16 route multiplies the state's products
on the tensor cores, exact bfloat16 operands against a float32 one split
into three bfloat16 terms (v1 = bf16(v), v2 = bf16(v - v1), v3 = bf16(v - v1
- v2)): the decayed b against x, and c against the state; the Gram and the
decayed Gram against x run in float32.  ``ssd_emulation`` below is that
arithmetic in torch float32 on bfloat16-valued inputs.  It is held against
the port's plain version (``xla_linear.mamba2``) and oracle
(``ref.mamba2_ref``), and against the reference's oracle and its ``ops``
run with the Pallas kernel interpreted and with its 'xla' version (where T
is a multiple of their chunks, which they assert), with the smoke's limits:
outputs rtol 1e-2 / atol 1e-3 (one bfloat16 ulp, both round a float32
result once), final states rtol/atol 1e-4.  The kernel itself runs only on
the card (``tests/test_torch_kernels_cuda.py``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import mamba2, ref, xla_linear
from repro_torch.kernels.mamba2 import CHUNK, SPAN_CHUNKS, plan

H100_SMS = 132
LIN_TOL = (1e-2, 1e-3)        # bfloat16 outputs (chip_smoke.py LIN_TOL)
STATE_TOL = (1e-4, 1e-4)      # float32 final states (chip_smoke.py)


def _terms(v, terms):
    """v as ``terms`` bfloat16 terms, each the rounding of what the terms
    before it left, summed back in float32."""
    out, rest = torch.zeros_like(v), v
    for _ in range(terms):
        term = rest.bfloat16().float()
        out, rest = out + term, rest - term
    return out


def ssd_emulation(x, a, b, c, state=None, *, span_chunks, terms=3):
    """The bfloat16 kernel's three passes on (B, T, H, P) x, (B, T, H) a,
    (B, T, H, N) b and c holding bfloat16 values: chunks of 64 (rows past
    T zero), spans of ``span_chunks`` chunks, the float32 operand of each
    tensor-core product (the decayed b, the state) rounded to ``terms``
    bfloat16 terms.  Returns (y
    rounded to bfloat16 once, final state float32)."""
    bs, t, h, p = x.shape
    n = b.shape[-1]
    nc = -(-t // CHUNK)
    pad = nc * CHUNK - t
    xc, ac, bc, cc = (torch.cat([z.float(), z.new_zeros(
        (bs, pad, *z.shape[2:])).float()], 1).reshape(bs, nc, CHUNK,
                                                      *z.shape[2:])
                      for z in (x, a, b, c))
    la = torch.cumsum(ac, 2)                                # (B, nc, L, H)
    ea = torch.exp(torch.clamp(la, max=0.0))
    el = ea[:, :, -1]                                       # e^{la_L}
    ed = torch.exp(torch.clamp(la[:, :, -1:] - la, max=0.0))
    bd = _terms(bc * ed[..., None], terms)
    local = torch.einsum("bclhn,bclhp->bchnp", bd, xc)      # from h = 0
    incl = torch.ones(CHUNK, CHUNK, dtype=torch.bool).tril()[:, :, None]
    spans = [range(j, min(j + span_chunks, nc))
             for j in range(0, nc, span_chunks)]
    # pass 1: each span's local state and decay
    s_loc, decay = [], []
    for sp in spans:
        hs, d = torch.zeros(bs, h, n, p), torch.ones(bs, h)
        for ci in sp:
            hs = el[:, ci][..., None, None] * hs + local[:, ci]
            d = d * el[:, ci]
        s_loc.append(hs)
        decay.append(d)
    # pass 2: the state entering each span, and the final state
    run = torch.zeros(bs, h, n, p) if state is None else state.float()
    enter = []
    for sj, d in zip(s_loc, decay):
        enter.append(run)
        run = d[..., None, None] * run + sj
    # pass 3: outputs from the entering state, updated between chunks
    ys = []
    for sp, hs in zip(spans, enter):
        for ci in sp:
            y = torch.einsum("blhn,bhnp->blhp", cc[:, ci],
                             _terms(hs, terms)) * ea[:, ci][..., None]
            gram = torch.einsum("bthn,bshn->btsh", cc[:, ci], bc[:, ci])
            dec = torch.where(incl, torch.exp(torch.clamp(
                la[:, ci, :, None] - la[:, ci, None], max=0.0)), 0.0)
            y = y + torch.einsum("btsh,bshp->bthp", gram * dec, xc[:, ci])
            hs = el[:, ci][..., None, None] * hs + local[:, ci]
            ys.append(y)
    return torch.cat(ys, 1)[:, :t].bfloat16(), run


def _inputs(b, t, h, p, n, decay, state, shared, seed):
    """bfloat16-valued float32 numpy arrays, outputs O(1): b, c scaled by
    N^-0.5; weak decay a ~ -1e-3 (the carried state dominates), strong
    a = -exp(N(0, 0.5)).  ``shared``: one b/c group for every head."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = f(b, t, h, p)
    a = (-1e-3 * np.exp(0.1 * f(b, t, h)) if decay == "weak"
         else -np.exp(0.5 * f(b, t, h))).astype(np.float32)
    hb = 1 if shared else h
    bb, cc = (np.repeat(f(b, t, hb, n) * n ** -0.5, h // hb, axis=2)
              for _ in range(2))
    s0 = f(b, h, n, p) * n ** -0.5 if state else None
    bf = lambda z: torch.from_numpy(z).bfloat16()  # noqa: E731
    x, a, bb, cc = bf(x), bf(a), bf(bb), bf(cc)
    if shared:       # stride-0 views over the heads, one group for all
        bb, cc = (z[:, :, :1].expand(b, t, h, n) for z in (bb, cc))
    return x, a, bb, cc, None if s0 is None else torch.from_numpy(s0)


def _np(z):
    return None if z is None else z.float().numpy()


def _violations(got, want, tol):
    rtol, atol = tol
    if not isinstance(want, torch.Tensor):
        want = torch.from_numpy(np.array(want, np.float32))
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    return int(((got - want).abs() > atol + rtol * want.abs()).sum())


CASES = [
    # (B, T, H, P, N, decay, state, shared): ragged T, N != P and not
    # multiples of 16, b/c shared or not, weak and strong decay
    (1, 1, 3, 64, 64, "strong", True, False),
    (2, 63, 2, 64, 64, "weak", False, True),
    (1, 65, 2, 32, 16, "strong", True, False),
    (1, 1000, 2, 64, 64, "weak", True, True),
    (2, 100, 3, 48, 24, "strong", False, False),
    (1, 70, 2, 16, 128, "weak", True, True),
    (1, 512, 4, 64, 64, "weak", True, True),
    (1, 512, 2, 48, 24, "strong", False, False),
    (2, 256, 2, 16, 128, "weak", False, True),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulation_matches_plain_oracle_and_reference(case):
    b, t, h, p, n, decay, state, shared = case
    ins = _inputs(*case, seed=t + 7 * n)
    pl = plan(b, t, h, p, n, True, shared, H100_SMS)
    got_y, got_s = ssd_emulation(*ins, span_chunks=pl.span_chunks)
    assert float(got_y.float().abs().max()) > 0.2       # O(1), not vanishing
    for want_y, want_s in (xla_linear.mamba2(*ins), ref.mamba2_ref(*ins)):
        assert _violations(got_y, want_y, LIN_TOL) == 0
        assert _violations(got_s, want_s, STATE_TOL) == 0
    jins = [None if z is None else jnp.asarray(_np(z)) for z in ins]
    refs = [jref.mamba2_ref(*jins)]
    if t % 64 == 0:
        refs.append(jops.mamba2(*jins, implementation="interpret"))
    if t % min(128, t) == 0:
        refs.append(jops.mamba2(*jins, implementation="xla"))
    for want_y, want_s in refs:
        assert _violations(got_y, want_y, LIN_TOL) == 0
        assert _violations(got_s, want_s, STATE_TOL) == 0


@pytest.mark.parametrize("span_chunks", [1, 2, 3, SPAN_CHUNKS, 16])
def test_any_span_gives_the_same_function(span_chunks):
    ins = _inputs(1, 1000, 2, 64, 64, "weak", True, True, seed=3)
    got_y, got_s = ssd_emulation(*ins, span_chunks=span_chunks)
    want_y, want_s = xla_linear.mamba2(*ins)
    assert _violations(got_y, want_y, LIN_TOL) == 0
    assert _violations(got_s, want_s, STATE_TOL) == 0


@pytest.mark.parametrize("split", [377, 512])
def test_two_chained_halves_equal_one_whole(split):
    x, a, b, c, _ = _inputs(1, 1000, 4, 64, 64, "weak", False, True, seed=5)
    k = plan(1, 1000, 4, 64, 64, True, True, H100_SMS).span_chunks
    whole_y, whole_s = ssd_emulation(x, a, b, c, span_chunks=k)
    y1, s1 = ssd_emulation(x[:, :split], a[:, :split], b[:, :split],
                           c[:, :split], span_chunks=k)
    y2, s2 = ssd_emulation(x[:, split:], a[:, split:], b[:, split:],
                           c[:, split:], s1, span_chunks=k)
    assert _violations(torch.cat([y1, y2], 1), whole_y, LIN_TOL) == 0
    assert _violations(s2, whole_s, STATE_TOL) == 0


@pytest.mark.parametrize("terms,within", [(3, True), (2, True), (1, False)])
def test_rounding_of_the_float32_operands_against_the_limits(terms, within):
    """Three bfloat16 terms (the kernel's) and two hold both limits at
    zamba2's head shape over 4096 tokens with a state; one term (~8 bits)
    moves the float32 final state past STATE_TOL (and 61664 outputs past
    LIN_TOL)."""
    ins = _inputs(1, 4096, 2, 64, 64, "weak", True, True, seed=11)
    got_y, got_s = ssd_emulation(*ins, span_chunks=SPAN_CHUNKS, terms=terms)
    want_y, want_s = xla_linear.mamba2(*ins)
    bad = (_violations(got_y, want_y, LIN_TOL)
           + _violations(got_s, want_s, STATE_TOL))
    assert (bad == 0) is within


def _flips(got, want):
    """The share of bfloat16 outputs that differ from ``want``'s."""
    return float((got.float() != want.float()).float().mean())


def test_three_terms_flip_no_more_outputs_than_float32_order():
    """The outputs' bfloat16 roundings: three terms flip as many as the plain
    version does when its own chunk changes from 128 to 64 (float32
    summation order); two terms flip ten times as many, which zamba2-2.7b's
    54 layers amplify past the smoke's forward limit on the card."""
    ins = _inputs(1, 4096, 4, 64, 64, "weak", False, True, seed=11)
    want = xla_linear.mamba2(*ins)[0]
    order = _flips(xla_linear.mamba2(*ins, chunk=64)[0], want)
    three = _flips(ssd_emulation(*ins, span_chunks=SPAN_CHUNKS)[0], want)
    two = _flips(ssd_emulation(*ins, span_chunks=SPAN_CHUNKS, terms=2)[0],
                 want)
    assert 0 < three <= 1.5 * order
    assert two >= 4 * order


def test_plan_at_zamba2s_forward_keeps_the_states_in_l2():
    # B1 T4096 H80 P=N=64 bfloat16, b/c shared: 256-token spans, 2 heads a
    # CTA, 640 CTAs; 21 MB of span states (50 MB of L2), where one state a
    # 64-token chunk would take 84 MB; one Gram a chunk for every head, 1 MB
    p = plan(1, 4096, 80, 64, 64, True, True, H100_SMS)
    assert p == (("tc", 4, 16, 2, 640, 16 * 80 * 64 * 64 * 4,
                  64 * 64 * 64 * 4))
    assert p.state_bytes < 50e6 < 64 * 80 * 64 * 64 * 4
    # float32 takes the SIMT route, one head a CTA
    assert plan(1, 4096, 80, 64, 64, False, True, H100_SMS)[:4] == \
        ("simt", 4, 16, 1)


@pytest.mark.parametrize("t", [1, 63, 64, 65, 128, 200, 1000, 4096, 20000])
@pytest.mark.parametrize("h,shared", [(80, True), (2, False), (3, True)])
def test_plan_covers_t_in_spans_and_never_one_span_of_many(t, h, shared):
    p = plan(1, t, h, 64, 64, True, shared, H100_SMS)
    chunks = math.ceil(t / CHUNK)
    assert p.span_chunks in (1, 2, 4)
    assert p.spans == math.ceil(chunks / p.span_chunks)
    assert (p.spans - 1) * p.span_chunks < chunks <= p.spans * p.span_chunks
    assert chunks == 1 or p.spans >= 2      # no CTA walks every chunk of T
    assert p.heads_per_cta == (2 if shared else 1)


def test_plan_groups_heads_only_where_b_and_c_are_shared():
    assert plan(1, 4096, 80, 64, 64, True, False, H100_SMS).heads_per_cta == 1
    assert plan(1, 4096, 80, 64, 128, True, True, H100_SMS).heads_per_cta == 2
    assert plan(1, 4096, 80, 64, 64, False, True, H100_SMS).heads_per_cta == 1
    assert plan(1, 4096, 1, 64, 64, True, True, H100_SMS).heads_per_cta == 1


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("b,t", [(1, 1), (1, 4096), (2, 1000), (3, 65)])
def test_plan_keeps_one_gram_a_chunk_only_where_b_and_c_are_shared(bf16, b,
                                                                   t):
    # shared: one 64 x 64 float32 Gram for each chunk of each batch row,
    # whatever the heads; not shared: none (each head's CTA makes its own)
    chunks = math.ceil(t / CHUNK)
    for h in (1, 80):
        assert plan(b, t, h, 64, 64, bf16, True, H100_SMS).gram_bytes == \
            b * chunks * CHUNK * CHUNK * 4
        assert plan(b, t, h, 64, 64, bf16, False, H100_SMS).gram_bytes == 0


def test_cpu_wrapper_takes_the_plain_version():
    ins = _inputs(1, 100, 2, 16, 8, "strong", True, True, seed=1)
    for got, want in zip(mamba2(*ins), xla_linear.mamba2(*ins)):
        assert torch.equal(got, want)
