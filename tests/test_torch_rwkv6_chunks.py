"""The RWKV-6 kernel's chunk-parallel decomposition and its rounding, on the
CPU.

``csrc/rwkv6.cu`` runs three passes over spans of 16-token chunks
(``kernels/rwkv6.py::plan``): each span's local state from zero with its
per-channel decay, a short pass that carries the state across the spans
(``csrc/state_pass.cuh``, shared with mamba2), and every span's outputs
from the state entering it.  Its bfloat16 route multiplies the state's
product on the tensor cores: exact bfloat16 v against the decayed k (k o
e^{lw_L - lw}, float32) split into three bfloat16 terms (k1 = bf16(x), k2 =
bf16(x - k1), k3 = bf16(x - k1 - k2)); the pairwise scores and the output
terms run in float32.  ``wkv_emulation`` below is that arithmetic in torch
float32 on bfloat16-valued inputs.  It is held against the port's plain
version (``xla_linear.rwkv6``, at its chunk of 32 and at the kernel's 16)
and oracle (``ref.rwkv6_ref``), and against the reference's oracle and its
``ops`` run with the Pallas kernel interpreted and with its 'xla' version
(where T is a multiple of their chunks, 16 and 32, which they assert), with
the smoke's limits: outputs rtol 1e-2 / atol 1e-3 (one bfloat16 ulp, both
round a float32 result once), final states rtol/atol 1e-4.  The kernel
itself runs only on the card (``tests/test_torch_kernels_cuda.py``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ref, rwkv6, xla_linear
from repro_torch.kernels.rwkv6 import (CHUNK, COLUMNS, CTAS_PER_SM,
                                       SPAN_CHUNKS, plan)

H100_SMS = 132
LIN_TOL = (1e-2, 1e-3)        # bfloat16 outputs (chip_smoke.py LIN_TOL)
STATE_TOL = (1e-4, 1e-4)      # float32 final states (chip_smoke.py)


def _terms(x, terms):
    """x as ``terms`` bfloat16 terms, each the rounding of what the terms
    before it left, summed back in float32."""
    out, rest = torch.zeros_like(x), x
    for _ in range(terms):
        term = rest.bfloat16().float()
        out, rest = out + term, rest - term
    return out


def state_pass(local, dec, h0, rows):
    """Pass 2 as ``state_pass.cuh`` indexes it: ``local`` (BH, NS, NPe) the
    spans' local states, ``dec`` (BH, NS, R) their decays, element e of a
    state taking decay e // (NPe // R).  Returns (the states entering each
    span (BH, NS, NPe), the final state (BH, NPe))."""
    bh, ns, npe = local.shape
    row = torch.arange(npe) // (npe // rows)
    run = torch.zeros(bh, npe) if h0 is None else h0
    enter = []
    for j in range(ns):
        enter.append(run)
        run = dec[:, j, row] * run + local[:, j]
    return torch.stack(enter, 1), run


def wkv_emulation(r, k, v, w, u, state=None, *, span_chunks, terms=3):
    """The bfloat16 kernel's three passes on (B, T, H, Dk) r, k, w, (B, T,
    H, Dv) v and (H, Dk) u holding bfloat16 values: chunks of 16 (rows past
    T zero), spans of ``span_chunks`` chunks, the decayed k of the state's
    product rounded to ``terms`` bfloat16 terms.  Returns (out rounded to
    bfloat16 once, final state float32)."""
    b, t, h, dk = r.shape
    dv = v.shape[-1]
    nc = -(-t // CHUNK)
    pad = nc * CHUNK - t
    rc, kc, vc, wc = (torch.cat([z.float(), z.new_zeros(
        (b, pad, h, z.shape[-1])).float()], 1).reshape(
            b, nc, CHUNK, h, z.shape[-1]) for z in (r, k, v, w))
    lw = torch.cumsum(wc, 2)                           # (B, nc, L, H, Dk)
    aq = lw - wc
    el = torch.exp(torch.clamp(lw[:, :, -1], max=0.0))  # e^{lw_L}
    kd = kc * torch.exp(torch.clamp(lw[:, :, -1:] - lw, max=0.0))
    local = torch.einsum("bclhk,bclhv->bchkv", _terms(kd, terms), vc)
    rq = rc * torch.exp(torch.clamp(aq, max=0.0))
    pair = torch.exp(torch.clamp(aq[:, :, :, None] - lw[:, :, None], max=0.0))
    strict = torch.ones(CHUNK, CHUNK, dtype=torch.bool).tril(-1)
    scores = torch.einsum("bctshk,bcthk,bcshk->bchts", pair, rc, kc)
    scores = torch.where(strict, scores, 0.0) + torch.diag_embed(
        torch.einsum("bclhk,hk,bclhk->bchl", rc, u.float(), kc))
    spans = [range(j, min(j + span_chunks, nc))
             for j in range(0, nc, span_chunks)]
    # pass 1: each span's local state and per-channel decay
    s_loc, decay = [], []
    for sp in spans:
        hs, d = torch.zeros(b, h, dk, dv), torch.ones(b, h, dk)
        for ci in sp:
            hs = el[:, ci][..., None] * hs + local[:, ci]
            d = d * el[:, ci]
        s_loc.append(hs)
        decay.append(d)
    # pass 2: the state entering each span, and the final state
    enter, final = state_pass(
        torch.stack(s_loc, 2).reshape(b * h, len(spans), dk * dv),
        torch.stack(decay, 2).reshape(b * h, len(spans), dk),
        None if state is None else state.float().reshape(b * h, dk * dv), dk)
    enter = enter.reshape(b, h, len(spans), dk, dv)
    # pass 3: outputs from the entering state, updated between chunks
    outs = []
    for j, sp in enumerate(spans):
        hs = enter[:, :, j]
        for ci in sp:
            o = torch.einsum("blhk,bhkv->blhv", rq[:, ci], hs)
            o = o + torch.einsum("bhts,bshv->bthv", scores[:, ci], vc[:, ci])
            hs = el[:, ci][..., None] * hs + local[:, ci]
            outs.append(o)
    return (torch.cat(outs, 1)[:, :t].bfloat16(),
            final.reshape(b, h, dk, dv))


def _inputs(b, t, h, dk, dv, decay, state, seed):
    """bfloat16-valued tensors, outputs O(1): r, k scaled by Dk^-0.5; weak
    decay w ~ -exp(N(-6, 0.5)) (the carried state dominates), strong
    -exp(N(0, 0.5)), wide -exp(clip(N(-1, 2), -8, 6)): the model's whole
    range, -3e-4 to -403 a token (chip_smoke.py)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    r, k = f(b, t, h, dk) * dk ** -0.5, f(b, t, h, dk) * dk ** -0.5
    v, u = f(b, t, h, dv), f(h, dk) * 0.5
    if decay == "wide":
        w = -np.exp(np.clip(-1.0 + 2.0 * f(b, t, h, dk), -8.0, 6.0))
    else:
        w = -np.exp((-6.0 if decay == "weak" else 0.0)
                    + 0.5 * f(b, t, h, dk))
    s0 = f(b, h, dk, dv) * dk ** -0.5 if state else None
    bf = lambda z: torch.from_numpy(z.astype(np.float32)).bfloat16()  # noqa
    return (bf(r), bf(k), bf(v), bf(w), torch.from_numpy(u),
            None if s0 is None else torch.from_numpy(s0))


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
    # (B, T, H, Dk, Dv, decay, state): ragged T, Dk != Dv and not multiples
    # of 16, with and without a state, weak, strong and wide decay
    (1, 1, 3, 64, 64, "strong", True),
    (2, 15, 2, 32, 48, "weak", False),
    (1, 17, 2, 64, 64, "wide", True),
    (1, 1000, 2, 64, 64, "weak", True),
    (2, 100, 3, 16, 40, "strong", False),
    (1, 70, 2, 128, 16, "weak", True),
    (1, 256, 2, 64, 64, "wide", True),
    (2, 160, 2, 32, 48, "strong", True),
    (1, 1000, 2, 48, 80, "wide", False),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulation_matches_plain_oracle_and_reference(case):
    b, t, h, dk, dv, decay, state = case
    ins = _inputs(*case, seed=t + 7 * dk)
    pl = plan(b, t, h, dk, dv, True, H100_SMS)
    got_o, got_s = wkv_emulation(*ins, span_chunks=pl.span_chunks)
    assert float(got_o.float().abs().max()) > 0.2       # O(1), not vanishing
    for want_o, want_s in (xla_linear.rwkv6(*ins),
                           xla_linear.rwkv6(*ins, chunk=16),
                           ref.rwkv6_ref(*ins)):
        assert _violations(got_o, want_o, LIN_TOL) == 0
        assert _violations(got_s, want_s, STATE_TOL) == 0
    jins = [None if z is None else jnp.asarray(_np(z)) for z in ins]
    refs = [jref.rwkv6_ref(*jins)]
    if t % 16 == 0 and t <= 256:          # the interpreted Pallas kernel
        refs.append(jops.rwkv6(*jins, implementation="interpret"))
    if t % min(32, t) == 0:
        refs.append(jops.rwkv6(*jins, implementation="xla"))
    for want_o, want_s in refs:
        assert _violations(got_o, want_o, LIN_TOL) == 0
        assert _violations(got_s, want_s, STATE_TOL) == 0


@pytest.mark.parametrize("span_chunks", [1, 2, 3, 8, SPAN_CHUNKS, 64])
def test_any_span_gives_the_same_function(span_chunks):
    ins = _inputs(1, 1000, 2, 64, 64, "weak", True, seed=3)
    got_o, got_s = wkv_emulation(*ins, span_chunks=span_chunks)
    want_o, want_s = xla_linear.rwkv6(*ins)
    assert _violations(got_o, want_o, LIN_TOL) == 0
    assert _violations(got_s, want_s, STATE_TOL) == 0


@pytest.mark.parametrize("split", [377, 512])
def test_two_chained_halves_equal_one_whole(split):
    r, k, v, w, u, _ = _inputs(1, 1000, 4, 64, 64, "weak", False, seed=5)
    sc = lambda t: plan(1, t, 4, 64, 64, True, H100_SMS).span_chunks  # noqa
    whole_o, whole_s = wkv_emulation(r, k, v, w, u, span_chunks=sc(1000))
    o1, s1 = wkv_emulation(r[:, :split], k[:, :split], v[:, :split],
                           w[:, :split], u, span_chunks=sc(split))
    o2, s2 = wkv_emulation(r[:, split:], k[:, split:], v[:, split:],
                           w[:, split:], u, s1, span_chunks=sc(1000 - split))
    assert _violations(torch.cat([o1, o2], 1), whole_o, LIN_TOL) == 0
    assert _violations(s2, whole_s, STATE_TOL) == 0


def _flips(got, want):
    """The share of bfloat16 outputs that differ from ``want``'s."""
    return float((got.float() != want.float()).float().mean())


@pytest.fixture(scope="module")
def long_weak():
    """rwkv6-3b's head shape over 4096 tokens with a state, weak decay (the
    carried state, and so the state's product, dominates), and the plain
    version's outputs at its chunks of 32 and 16."""
    ins = _inputs(1, 4096, 2, 64, 64, "weak", True, seed=11)
    return ins, xla_linear.rwkv6(*ins), xla_linear.rwkv6(*ins, chunk=16)


@pytest.mark.parametrize("terms,within", [(3, True), (2, True), (1, False)])
def test_rounding_of_the_decayed_k_against_the_limits(long_weak, terms,
                                                      within):
    """Three bfloat16 terms (the kernel's) and two hold both limits; one
    term (~8 bits) moves the float32 final state past STATE_TOL."""
    ins, (want_o, want_s), _ = long_weak
    got_o, got_s = wkv_emulation(*ins, span_chunks=SPAN_CHUNKS, terms=terms)
    bad = (_violations(got_o, want_o, LIN_TOL)
           + _violations(got_s, want_s, STATE_TOL))
    assert (bad == 0) is within


def test_three_terms_flip_no_more_outputs_than_float32_order(long_weak):
    """The outputs' bfloat16 roundings against the plain version at its
    chunk of 32: three terms flip at most twice as many as the plain version
    does at the kernel's own chunk of 16 (float32 summation order); two
    terms flip more than three times as many, one more still."""
    ins, (want, _), (order16, _) = long_weak
    order = _flips(order16, want)
    flips = {n: _flips(wkv_emulation(*ins, span_chunks=SPAN_CHUNKS,
                                     terms=n)[0], want) for n in (1, 2, 3)}
    assert 0 < flips[3] <= 2 * order
    assert flips[2] > 3 * order
    assert flips[1] > flips[2]


@pytest.mark.parametrize("spans", [1, 5, 16])
def test_shared_state_pass_keeps_mamba2s_values_and_takes_a_row_decay(spans):
    """``state_pass.cuh`` at R = 1 is mamba2's pass 2 (one decay a span),
    value for value; at R = Dk each row of the state takes its own decay."""
    g = torch.Generator().manual_seed(spans)
    bh, dk, dv = 3, 8, 12
    local = torch.randn(bh, spans, dk * dv, generator=g)
    h0 = torch.randn(bh, dk * dv, generator=g)
    dec1 = torch.rand(bh, spans, 1, generator=g)
    # mamba2's pass 2 (tests/test_torch_mamba2_chunks.py::ssd_emulation)
    run, enter = h0, []
    for j in range(spans):
        enter.append(run)
        run = dec1[:, j, 0][:, None] * run + local[:, j]
    got_enter, got_final = state_pass(local, dec1, h0, 1)
    assert torch.equal(got_enter, torch.stack(enter, 1))
    assert torch.equal(got_final, run)
    # per row: H_{j+1}[d, e] = D_j[d] H_j[d, e] + S_j[d, e]
    decd = torch.rand(bh, spans, dk, generator=g)
    run = h0.reshape(bh, dk, dv)
    for j in range(spans):
        run = decd[:, j, :, None] * run + local[:, j].reshape(bh, dk, dv)
    _, got_final = state_pass(local, decd, h0, dk)
    assert torch.equal(got_final.reshape(bh, dk, dv), run)
    # and the decay of a row is not its neighbour's
    assert not torch.equal(state_pass(local, decd.flip(2), h0, dk)[1],
                           got_final)


@pytest.mark.parametrize("fn", ["rwkv6", "mamba2"])
def test_plain_versions_compute_in_float64_for_float64_inputs(fn):
    """float64 inputs: float64 outputs and states, the same at chunks 16
    and 32 (rwkv6; 64 and 128, mamba2) to 1e-12: the readings float32
    rounding is judged against.  float32 and bfloat16 inputs compute in
    float32 as before (tests/test_torch_linear.py)."""
    if fn == "rwkv6":
        ins = [z.double() for z in _inputs(1, 1000, 2, 32, 48, "wide", True,
                                           seed=2)]
        chunks = (16, 32)
    else:
        rng = np.random.default_rng(2)
        f = lambda *s: torch.from_numpy(rng.standard_normal(s))  # noqa: E731
        ins = [f(1, 1000, 2, 24), -torch.exp(0.5 * f(1, 1000, 2)),
               f(1, 1000, 2, 16) * 0.25, f(1, 1000, 2, 16) * 0.25,
               f(1, 2, 16, 24) * 0.25]
        chunks = (64, 128)
    outs = [getattr(xla_linear, fn)(*ins, chunk=c) for c in chunks]
    for o, s in outs:
        assert o.dtype == s.dtype == torch.float64
    assert float((outs[0][0] - outs[1][0]).abs().max()) < 1e-12
    assert float((outs[0][1] - outs[1][1]).abs().max()) < 1e-12
    # float32 inputs: float32 results, and the float64 run within 1e-5
    o32, s32 = getattr(xla_linear, fn)(*(z.float() for z in ins))
    assert o32.dtype == s32.dtype == torch.float32
    assert float((o32.double() - outs[1][0]).abs().max()) < 1e-5


def test_plan_at_rwkv6_3bs_forward_fills_the_card():
    # B1 T4096 H40 Dk=Dv=64 bfloat16: 256-token spans, one column block,
    # 640 CTAs a pass; 10.5 MB of span states (50 MB of L2)
    p = plan(1, 4096, 40, 64, 64, True, H100_SMS)
    assert p == ("tc", 16, 16, 1, 640, 16 * 40 * 64 * 64 * 4)
    assert p.ctas >= CTAS_PER_SM * H100_SMS and p.state_bytes < 50e6
    # float32 takes the SIMT route, the same geometry
    assert plan(1, 4096, 40, 64, 64, False, H100_SMS)[:5] == \
        ("simt", 16, 16, 1, 640)


def test_plan_is_pure():
    args = (2, 1000, 40, 64, 64, True, H100_SMS)
    assert plan(*args) == plan(*args)
    assert plan(*args) is not plan(*args)


@pytest.mark.parametrize("t", [1, 15, 16, 17, 128, 200, 1000, 1024, 4096,
                               20000])
@pytest.mark.parametrize("h", [40, 2])
def test_plan_covers_t_in_spans_and_never_one_span_of_many(t, h):
    p = plan(1, t, h, 64, 64, True, H100_SMS)
    chunks = math.ceil(t / CHUNK)
    assert p.span_chunks in (1, 2, 4, 8, 16)
    assert p.spans == math.ceil(chunks / p.span_chunks)
    assert (p.spans - 1) * p.span_chunks < chunks <= p.spans * p.span_chunks
    assert chunks == 1 or p.spans >= 2      # no CTA walks every chunk of T
    assert p.state_bytes == p.spans * h * 64 * 64 * 4
    assert p.ctas == p.spans * h


@pytest.mark.parametrize("t", [1, 16, 128, 1024])
def test_plan_halves_the_span_at_short_t(t):
    # rwkv6-3b's heads: a serving prefill of 128-1024 tokens
    p = plan(1, t, 40, 64, 64, True, H100_SMS)
    assert p.span_chunks < SPAN_CHUNKS
    assert p.ctas >= CTAS_PER_SM * H100_SMS or p.span_chunks == 1


@pytest.mark.parametrize("dv", [16, 40, 48, 64, 128, 200])
def test_plan_column_blocks_cover_dv(dv):
    p = plan(2, 300, 3, 64, dv, True, H100_SMS)
    assert (p.col_blocks - 1) * COLUMNS < dv <= p.col_blocks * COLUMNS
    assert p.ctas == p.spans * 3 * p.col_blocks * 2
    assert p.state_bytes == p.spans * 2 * 3 * 64 * dv * 4


def test_cpu_wrapper_takes_the_plain_version():
    ins = _inputs(1, 100, 2, 16, 8, "strong", True, seed=1)
    for got, want in zip(rwkv6(*ins), xla_linear.rwkv6(*ins)):
        assert torch.equal(got, want)
