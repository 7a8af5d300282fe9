"""The port's RWKV-6 and Mamba-2 recurrences against the reference's, on the
CPU: the sequential oracles (``kernels/ref.py``), the plain chunked versions
(``kernels/xla_linear.py``) and ``ops`` dispatch with implementation
'torch', against ``repro.kernels.ref`` and ``repro.kernels.ops`` run with
the Pallas kernels interpreted and with their 'xla' versions.

Inputs are made with numpy and drawn so that outputs are O(1): r, k, b, c
scaled by Dk^-0.5 (N^-0.5).  Weak decay (w = -exp(N(-6, 0.5)), a ~ -1e-3)
makes the state carried across chunks dominate the outputs, so a dropped
inter-chunk term shows; strong decay (w, a = -exp(N(0, 0.5))) tests the
pairwise and diagonal terms.  Tolerance rtol/atol 1e-4 on outputs and
states: the same float32 math summed in other orders (chunks of 32 or 128
here, 16 or 64 in the Pallas kernels, one token at a time in the oracles).

The reference asserts T % chunk == 0; the port takes any T >= 1, held
against the reference's sequential oracles at ragged lengths.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import mamba2, ops, ref, rwkv6, xla_linear

RTOL = ATOL = 1e-4
DECAYS = ("strong", "weak")


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _rwkv6_inputs(b, t, h, dk, dv, decay, state, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    r, k = f(b, t, h, dk) * dk ** -0.5, f(b, t, h, dk) * dk ** -0.5
    v, u = f(b, t, h, dv), f(h, dk) * 0.5
    mean = -6.0 if decay == "weak" else 0.0
    w = -np.exp(mean + 0.5 * f(b, t, h, dk))
    s0 = f(b, h, dk, dv) * dk ** -0.5 if state else None
    return r, k, v, w, u, s0


def _mamba2_inputs(b, t, h, p, n, decay, state, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = f(b, t, h, p)
    a = (-1e-3 * np.exp(0.1 * f(b, t, h)) if decay == "weak"
         else -np.exp(0.5 * f(b, t, h)))
    bb, cc = f(b, t, h, n) * n ** -0.5, f(b, t, h, n) * n ** -0.5
    s0 = f(b, h, n, p) * n ** -0.5 if state else None
    return x, a.astype(np.float32), bb, cc, s0


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


# -- T a multiple of every reference chunk (16/32 for rwkv6, 64/128 mamba2)

@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("state", [False, True], ids=["no-state", "state"])
@pytest.mark.parametrize("dims", [(2, 64, 3, 16, 16), (1, 128, 2, 8, 24)],
                         ids=["Dk=Dv", "Dk!=Dv"])
def test_rwkv6_matches_the_reference(dims, state, decay):
    arrays = _rwkv6_inputs(*dims, decay, state)
    want_o, want_s = jref.rwkv6_ref(*_jax(*arrays))
    got_o, got_s = ref.rwkv6_ref(*_torch(*arrays))
    _close(got_o, want_o)
    _close(got_s, want_s)
    assert float(got_o.abs().max()) > 0.3    # O(1), not vanishing
    plain = xla_linear.rwkv6(*_torch(*arrays))
    assert plain[0].dtype == torch.float32 and plain[1].dtype == torch.float32
    for impl in ("interpret", "xla"):
        jo, js = jops.rwkv6(*_jax(*arrays), implementation=impl)
        _close(plain[0], jo)
        _close(plain[1], js)
    # dispatch and the kernel's wrapper take the plain version on the CPU
    for o, s in (ops.rwkv6(*_torch(*arrays), implementation="torch"),
                 rwkv6(*_torch(*arrays))):
        assert torch.equal(o, plain[0]) and torch.equal(s, plain[1])


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("state", [False, True], ids=["no-state", "state"])
@pytest.mark.parametrize("dims", [(2, 128, 3, 16, 16), (1, 64, 4, 8, 12)],
                         ids=["N=P", "N!=P"])
def test_mamba2_matches_the_reference(dims, state, decay):
    arrays = _mamba2_inputs(*dims, decay, state)
    want_y, want_s = jref.mamba2_ref(*_jax(*arrays))
    got_y, got_s = ref.mamba2_ref(*_torch(*arrays))
    _close(got_y, want_y)
    _close(got_s, want_s)
    assert float(got_y.abs().max()) > 0.3
    plain = xla_linear.mamba2(*_torch(*arrays))
    for impl in ("interpret", "xla"):
        jy, js = jops.mamba2(*_jax(*arrays), implementation=impl)
        _close(plain[0], jy)
        _close(plain[1], js)
    for y, s in (ops.mamba2(*_torch(*arrays), implementation="torch"),
                 mamba2(*_torch(*arrays))):
        assert torch.equal(y, plain[0]) and torch.equal(s, plain[1])


def test_mamba2_reads_b_and_c_shared_across_heads():
    """One group of b/c as stride-0 views over the heads, read as each
    head's own."""
    x, a, bb, cc, s0 = _mamba2_inputs(2, 70, 4, 8, 8, "weak", True)
    tx, ta, ts = _torch(x, a, s0)
    b1 = torch.from_numpy(bb[:, :, :1]).expand(2, 70, 4, 8)
    c1 = torch.from_numpy(cc[:, :, :1]).expand(2, 70, 4, 8)
    assert b1.stride(2) == 0
    got = xla_linear.mamba2(tx, ta, b1, c1, ts)
    want = jref.mamba2_ref(*_jax(x, a, np.repeat(bb[:, :, :1], 4, 2),
                                 np.repeat(cc[:, :, :1], 4, 2), s0))
    _close(got[0], want[0])
    _close(got[1], want[1])


# -- any T: ragged lengths against the reference's sequential oracles -------

@pytest.mark.parametrize("t", [1, 17, 37, 100])
@pytest.mark.parametrize("decay", DECAYS)
def test_rwkv6_takes_any_length(t, decay):
    arrays = _rwkv6_inputs(2, t, 2, 16, 8, decay, True, seed=t)
    want_o, want_s = jref.rwkv6_ref(*_jax(*arrays))
    for o, s in (xla_linear.rwkv6(*_torch(*arrays)),
                 ops.rwkv6(*_torch(*arrays), implementation="torch")):
        assert o.shape == (2, t, 2, 8)
        _close(o, want_o)
        _close(s, want_s)


@pytest.mark.parametrize("t", [1, 17, 37, 100, 130])
@pytest.mark.parametrize("decay", DECAYS)
def test_mamba2_takes_any_length(t, decay):
    arrays = _mamba2_inputs(2, t, 2, 8, 16, decay, True, seed=t)
    want_y, want_s = jref.mamba2_ref(*_jax(*arrays))
    for y, s in (xla_linear.mamba2(*_torch(*arrays)),
                 ops.mamba2(*_torch(*arrays), implementation="torch")):
        assert y.shape == (2, t, 2, 8)
        _close(y, want_y)
        _close(s, want_s)


@pytest.mark.parametrize("split", [1, 16, 37])
def test_two_halves_equal_one_whole(split):
    """Streaming: the final state of the first call seeds the second."""
    r, k, v, w, u, _ = _torch(*_rwkv6_inputs(1, 80, 2, 16, 16, "weak",
                                             False))
    whole = xla_linear.rwkv6(r, k, v, w, u)
    o1, s1 = xla_linear.rwkv6(r[:, :split], k[:, :split], v[:, :split],
                              w[:, :split], u)
    o2, s2 = xla_linear.rwkv6(r[:, split:], k[:, split:], v[:, split:],
                              w[:, split:], u, s1)
    _close(torch.cat([o1, o2], 1), whole[0])
    _close(s2, whole[1])
    x, a, b, c, _ = _torch(*_mamba2_inputs(1, 150, 2, 8, 8, "weak", False))
    whole = xla_linear.mamba2(x, a, b, c)
    y1, h1 = xla_linear.mamba2(x[:, :split], a[:, :split], b[:, :split],
                               c[:, :split])
    y2, h2 = xla_linear.mamba2(x[:, split:], a[:, split:], b[:, split:],
                               c[:, split:], h1)
    _close(torch.cat([y1, y2], 1), whole[0])
    _close(h2, whole[1])


def test_bfloat16_inputs_round_the_output_once():
    arrays = _rwkv6_inputs(1, 40, 2, 16, 16, "strong", True)
    tr = [t.to(torch.bfloat16) for t in _torch(*arrays[:5])]
    o, s = xla_linear.rwkv6(*tr, _torch(arrays[5])[0])
    want = ref.rwkv6_ref(*[t.float() for t in tr], _torch(arrays[5])[0])
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    _close(o, want[0].to(torch.bfloat16).float(), rtol=2 ** -7, atol=1e-3)
    _close(s, want[1])


def test_dispatch_checks_devices_and_shapes():
    r, k, v, w, u, s0 = _torch(*_rwkv6_inputs(1, 8, 2, 4, 4, "strong", True))
    with pytest.raises(ValueError, match="cuda"):
        ops.rwkv6(r, k, v, w, u, s0, implementation="cuda")
    with pytest.raises(ValueError, match="implementation"):
        ops.rwkv6(r, k, v, w, u, implementation="xla")
    with pytest.raises(ValueError, match=r"\(H, Dk\)"):
        rwkv6(r, k, v, w, u.T)
    with pytest.raises(TypeError, match="dtypes"):
        rwkv6(r, k, v.double(), w, u)
    x, a, b, c, h0 = _torch(*_mamba2_inputs(1, 8, 2, 4, 4, "strong", True))
    with pytest.raises(ValueError, match="cuda"):
        ops.mamba2(x, a, b, c, h0, implementation="cuda")
    with pytest.raises(ValueError, match=r"\(B, H, N, P\)"):
        mamba2(x, a, b, c, h0[:, :1])
    with pytest.raises(TypeError, match="chunk"):
        ops.mamba2(x, a, b, c, chunk=64)     # the kernel's chunk is fixed
