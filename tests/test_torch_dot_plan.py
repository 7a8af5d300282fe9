"""The DOT kernel's geometry and the wrapper's block contract, on the CPU.

``dotprod.plan`` is the geometry ``csrc/dotprod.cu`` runs: a few CTAs per SM,
each over a contiguous span of whole warp-wide 16-byte vector rounds, then a
fixed-order sum of their partials.  It depends on the length, the element
size and the SM count, never on the co-designed block, which the wrapper
still validates (any positive bk; 0 or less raises) and clamps to the length
as the reference does.  ``two_pass_emulation`` is the kernel's decomposition
in torch float32: each thread's vectors into its unrolled accumulators, the
threads of a CTA, then the partials.  The kernel itself runs only on the
card (``tests/test_torch_kernels_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as R_ops
from repro_torch.kernels import dot, ref
from repro_torch.kernels.dotprod import CTAS_PER_SM, THREADS, plan

H100_SMS = 132
UNROLL = 4                    # csrc/dotprod.cu
BKS = [1, 17, 96, 2048, 131072, 10 ** 6]


@pytest.mark.parametrize("k", [1, 1000, 5000, 65536, 10 ** 6 + 3, 1 << 24])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_plan_ignores_the_block_and_clamps_it(k, itemsize):
    plans = [plan(k, itemsize, H100_SMS, bk) for bk in BKS]
    assert len({(p.ctas, p.span) for p in plans}) == 1
    for bk, p in zip(BKS, plans):
        assert p.block == min(bk, k)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_plan_fills_the_card_in_whole_vector_rounds(itemsize):
    k = 1 << 24
    p = plan(k, itemsize, H100_SMS, 131072)
    vector_round = 32 * 16 // itemsize       # one 16-byte vector a lane
    assert p.span % vector_round == 0
    assert p.ctas * p.span >= k > (p.ctas - 1) * p.span    # none empty
    # a few CTAs on every SM, in one wave
    assert (CTAS_PER_SM - 1) * H100_SMS < p.ctas <= CTAS_PER_SM * H100_SMS


@pytest.mark.parametrize("k", [1, 1000, 5000])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_small_k_takes_one_cta(k, itemsize):
    p = plan(k, itemsize, H100_SMS, 17)
    assert (p.ctas, p.block) == (1, min(17, k)) and p.span >= k


@pytest.mark.parametrize("bk", BKS)
def test_wrapper_takes_any_positive_block(bk):
    rng = np.random.default_rng(bk)
    a, b = (rng.standard_normal(5000).astype(np.float32) for _ in range(2))
    got = dot(torch.from_numpy(a), torch.from_numpy(b), bk=bk)
    want = R_ops.dot(jnp.asarray(a), jnp.asarray(b), bk=128,
                     implementation="interpret")
    assert got.shape == (1, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-3)


@pytest.mark.parametrize("bk", [0, -1, -4096])
def test_wrapper_refuses_a_block_that_is_not_positive(bk):
    with pytest.raises(ValueError, match="positive"):
        dot(torch.zeros(16), torch.zeros(16), bk=bk)


def two_pass_emulation(a, b, p, offset=0):
    """The kernel's sum of a . b (1-D float32 tensors whose first element
    lies ``offset`` elements past a 16-byte boundary, the same for both) on
    plan ``p``: in each CTA's span a scalar head to the boundary, vectors of
    16 bytes (vector v to thread v % THREADS, accumulator (v // THREADS) %
    UNROLL), a scalar tail; the accumulators as a pair of pairs, the
    threads, then the partials in order."""
    vec = 16 // a.element_size()
    prods = a.float() * b.float()
    partials = []
    for c in range(p.ctas):
        seg = prods[c * p.span:min((c + 1) * p.span, len(prods))]
        head = min(len(seg), (vec - (offset + c * p.span) % vec) % vec)
        nvec = (len(seg) - head) // vec
        body = seg[head:head + nvec * vec].reshape(nvec, vec).sum(1)
        acc = torch.zeros(THREADS, UNROLL)
        v = torch.arange(nvec)
        acc.index_put_((v % THREADS, (v // THREADS) % UNROLL), body,
                       accumulate=True)
        scalar = torch.zeros(THREADS)
        scalar[:head] += seg[:head]
        tail = seg[head + nvec * vec:]
        scalar[:len(tail)] += tail
        per_thread = scalar + ((acc[:, 0] + acc[:, 1]) +
                               (acc[:, 2] + acc[:, 3]))
        partials.append(per_thread.sum())
    return torch.stack(partials).sum().reshape(1, 1)


@pytest.mark.parametrize("k", [1000, 5000, 300000, 2 ** 20 + 5])
@pytest.mark.parametrize("offset", [0, 3])
def test_two_pass_emulation_matches_plain_and_reference(k, offset):
    rng = np.random.default_rng(k + offset)
    a, b = (rng.standard_normal(k).astype(np.float32) for _ in range(2))
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    got = two_pass_emulation(at, bt, plan(k, 4, H100_SMS, 131072), offset)
    scale = np.sqrt(k)              # a sum of k unit products: std sqrt(k)
    np.testing.assert_allclose(got.numpy(), ref.dot_ref(at, bt).numpy(),
                               rtol=1e-5, atol=1e-5 * scale)
    want = R_ops.dot(jnp.asarray(a), jnp.asarray(b), bk=2048,
                     implementation="interpret")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * scale)
