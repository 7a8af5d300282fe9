"""The port's attention against the reference's, on the CPU.

The port's plain version (``repro_torch.kernels.xla_attention``, what
``ops.attention(implementation="torch")`` and the flash wrapper run on CPU
tensors) and its oracle ``ref.attention_ref`` are held against the
reference's Pallas flash kernel run in interpret mode, its chunked 'xla'
attention and its ``attention_ref``, on the same inputs made with numpy, at
rtol/atol 1e-3 (the tolerance of ``tests/test_kernels.py``).  The CUDA
kernel itself runs only on the card (``tests/test_torch_kernels_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention, ops, ref, xla_attention

RTOL = ATOL = 1e-3

# the cases of tests/test_kernels.py (Sq < Skv, GQA 2), plus hubert's head
# dim 80 with a GQA group of 4 at Sq == Skv (the forward's shape), and one
# query against a longer cache
GQA = ((2, 40, 4, 32), (2, 56, 2, 32))
D80 = ((1, 33, 8, 80), (1, 33, 2, 80))
ONE_QUERY = ((3, 1, 4, 16), (3, 33, 4, 16))
ATTN_CASES = [(GQA, dict()), (GQA, dict(softcap=20.0)), (GQA, dict(window=8)),
              (GQA, dict(causal=False)), (GQA, dict(softcap=30.0, window=16)),
              (D80, dict()), (D80, dict(causal=False, window=5)),
              (ONE_QUERY, dict())]


def _qkv(qshape, kshape, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * 0.5).astype(np.float32)
            for s in (qshape, kshape, kshape)]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shapes,kw", ATTN_CASES)
def test_plain_attention_matches_reference(shapes, kw):
    q, k, v = _qkv(*shapes, seed=len(str(kw)))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    got = ops.attention(tq, tk, tv, implementation="torch", **kw)
    assert got.dtype == torch.float32 and got.shape == tq.shape
    _close(got, jops.attention(jq, jk, jv, bq=16, bkv=16,
                               implementation="interpret", **kw))
    _close(got, jops.attention(jq, jk, jv, implementation="xla", **kw))
    _close(got, jref.attention_ref(jq, jk, jv, **kw))
    _close(ref.attention_ref(tq, tk, tv, **kw),
           jref.attention_ref(jq, jk, jv, **kw))
    # the kernel's wrapper takes the plain version for CPU tensors
    _close(flash_attention(tq, tk, tv, **kw), got)


def test_plain_attention_chunking_is_invisible():
    q, k, v = (torch.from_numpy(a) for a in
               _qkv((2, 40, 4, 32), (2, 56, 2, 32), seed=3))
    whole = xla_attention.attention(q, k, v, softcap=20.0, window=8)
    for chunk in (1, 7, 16, 1000):
        torch.testing.assert_close(
            xla_attention.attention(q, k, v, softcap=20.0, window=8,
                                    chunk=chunk), whole,
            rtol=1e-5, atol=1e-6)


def test_explicit_scale_and_bfloat16_inputs():
    q, k, v = _qkv((2, 24, 4, 32), (2, 24, 2, 32), seed=4)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    got = ops.attention(tq, tk, tv, scale=0.3, implementation="torch")
    assert got.dtype == torch.bfloat16
    want = jops.attention(jq, jk, jv, scale=0.3, implementation="xla")
    # float32 inside both; the output rounds once to bfloat16, so the two
    # may differ by one ulp (at most 2^-7 of the value)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-3)


def test_rows_without_a_visible_key_are_zero():
    """Sq > Skv under the causal mask leaves the first Sq - Skv queries no
    key.  The port (plain version and, on the card, the kernel) gives zeros
    there, as the reference's 'xla' attention does; the reference's Pallas
    kernel and attention_ref average v instead (ROADMAP C, deviation 3)."""
    q, k, v = _qkv((1, 12, 2, 16), (1, 5, 2, 16), seed=5)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    got = ops.attention(tq, tk, tv, implementation="torch").numpy()
    blind = 12 - 5
    assert np.all(got[:, :blind] == 0.0)
    _close(got, jops.attention(jq, jk, jv, implementation="xla"))
    oracle = np.asarray(jref.attention_ref(jq, jk, jv))
    _close(got[:, blind:], oracle[:, blind:])
    assert not np.allclose(got[:, :blind], oracle[:, :blind])
    pallas = np.asarray(jops.attention(jq, jk, jv, bq=8, bkv=8,
                                       implementation="interpret"))
    _close(got[:, blind:], pallas[:, blind:])
    assert not np.allclose(got[:, :blind], pallas[:, :blind])


def test_dispatch_checks_devices_and_shapes():
    q = torch.zeros(1, 4, 2, 8)
    k = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="runs on cuda"):
        ops.attention(q, k, k, implementation="cuda")
    with pytest.raises(ValueError, match="implementation"):
        ops.attention(q, k, k, implementation="xla")
    with pytest.raises(TypeError, match="bq"):     # no block shape is taken
        ops.attention(q, k, k, bq=64, implementation="torch")
    with pytest.raises(ValueError, match="does not fit"):
        flash_attention(q, torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 3, 8))
    with pytest.raises(ValueError, match="shapes"):
        flash_attention(q, k, torch.zeros(1, 5, 1, 8))
    with pytest.raises(TypeError, match="dtypes"):
        flash_attention(q, k, k.to(torch.bfloat16))
