"""The GEMV kernel's geometry and the wrapper's block contract, on the CPU.

``gemv.plan`` is the geometry ``csrc/gemv.cu`` runs: one warp a row, 8 rows
a CTA, and K split over CTAs only where the row CTAs are fewer than two per
SM.  It depends on the shape, the element size and the SM count, never on
the co-designed block, which the wrapper still validates (any positive
block, 0 or less raises) and clamps to the dims as the reference does.  The
kernel itself runs only on the card (``tests/test_torch_kernels_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as R_ops
from repro_torch.kernels import gemv
from repro_torch.kernels.gemv import CTAS_PER_SM, ROWS_PER_CTA, plan

H100_SMS = 132
BLOCKS = [(1, 1), (17, 96), (512, 512), (4096, 4096), (10 ** 6, 10 ** 6)]


@pytest.mark.parametrize("shape", [(4096, 4096), (2048, 4096), (100, 9000),
                                   (33, 257), (1, 100000), (9, 20001)])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_plan_ignores_the_block_and_clamps_it(shape, itemsize):
    m, k = shape
    plans = [plan(m, k, itemsize, H100_SMS, bm, bk) for bm, bk in BLOCKS]
    assert len({(p.splits, p.span) for p in plans}) == 1
    for (bm, bk), p in zip(BLOCKS, plans):
        assert p.block == (min(bm, m), min(bk, k))


@pytest.mark.parametrize("shape", [(4096, 4096), (2048, 4096), (100, 9000),
                                   (33, 257), (1, 100000), (9, 20001),
                                   (2112, 64)])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_plan_splits_k_only_where_rows_leave_sms_idle(shape, itemsize):
    m, k = shape
    p = plan(m, k, itemsize, H100_SMS, 512, 512)
    row_ctas = -(-m // ROWS_PER_CTA)
    if row_ctas >= CTAS_PER_SM * H100_SMS:
        assert (p.splits, p.span) == (1, k)
        return
    vector_round = 32 * 16 // itemsize       # one 16-byte vector a lane
    assert p.span % vector_round == 0
    assert p.splits * p.span >= k > (p.splits - 1) * p.span  # none empty
    assert p.splits <= 65535


def test_main_path_shape_fills_the_card_at_its_committed_block():
    # 4096 rows: 512 CTAs whatever the block, where one CTA per bm rows
    # gave a single CTA at the committed bm = 4096
    p = plan(4096, 4096, 4, H100_SMS, 4096, 4096)
    assert (p.splits, -(-4096 // ROWS_PER_CTA)) == (1, 512)
    # few rows: K is split until the CTAs cover two per SM
    p = plan(100, 9000, 4, H100_SMS, 2048, 4096)
    assert -(-100 // ROWS_PER_CTA) * p.splits >= H100_SMS


@pytest.mark.parametrize("bm,bk", BLOCKS)
def test_wrapper_takes_any_positive_block(bm, bk):
    rng = np.random.default_rng(bm + bk)
    a = rng.standard_normal((33, 257)).astype(np.float32)
    x = rng.standard_normal(257).astype(np.float32)
    got = gemv(torch.from_numpy(a), torch.from_numpy(x), bm=bm, bk=bk)
    want = R_ops.matvec(jnp.asarray(a), jnp.asarray(x), bm=8, bk=128,
                        implementation="interpret")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("bm,bk", [(0, 512), (512, 0), (-1, 8)])
def test_wrapper_refuses_a_block_that_is_not_positive(bm, bk):
    a, x = torch.zeros(8, 16), torch.zeros(16)
    with pytest.raises(ValueError, match="positive"):
        gemv(a, x, bm=bm, bk=bk)
