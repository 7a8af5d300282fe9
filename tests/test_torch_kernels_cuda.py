"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Every test here needs a CUDA device and skips where there is
none (the kernels have no CPU mode).

This file imports neither JAX nor the reference package, so it also runs
on the card's machine, which has no JAX:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerances are those of ``tests/test_kernels.py``: float32 rtol 1e-5 (conv
1e-4), bfloat16 rtol 5e-2, with atol ten times rtol (conv 2e-3).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import conv2d, dot, gemm, gemv, ops, ref

RNG = np.random.default_rng(7)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BLOCKS = [(32, 32, 32), (17, 96, 512), (2048, 2048, 2048), (1, 1, 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _on(dev, *shape, dtype=torch.float32):
    return torch.as_tensor(RNG.standard_normal(shape), dtype=dtype, device=dev)


def _tol(dtype, conv=False):
    if dtype == "bfloat16":
        return 5e-2, 5e-1
    return (1e-4, 2e-3) if conv else (1e-5, 1e-4)


def _close(got, want, rtol, atol):
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("blocks", BLOCKS)
def test_gemm_kernel_matches_plain(cuda, dtype, blocks):
    bm, bn, bk = blocks
    a = _on(cuda, 96, 80, dtype=DTYPES[dtype])
    b = _on(cuda, 80, 72, dtype=DTYPES[dtype])
    before = gemm.launches
    _close(gemm(a, b, bm=bm, bn=bn, bk=bk), ref.gemm_ref(a, b), *_tol(dtype))
    assert gemm.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("blocks", BLOCKS)
def test_gemv_kernel_matches_plain(cuda, dtype, blocks):
    bm, _, bk = blocks
    a = _on(cuda, 133, 257, dtype=DTYPES[dtype])
    x = _on(cuda, 257, dtype=DTYPES[dtype])
    _close(gemv(a, x, bm=bm, bk=bk), ref.gemv_ref(a, x), *_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bk", [1, 17, 2048, 100000])
def test_dot_kernel_is_deterministic_and_matches_plain(cuda, dtype, bk):
    u = _on(cuda, 5000, dtype=DTYPES[dtype])
    v = _on(cuda, 5000, dtype=DTYPES[dtype])
    d1, d2 = dot(u, v, bk=bk), dot(u, v, bk=bk)
    assert d1.shape == (1, 1) and d1.dtype == torch.float32
    assert torch.equal(d1, d2)                 # same bits on every run
    rtol, atol = _tol(dtype)
    _close(d1, ref.dot_ref(u, v), rtol, atol * 10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,bk", [((24, 16, 18, 20, 3), 17),
                                      ((8, 4, 9, 9, 1), 96),
                                      ((16, 3, 40, 33, 7), 5),
                                      ((40, 8, 12, 30, 2), 1)])
def test_conv2d_kernel_matches_plain(cuda, dtype, shape, bk):
    kk, c, h, w, r = shape
    a = _on(cuda, c, h, w, dtype=DTYPES[dtype])
    wt = _on(cuda, kk, c, r, r, dtype=DTYPES[dtype])
    _close(conv2d(a, wt, bk=bk), ref.conv2d_ref(a, wt),
           *_tol(dtype, conv=True))


@pytest.mark.cuda
def test_ops_dispatch_on_the_card(cuda):
    a, b = _on(cuda, 64, 48), _on(cuda, 48, 40)
    before = gemm.launches
    _close(ops.matmul(a, b, implementation="cuda"), ref.gemm_ref(a, b),
           1e-5, 1e-4)
    assert gemm.launches == before + 1
    with pytest.raises(ValueError, match="cpu"):
        ops.matmul(a, b, implementation="torch")   # CUDA tensors, CPU path
    with pytest.raises(ValueError):
        gemm(a, b.cpu())                            # operands on two devices
    with pytest.raises(ValueError, match="contiguous"):
        gemm(a.t().contiguous().t(), b)             # a strided view
