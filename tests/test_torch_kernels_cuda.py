"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Every test here needs a CUDA device and skips where there is
none (the kernels have no CPU mode).

This file imports neither JAX nor the reference package, so it also runs
on the card's machine, which has no JAX:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerances are those of ``tests/test_kernels.py``: float32 rtol 1e-5 (conv
1e-4), bfloat16 rtol 5e-2, with atol ten times rtol (conv 2e-3).  Flash
attention: float32 rtol/atol 1e-3 (``tests/test_kernels.py:78``), on the
SIMT route (float32 FMA); bfloat16 rtol 1e-2, one bfloat16 ulp of the
output, with atol 1e-3 for outputs near 0.  bfloat16 takes the tensor-core
route: its bfloat16 products are exact in float32 and P is rounded to two
bfloat16 terms (P_hi + P_lo, ~16 bits), so it is as close to float32 as the
plain version, and both round the output once (P in one term would move
near-cancelling outputs past atol: ``tests/test_torch_flash_route.py``).
Its q is drawn with std 3, so the scores have std 3 and each row's output,
led by a few keys, is O(1): a dropped or misweighted key tile shows far
above atol.
RWKV-6 and Mamba-2 against their plain chunked versions: float32 rtol/atol
1e-4 (the same float32 math summed in other orders and chunks), bfloat16
outputs rtol 1e-2 / atol 1e-3 (one bfloat16 ulp: both round a float32
result once), final states float32 at 1e-4 in both.  Their inputs are
scaled so outputs are O(1), and the weak-decay cases make the state carried
across chunks dominate, so a dropped inter-chunk term shows.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import (GLUE, MAMBA2_GLUE, conv2d, dot,
                                 flash_attention, gemm, gemv, glue_common,
                                 mamba2, mamba2_glue, ops, plain, ref, rwkv6,
                                 rwkv6_glue, xla_attention, xla_linear)
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.bank_mm import bank_mm, bank_mm_plain
from repro_torch.kernels.conv2d import plan as conv_plan
from repro_torch.kernels.flash_attention import route
from repro_torch.kernels.gemm import plan as gemm_plan

RNG = np.random.default_rng(7)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BLOCKS = [(32, 32, 32), (17, 96, 512), (2048, 2048, 2048), (1, 1, 1)]
# every CTA tile gemm and conv2d are compiled for (kernels/gemm.py,
# kernels/conv2d.py)
GEMM_TILES = [(tm, tn, tk) for tm in (32, 64) for tn in (32, 64)
              for tk in (8, 16, 32)]
CONV_TILES = (32, 64, 128)


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
@pytest.mark.parametrize("shape,blocks,offset", [
    ((4096, 4096), (4096, 4096), 0),    # the block that once gave one CTA
    ((512, 1000), (10 ** 6, 10 ** 6), 0),
    ((300, 1003), (64, 64), 0),         # K ragged: rows not 16-byte aligned
    ((300, 1024), (64, 64), 3),         # A and x start off 16 bytes
    ((7, 50000), (7, 50000), 0),        # short and wide: K split over CTAs
    ((9, 20001), (1, 1), 5),
])
def test_gemv_kernel_is_bit_stable_at_any_block(cuda, dtype, shape, blocks,
                                                offset):
    m, k = shape
    buf = _on(cuda, m * k + k + 2 * offset, dtype=DTYPES[dtype])
    a = buf[offset:offset + m * k].view(m, k)
    x = buf[m * k + 2 * offset:]
    before = gemv.launches
    y1 = gemv(a, x, bm=blocks[0], bk=blocks[1])
    y2 = gemv(a, x, bm=blocks[0], bk=blocks[1])
    assert gemv.launches == before + 2
    assert torch.equal(y1, y2)                  # same bits on every run
    rtol, atol = _tol(dtype)
    _close(y1, ref.gemv_ref(a, x), rtol, atol)


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
def test_dot_kernel_gives_the_same_bits_at_any_block(cuda, dtype):
    # many CTAs: the plan, not bk, sets the geometry and the summation order
    u = _on(cuda, 1 << 22, dtype=DTYPES[dtype])
    v = _on(cuda, 1 << 22, dtype=DTYPES[dtype])
    got = [dot(u, v, bk=bk) for bk in (1, 17, 2048, 131072, 10 ** 6)]
    assert all(torch.equal(g, got[0]) for g in got[1:])
    rtol, atol = _tol(dtype)
    _close(got[0], ref.dot_ref(u, v), rtol, atol * 10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [5000, (1 << 20) + 7])
@pytest.mark.parametrize("offsets", [(0, 0), (3, 3), (1, 2), (0, 5)],
                         ids=["aligned", "equal", "different", "b only"])
def test_dot_kernel_reads_misaligned_views(cuda, dtype, k, offsets):
    oa, ob = offsets
    buf = _on(cuda, 2 * k + 16, dtype=DTYPES[dtype])
    u, v = buf[oa:oa + k], buf[k + 8 + ob:2 * k + 8 + ob]
    d1, d2 = dot(u, v, bk=96), dot(u, v, bk=131072)
    assert torch.equal(d1, d2)
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


def _view(dev, offset, *shapes, dtype):
    """Contiguous tensors of ``shapes`` as views into one buffer, the first
    ``offset`` elements in: with an odd offset none is 16-byte aligned."""
    sizes = [int(np.prod(sh)) for sh in shapes]
    buf = _on(dev, offset + sum(sizes), dtype=dtype)
    out, at = [], offset
    for sh, n in zip(shapes, sizes):
        out.append(buf[at:at + n].view(sh))
        at += n
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tile", GEMM_TILES)
def test_gemm_kernel_runs_every_legal_tile(cuda, dtype, tile):
    a, b = _view(cuda, 0, (200, 1000), (1000, 130), dtype=DTYPES[dtype])
    p = gemm_plan(200, 130, 1000, a.element_size(),
                  cuda_lib.sm_count(cuda.index or 0), *tile)
    assert p.tile == tile and p.splits > 1     # ragged, and K split
    before = gemm.launches
    got = gemm(a, b, bm=tile[0], bn=tile[1], bk=tile[2])
    assert gemm.launches == before + 1
    _close(got, ref.gemm_ref(a, b), *_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,blocks,offset", [
    ((64, 64, 4096), (64, 64, 8), 0),         # one tile: K split 256 ways
    ((1024, 1024, 1024), (256, 256, 128), 0),  # the main path's block
    ((300, 200, 1024), (64, 64, 32), 3),       # A and B start off 16 bytes
    ((130, 257, 65), (64, 32, 16), 1),
    ((33, 40, 17), (17, 96, 9), 0),            # K*size not a multiple of 16
    ((50, 20, 777), (1, 1, 1), 0),
])
def test_gemm_kernel_is_bit_stable_split_and_unaligned(cuda, dtype, shape,
                                                       blocks, offset):
    m, n, k = shape
    a, b = _view(cuda, offset, (m, k), (k, n), dtype=DTYPES[dtype])
    bm, bn, bk = blocks
    c1, c2 = gemm(a, b, bm=bm, bn=bn, bk=bk), gemm(a, b, bm=bm, bn=bn, bk=bk)
    assert torch.equal(c1, c2)                  # same bits on every run
    _close(c1, ref.gemm_ref(a, b), *_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tile", CONV_TILES)
def test_conv2d_kernel_runs_every_legal_tile(cuda, dtype, tile):
    a = _on(cuda, 20, 18, 17, dtype=DTYPES[dtype])
    wt = _on(cuda, 130, 20, 3, 3, dtype=DTYPES[dtype])
    p = conv_plan(130, 20, 16, 15, 3, 3, a.element_size(),
                  cuda_lib.sm_count(cuda.index or 0), tile)
    assert p.tile[0] == tile and p.splits > 1
    before = conv2d.launches
    got = conv2d(a, wt, bk=tile)
    assert conv2d.launches == before + 1
    _close(got, ref.conv2d_ref(a, wt), *_tol(dtype, conv=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,bk", [
    ((256, 256, 16, 16, 3, 3), 64),      # the main path's layer, split 24
    ((24, 16, 11, 13, 3, 2), 17),        # R != S, spans end mid-taps
    ((40, 17, 9, 20, 1, 4), 96),
    ((70, 9, 12, 12, 2, 5), 1),
    ((33, 5, 7, 30, 5, 1), 100000),
])
def test_conv2d_kernel_is_bit_stable_split_and_r_ne_s(cuda, dtype, shape,
                                                      bk):
    kk, c, h, w, r, s = shape
    a = _on(cuda, c, h, w, dtype=DTYPES[dtype])
    wt = _on(cuda, kk, c, r, s, dtype=DTYPES[dtype])
    o1, o2 = conv2d(a, wt, bk=bk), conv2d(a, wt, bk=bk)
    assert torch.equal(o1, o2)                  # same bits on every run
    _close(o1, ref.conv2d_ref(a, wt), *_tol(dtype, conv=True))


@pytest.mark.cuda
def test_gemm_and_conv2d_replay_from_a_cuda_graph(cuda):
    """The tiles above 48 KB of shared memory opt in once, outside any
    capture; replayed launches give the eager bits."""
    a, b = _on(cuda, 1024, 1024), _on(cuda, 1024, 1024)
    x, w = _on(cuda, 256, 16, 16), _on(cuda, 256, 256, 3, 3)
    eager = (gemm(a, b, bm=256, bn=256, bk=128), conv2d(x, w, bk=128))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gemm(a, b, bm=256, bn=256, bk=128), conv2d(x, w, bk=128)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = (gemm(a, b, bm=256, bn=256, bk=128), conv2d(x, w, bk=128))
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(o, e) for o, e in zip(outs, eager))


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


FLASH_TOL = {"float32": (1e-3, 1e-3), "bfloat16": (1e-2, 1e-3)}
Q_STD = 3.0
FLASH_CASES = [
    # (B, Sq, Skv, H, Hkv, D, options)
    (2, 40, 56, 4, 2, 32, {}),
    (2, 40, 56, 4, 2, 32, dict(softcap=20.0)),
    (2, 40, 56, 4, 2, 32, dict(window=8)),
    (2, 40, 56, 4, 2, 32, dict(causal=False)),
    (2, 40, 56, 4, 2, 32, dict(softcap=30.0, window=16)),
    (1, 129, 129, 8, 8, 80, dict(causal=False)),
    (1, 100, 170, 4, 2, 256, dict(softcap=50.0, window=33)),
    (3, 1, 200, 8, 2, 128, {}),
    (1, 64, 64, 2, 1, 1, dict(scale=0.7)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, dtype, case):
    b, sq, skv, h, hkv, d, kw = case
    q = (_on(cuda, b, sq, h, d) * Q_STD).to(DTYPES[dtype])
    k = _on(cuda, b, skv, hkv, d, dtype=DTYPES[dtype])
    v = _on(cuda, b, skv, hkv, d, dtype=DTYPES[dtype])
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _close(got, xla_attention.attention(q, k, v, **kw), *FLASH_TOL[dtype])
    if kw.get("causal", True) and "softcap" not in kw and "scale" not in kw:
        _close(ops.attention(q, k, v, implementation="cuda", **kw),
               ref.attention_ref(q, k, v, **kw), *FLASH_TOL[dtype])


TC_CASES = [
    # (B, Sq, Skv, H, Hkv, D, options): every head dim of the models and
    # the tests, GQA, soft-cap, window, non-causal, Sq < Skv, Sq > Skv,
    # one query
    (2, 40, 56, 4, 2, 32, {}),
    (2, 40, 56, 4, 2, 32, dict(softcap=20.0, window=16)),
    (1, 200, 200, 8, 2, 64, dict(causal=False)),
    (1, 70, 30, 4, 2, 64, {}),
    (1, 333, 333, 8, 8, 80, {}),
    (1, 129, 300, 16, 4, 80, dict(window=50)),
    (3, 1, 777, 32, 8, 128, {}),
    (1, 130, 1000, 8, 1, 128, dict(window=100)),
    (1, 256, 256, 4, 2, 128, dict(softcap=30.0, causal=False)),
    (1, 100, 170, 4, 2, 256, dict(softcap=50.0, window=33)),
    (1, 300, 300, 4, 2, 256, {}),
    # zamba2-7b's shared attention: heads of 224, scale (224 / 2)^-0.5
    (1, 333, 333, 4, 4, 224, dict(scale=112 ** -0.5)),
    (1, 4096, 4096, 32, 32, 224, dict(scale=112 ** -0.5)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TC_CASES)
def test_flash_attention_tensor_core_route_matches_plain(cuda, case):
    b, sq, skv, h, hkv, d, kw = case
    q = (_on(cuda, b, sq, h, d) * Q_STD).to(torch.bfloat16)
    k = _on(cuda, b, skv, hkv, d, dtype=torch.bfloat16)
    v = _on(cuda, b, skv, hkv, d, dtype=torch.bfloat16)
    assert route(q, k, v) == "tc"
    before = dict(flash_attention.route_launches)
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.route_launches["tc"] == before["tc"] + 1
    _close(got, xla_attention.attention(q, k, v, **kw), *FLASH_TOL["bfloat16"])
    if kw.get("causal", True) and sq > skv:
        assert torch.equal(got[:, :sq - skv],
                           torch.zeros_like(got[:, :sq - skv]))


@pytest.mark.cuda
@pytest.mark.parametrize("head_stride,want", [(64, "tc"), (68, "simt")])
def test_flash_attention_bf16_views_take_their_route(cuda, head_stride, want):
    packed = _on(cuda, 2, 96, 12, head_stride, dtype=torch.bfloat16)
    packed[:, :, :8] *= Q_STD
    q, k, v = (packed[:, :, :8, :64], packed[:, :, 8:10, :64],
               packed[:, :, 10:, :64])
    assert not q.is_contiguous() and not k.is_contiguous()
    before = dict(flash_attention.route_launches)
    got = flash_attention(q, k, v, window=24)
    torch.cuda.synchronize()
    assert flash_attention.route_launches[want] == before[want] + 1
    _close(got, xla_attention.attention(q, k, v, window=24),
           *FLASH_TOL["bfloat16"])


@pytest.mark.cuda
def test_flash_attention_rows_without_a_key_are_zero(cuda):
    q = _on(cuda, 1, 70, 4, 64) * 0.5
    k = _on(cuda, 1, 30, 2, 64) * 0.5
    got = flash_attention(q, k, k)
    assert torch.equal(got[:, :40], torch.zeros_like(got[:, :40]))
    _close(got, xla_attention.attention(q, k, k), *FLASH_TOL["float32"])


@pytest.mark.cuda
def test_flash_attention_reads_strided_views(cuda):
    packed = _on(cuda, 2, 96, 12, 64)
    q, k, v = packed[:, :, :8], packed[:, :, 8:10], packed[:, :, 10:]
    assert not q.is_contiguous()
    _close(flash_attention(q, k, v, window=24),
           xla_attention.attention(q, k, v, window=24), *FLASH_TOL["float32"])
    with pytest.raises(ValueError, match="last dim"):
        flash_attention(q.transpose(1, 3), k.transpose(1, 3),
                        v.transpose(1, 3))
    with pytest.raises(ValueError, match="D <= 256"):
        big = _on(cuda, 1, 4, 1, 264)
        flash_attention(big, big, big)


LIN_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-3)}
STATE_TOL = (1e-4, 1e-4)
RWKV6_CASES = [
    # (B, T, H, Dk, Dv, decay, state): the forward's head shape, one token,
    # a chunk -1 and +1, a long sequence, Dk != Dv, Dk 128
    (1, 256, 4, 64, 64, "weak", True),
    (2, 1, 3, 64, 64, "strong", True),
    (2, 15, 2, 32, 48, "weak", False),
    (1, 17, 2, 64, 64, "strong", True),
    (1, 1000, 2, 64, 64, "weak", True),
    (2, 100, 3, 16, 40, "strong", False),
    (1, 70, 2, 128, 16, "weak", True),
]
MAMBA2_CASES = [
    # (B, T, H, P, N, decay, state, b/c shared over heads by stride 0)
    (1, 256, 4, 64, 64, "weak", True, True),
    (2, 1, 3, 64, 64, "strong", True, False),
    (2, 63, 2, 64, 64, "weak", False, True),
    (1, 65, 2, 32, 16, "strong", True, False),
    (1, 1000, 2, 64, 64, "weak", True, True),
    (2, 100, 3, 48, 24, "strong", False, False),
    (1, 70, 2, 16, 128, "weak", True, True),
    # many chunks and spans; T not a multiple of the span; N != P
    (1, 4096, 4, 64, 64, "weak", True, True),
    (1, 4096, 3, 64, 64, "strong", False, False),
    (1, 1000, 3, 48, 24, "weak", True, True),
    (1, 700, 2, 16, 128, "strong", True, False),
    (2, 2000, 5, 64, 128, "weak", False, True),
]


def _rwkv6_inputs(dev, b, t, h, dk, dv, decay, state, dtype):
    r = _on(dev, b, t, h, dk) * dk ** -0.5
    k = _on(dev, b, t, h, dk) * dk ** -0.5
    v, u = _on(dev, b, t, h, dv), _on(dev, h, dk) * 0.5
    w = -torch.exp((-6.0 if decay == "weak" else 0.0)
                   + 0.5 * _on(dev, b, t, h, dk))
    s0 = _on(dev, b, h, dk, dv) * dk ** -0.5 if state else None
    return (*(x.to(dtype) for x in (r, k, v, w, u)), s0)


def _mamba2_inputs(dev, b, t, h, p, n, decay, state, shared, dtype):
    x = _on(dev, b, t, h, p)
    a = (-1e-3 * torch.exp(0.1 * _on(dev, b, t, h)) if decay == "weak"
         else -torch.exp(0.5 * _on(dev, b, t, h)))
    hb = 1 if shared else h
    bb, cc = ((_on(dev, b, t, hb, n) * n ** -0.5).to(dtype)
              .expand(b, t, h, n) for _ in range(2))
    s0 = _on(dev, b, h, n, p) * n ** -0.5 if state else None
    return x.to(dtype), a.to(dtype), bb, cc, s0


def _check_recurrence(kernel, plain, ins, dtype):
    before = kernel.launches
    out, st = kernel(*ins)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want_out, want_st = plain(*ins)
    assert out.dtype == DTYPES[dtype] and st.dtype == torch.float32
    assert float(want_out.float().abs().max()) > 0.2   # O(1), not vanishing
    _close(out, want_out, *LIN_TOL[dtype])
    _close(st, want_st, *STATE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", RWKV6_CASES)
def test_rwkv6_kernel_matches_plain(cuda, dtype, case):
    ins = _rwkv6_inputs(cuda, *case, DTYPES[dtype])
    _check_recurrence(rwkv6, xla_linear.rwkv6, ins, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", MAMBA2_CASES)
def test_mamba2_kernel_matches_plain(cuda, dtype, case):
    ins = _mamba2_inputs(cuda, *case, DTYPES[dtype])
    if case[-1]:
        assert ins[2].stride(2) == 0          # read in place, never copied
    _check_recurrence(mamba2, xla_linear.mamba2, ins, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", [
    # (B, T, H, P, N, decay, state): one span plan with b/c shared or not
    (1, 256, 4, 64, 64, "weak", True),
    (2, 63, 2, 64, 64, "weak", False),
    (1, 70, 2, 16, 128, "weak", True),
    (1, 1000, 3, 48, 24, "weak", True),
    (1, 4096, 80, 64, 64, "strong", True),
    (1, 4096, 80, 64, 128, "weak", False),
])
def test_mamba2_shared_gram_gives_each_heads_bits(cuda, dtype, case):
    """b/c as stride-0 views: pass 1 makes each chunk's Gram once for every
    head; b/c copied per head: each head's CTA makes its own.  Where both
    take one span plan, the same bits either way."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.mamba2 import plan
    b_, t, h, p, n = case[:5]
    sms = cuda_lib.sm_count(cuda.index)
    bf16 = dtype == "bfloat16"
    assert plan(b_, t, h, p, n, bf16, True, sms).spans == \
        plan(b_, t, h, p, n, bf16, False, sms).spans
    x, a, b, c, h0 = _mamba2_inputs(cuda, *case, True, DTYPES[dtype])
    shared = mamba2(x, a, b, c, h0)
    own = mamba2(x, a, b.contiguous(), c.contiguous(), h0)
    for got, want in zip(shared, own):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_recurrence_kernels_stream_and_read_strided_views(cuda):
    """Two chained half calls equal one whole call; r/k/v/w read in place
    as views of one packed projection."""
    packed = _on(cuda, 1, 300, 2, 4 * 64) * 0.125
    r, k, v = packed[..., :64], packed[..., 64:128], packed[..., 128:192] * 8
    w = -torch.exp(-6.0 + 0.5 * packed[..., 192:] * 8)
    u = _on(cuda, 2, 64) * 0.5
    assert not r.is_contiguous()
    whole = rwkv6(r, k, v, w, u)
    _close(whole[0], xla_linear.rwkv6(r, k, v, w, u)[0], *LIN_TOL["float32"])
    o1, s1 = rwkv6(r[:, :131], k[:, :131], v[:, :131], w[:, :131], u)
    o2, s2 = rwkv6(r[:, 131:], k[:, 131:], v[:, 131:], w[:, 131:], u, s1)
    _close(torch.cat([o1, o2], 1), whole[0], *LIN_TOL["float32"])
    _close(s2, whole[1], *STATE_TOL)
    x, a, b, c, _ = _mamba2_inputs(cuda, 1, 300, 2, 64, 64, "weak", False,
                                   True, torch.float32)
    whole = mamba2(x, a, b, c)
    y1, h1 = mamba2(x[:, :131], a[:, :131], b[:, :131], c[:, :131])
    y2, h2 = mamba2(x[:, 131:], a[:, 131:], b[:, 131:], c[:, 131:], h1)
    _close(torch.cat([y1, y2], 1), whole[0], *LIN_TOL["float32"])
    _close(h2, whole[1], *STATE_TOL)


@pytest.mark.cuda
def test_recurrence_kernels_refuse_what_they_do_not_take(cuda):
    r, k, v, w, u, s0 = _rwkv6_inputs(cuda, 1, 8, 2, 16, 16, "strong", True,
                                      torch.float32)
    with pytest.raises(ValueError, match="cpu"):
        ops.rwkv6(r, k, v, w, u, s0, implementation="torch")
    strided = lambda t: t.transpose(2, 3).contiguous().transpose(2, 3)  # noqa
    with pytest.raises(ValueError, match="last dim"):
        rwkv6(strided(r), k, v, w, u)
    with pytest.raises(ValueError, match="Dk <= 128"):
        big = _on(cuda, 1, 4, 1, 136)
        rwkv6(big, big, big, big, _on(cuda, 1, 136))
    x, a, b, c, h0 = _mamba2_inputs(cuda, 1, 8, 2, 16, 16, "strong", True,
                                    False, torch.float32)
    with pytest.raises(ValueError, match="different cards|CUDA"):
        mamba2(x, a, b, c.cpu(), h0)
    with pytest.raises(ValueError, match="N <= 128"):
        nb = _on(cuda, 1, 8, 2, 136)
        mamba2(x, a, nb, nb)


@pytest.mark.cuda
def test_dot_and_mamba2_replay_from_a_cuda_graph(cuda):
    u, v = _on(cuda, 1 << 22), _on(cuda, 1 << 22)
    ins = _mamba2_inputs(cuda, 1, 1000, 4, 64, 64, "weak", True, True,
                         torch.bfloat16)
    eager = (dot(u, v), *mamba2(*ins))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dot(u, v), mamba2(*ins)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = (dot(u, v), *mamba2(*ins))
    graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(outs, eager):
        assert torch.equal(got, want)          # the same bits, replayed


def _rwkv6_t_for_span(span_chunks, h, sms):
    """The least T (in whole and ragged chunks) at which the rwkv6 plan
    picks spans of ``span_chunks`` chunks for ``h`` heads on this card."""
    from repro_torch.kernels.rwkv6 import plan
    for t in range(1, 16 * 1024, 7):
        if plan(1, t, h, 64, 64, True, sms).span_chunks == span_chunks:
            return t
    raise AssertionError(f"no T gives spans of {span_chunks} chunks")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("span_chunks", [1, 2, 4, 8, 16])
def test_rwkv6_kernel_matches_plain_at_every_span(cuda, dtype, span_chunks):
    """T chosen so that the plan picks each span length it can: the three
    passes (span states, state passing, outputs) against the plain version,
    with a state and weak decay (the state passed between spans dominates),
    and the same bits twice."""
    from repro_torch.kernels.rwkv6 import plan
    h = 12
    sms = cuda_lib.sm_count(cuda.index)
    t = _rwkv6_t_for_span(span_chunks, h, sms)
    assert plan(1, t, h, 64, 64, dtype == "bfloat16",
                sms).span_chunks == span_chunks
    ins = _rwkv6_inputs(cuda, 1, t, h, 64, 64, "weak", True, DTYPES[dtype])
    _check_recurrence(rwkv6, xla_linear.rwkv6, ins, dtype)
    first, again = rwkv6(*ins), rwkv6(*ins)
    for got, want in zip(first, again):
        assert torch.equal(got, want)          # deterministic: no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rwkv6_gives_the_same_bits_twice_and_replays_from_a_graph(cuda,
                                                                  dtype):
    ins = _rwkv6_inputs(cuda, 1, 1000, 8, 64, 64, "wide", True,
                        DTYPES[dtype])
    eager = rwkv6(*ins)
    for got, want in zip(rwkv6(*ins), eager):
        assert torch.equal(got, want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rwkv6(*ins)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = rwkv6(*ins)
    graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(outs, eager):
        assert torch.equal(got, want)          # the same bits, replayed

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", [
    # (B, T, H, Dk, Dv, decay, state): many spans; Dv over two column
    # blocks; Dk between 64 and 128 and Dv not a multiple of 64
    (1, 4096, 4, 64, 64, "weak", True),
    (1, 300, 2, 64, 128, "strong", True),
    (2, 200, 3, 96, 80, "weak", False),
])
def test_rwkv6_kernel_matches_plain_over_spans_and_column_blocks(cuda, dtype,
                                                                 case):
    ins = _rwkv6_inputs(cuda, *case, DTYPES[dtype])
    _check_recurrence(rwkv6, xla_linear.rwkv6, ins, dtype)


MAMBA2_GROUPED_CASES = [
    # (B, T, H, P, N, groups, decay, state): zamba2-7b's forward (two
    # groups of 56 heads, two heads a pass-3 CTA); an odd number of heads
    # a group (one head a CTA, the Grams still shared); four groups; one
    # token; a head a group
    (1, 4096, 112, 64, 64, 2, "weak", False),
    (2, 300, 6, 64, 64, 2, "strong", True),
    (1, 1000, 8, 32, 16, 4, "weak", True),
    (2, 1, 4, 64, 64, 2, "strong", True),
    (1, 200, 4, 64, 128, 4, "weak", False),
]


def _grouped_inputs(dev, b, t, h, p, n, g, decay, state, dtype):
    x, a, _, _, s0 = _mamba2_inputs(dev, b, t, h, p, n, decay, state, True,
                                    dtype)
    bb, cc = ((_on(dev, b, t, g, n) * n ** -0.5).to(dtype) for _ in range(2))
    return x, a, bb, cc, s0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", MAMBA2_GROUPED_CASES)
def test_mamba2_grouped_kernel_matches_plain(cuda, dtype, case):
    """b/c (B, T, G, N), head h reading group h // (H / G), in one launch,
    against the plain version; and each head's bits as with its group's b
    and c copied to it (where both take one span plan)."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.mamba2 import plan
    ins = _grouped_inputs(cuda, *case, DTYPES[dtype])
    _check_recurrence(mamba2, xla_linear.mamba2, ins, dtype)
    b_, t, h, p, n, g = case[:6]
    sms, bf16 = cuda_lib.sm_count(cuda.index), dtype == "bfloat16"
    if plan(b_, t, h, p, n, bf16, True, sms, g).spans == \
            plan(b_, t, h, p, n, bf16, False, sms, h).spans:
        x, a, bb, cc, s0 = ins
        own = mamba2(x, a, bb.repeat_interleave(h // g, dim=2),
                     cc.repeat_interleave(h // g, dim=2), s0)
        for got, want in zip(mamba2(*ins), own):
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (M, K, P, bias, relu, view): the DQN bank's calls at the DSE's widths
    (32, 28, 64, True, True, ""), (32, 64, 26, True, False, ""),
    (64, 32, 64, False, False, "aT"), (32, 26, 64, False, False, "bT"),
    (1, 32, 64, False, False, "ones"), (6, 64, 26, True, False, ""),
])
def test_bank_mm_matches_plain_and_keeps_a_slots_bits(cuda, case):
    """The bank's product against ``torch.bmm`` / ``baddbmm`` at float32's
    rtol 1e-5 / atol 1e-4, and its contract: a slot's bits are the same in
    a 16-slot, a 4-slot and a 1-slot call, and replayed from a graph."""
    m, k, p, bias, relu, view = case
    n = 16
    a = (_on(cuda, n, k, m).transpose(1, 2) if view == "aT" else
         torch.ones((), device=cuda).expand(n, m, k) if view == "ones" else
         _on(cuda, n, m, k))
    b = _on(cuda, n, p, k).transpose(1, 2) if view == "bT" else \
        _on(cuda, n, k, p)
    c = _on(cuda, n, p) if bias else None
    got = bank_mm(a, b, c, relu)
    torch.testing.assert_close(got, bank_mm_plain(a, b, c, relu), rtol=1e-5,
                               atol=1e-4)
    for s in (1, 4):
        assert torch.equal(bank_mm(a[:s], b[:s], None if c is None else c[:s],
                                   relu), got[:s])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = bank_mm(a, b, c, relu)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)


@pytest.mark.cuda
def test_dqn_bank_slot_equals_standalone_dqn_on_the_card(cuda):
    """A slot of a 16-seed bank, the 1-seed bank of its seed and a
    standalone DQN end on the same bits; the bank's graph-replayed rounds
    equal eager ones, and count the ``bank_mm`` launches they replay."""
    from repro_torch.core.qlearning import DQN, DQNBank

    F, A, k, seeds = 28, 26, 6, list(range(16))
    bank, eager = (DQNBank(F, A, seeds, device=cuda) for _ in range(2))
    eager.state.graph = False
    one, dqn = DQNBank(F, A, [5], device=cuda), DQN(F, A, seed=5, device=cuda)
    rng = np.random.default_rng(0)
    launched = {"graph": [], "eager": []}
    for _ in range(10):
        feats = rng.random((16, k, F)).astype(np.float32)
        acts = bank.select_round(feats)
        assert (eager.select_round(feats) == acts).all()
        assert (one.select_round(feats[5:6]) == acts[5:6]).all()
        assert (dqn.select_batch(feats[5]) == acts[5]).all()
        s2 = rng.random((16, k, F)).astype(np.float32)
        rew = rng.uniform(-1, 1, (16, k))
        for name, b_ in (("graph", bank), ("eager", eager)):
            before = bank_mm.launches
            b_.train_round(feats, acts, rew, s2)
            launched[name].append(bank_mm.launches - before)
        one.train_round(feats[5:6], acts[5:6], rew[5:6], s2[5:6])
        for j in range(k):
            dqn.record(feats[5, j], int(acts[5, j]), float(rew[5, j]),
                       s2[5, j])
            dqn.train_step()
    assert dqn.t > 0
    # after the first warm round (which may capture the graph), a replayed
    # round counts the launches the eager round makes
    first = next(i for i, n in enumerate(launched["eager"]) if n)
    assert launched["graph"][first + 1:] == launched["eager"][first + 1:]
    assert min(launched["eager"][first:]) > 0
    for st in (eager.state, one.state, dqn.state):
        i = 5 if st is eager.state else 0
        for tree, want in ((st.params, bank.state.params),
                           (st.m, bank.state.m), (st.v, bank.state.v)):
            for layer, wl in zip(tree, want):
                for key in ("w", "b"):
                    assert torch.equal(layer[key][i], wl[key][5])


def _state_leaves(state, i):
    return [x[i] for tree in (state.params, state.target, state.m, state.v)
            for layer in tree for x in layer.values()] + [state.t[i]]


@pytest.mark.cuda
def test_dqn_bank_captured_forward_equals_eager(cuda):
    """The replayed forward gives the eager forward's bits, on fresh and on
    trained weights, at the engine's (16, 6) and a standalone DQN's (1, m)
    shapes, and counts the ``bank_mm`` launches it replays."""
    from repro_torch.core.qlearning import DQN, DQNBank, _bank_forward

    F, A, k = 28, 26, 6
    bank = DQNBank(F, A, list(range(16)), device=cuda)
    dqn = DQN(F, A, seed=3, device=cuda)
    rng = np.random.default_rng(1)
    for rnd in range(8):
        feats = rng.random((16, k, F)).astype(np.float32)
        for st, x in ((bank.state, feats),
                      (dqn.state, feats[3:4, :1 + rnd % k])):
            st.forward(x)                 # captures at a shape's first call
            before = bank_mm.launches
            got = st.forward(x)
            assert bank_mm.launches - before == 4
            with torch.no_grad():
                want = _bank_forward(st.params, torch.as_tensor(
                    x, device=cuda)).cpu().numpy()
            assert np.array_equal(got, want)
        acts = bank.select_round(feats)
        bank.train_round(feats, acts, rng.uniform(-1, 1, (16, k)),
                         rng.random((16, k, F)).astype(np.float32))
    assert bank.t.min() > 0


@pytest.mark.cuda
def test_banks_taking_turns_on_one_capture_keep_their_own_state(cuda):
    """Two 4-seed banks share one configuration's capture, and so do a
    1-seed bank and a standalone DQN; taking turns on it, round by round
    and within a round, each keeps its own state: its actions and, read
    between turns and at the end, every leaf equal its eager twin's bit for
    bit."""
    from repro_torch.core.qlearning import DQN, DQNBank

    F, A, k = 28, 26, 6
    make = {"a": lambda: DQNBank(F, A, [0, 1, 2, 3], device=cuda),
            "b": lambda: DQNBank(F, A, [10, 11, 12, 13], device=cuda),
            "one": lambda: DQNBank(F, A, [5], device=cuda),
            "dqn": lambda: DQN(F, A, seed=7, device=cuda)}
    graph = {name: f() for name, f in make.items()}
    eager = {name: f() for name, f in make.items()}
    for agent in eager.values():
        agent.state.graph = False
    rng = np.random.default_rng(2)
    for rnd in range(10):
        n = {"a": 4, "b": 4, "one": 1, "dqn": 1}
        data = {name: (rng.random((m, k, F)).astype(np.float32),
                       rng.uniform(-1, 1, (m, k)),
                       rng.random((m, k, F)).astype(np.float32))
                for name, m in n.items()}
        acts = {}
        for name in ("a", "dqn", "b", "one"):         # select, in turns
            feats = data[name][0]
            for side in (graph, eager):
                agent = side[name]
                got = (agent.select_batch(feats[0])[None] if name == "dqn"
                       else agent.select_round(feats))
                assert name not in acts or (acts[name] == got).all(), name
                acts[name] = got
        for name in ("b", "dqn", "a", "one"):          # train, in turns
            feats, rew, s2 = data[name]
            for side in (graph, eager):
                agent = side[name]
                if name == "dqn":
                    for j in range(k):
                        agent.record(feats[0, j], int(acts[name][0, j]),
                                     float(rew[0, j]), s2[0, j])
                        agent.train_step()
                else:
                    agent.train_round(feats, acts[name], rew, s2)
            if name in ("b", "a"):   # read a bank while another holds
                for i in range(n[name]):
                    assert all(torch.equal(x, y) for x, y in zip(
                        _state_leaves(graph[name].state, i),
                        _state_leaves(eager[name].state, i))), (rnd, name)
    for name in make:
        g, e = graph[name].state, eager[name].state
        assert int(g.t.min()) > 0
        for i in range(g.t.shape[0]):
            assert all(torch.equal(x, y) for x, y in zip(
                _state_leaves(g, i), _state_leaves(e, i))), name


@pytest.mark.cuda
def test_pending_forward_refuses_q_values_another_forward_replaced(cuda):
    """A forward waiting to be read shares its buffers with every forward
    of its configuration and shape: where another ran in between, reading
    it raises instead of returning the other state's Q-values; read first,
    both are their eager twins'."""
    from repro_torch.core.qlearning import DQNBank, _bank_forward

    F, A, k = 28, 26, 6
    a = DQNBank(F, A, [0, 1, 2, 3], device=cuda)
    b = DQNBank(F, A, [10, 11, 12, 13], device=cuda)
    x = np.random.default_rng(3).random((4, k, F)).astype(np.float32)
    pending = a.state.forward_async(x)
    b.state.forward(x)
    with pytest.raises(RuntimeError, match="replaced"):
        pending()
    for bank in (a, b):
        got = bank.state.forward_async(x)()
        with torch.no_grad():
            want = _bank_forward(bank.state.params, torch.as_tensor(
                x, device=cuda)).cpu().numpy()
        assert np.array_equal(got, want)


# -- the rwkv6 block's glue (kernels/rwkv6_glue.py) ----------------------------
# The elementwise kernels (decay, relu^2, channel gate) must give their plain
# versions' bits.  The norm kernels differ only by their sums' order, so each
# is split in two: its normed values (the mixes at mu = 0, the gated head
# output at a gate of exactly 1) within one bfloat16 ulp of the plain norm
# (LIN_TOL; 1e-5 in float32), and everything after the norm the plain
# version's bits on the kernel's own normed values.
GLUE_TOL = {"float32": (1e-5, 1e-5), "bfloat16": LIN_TOL["bfloat16"]}
# (B, T, D): the forward's rows, ragged T with a batch of two, a narrow D
# (rows off the kernels' 16-byte vectors are refused: the CPU tests'
# test_kernels_refuse_operands_off_the_16_byte_vectors)
GLUE_SHAPES = [(1, 4096, 2560), (2, 1, 2560), (2, 37, 2560), (2, 131, 256)]


def _glue_mix_check(cuda, name, shape, dtype, carried):
    b, t, d = shape
    dt = DTYPES[dtype]
    time_in = name == "rwkv6_time_in"
    x = (_on(cuda, b, t, d) * 3).to(dt)
    ln = (1 + 0.1 * _on(cuda, d)).to(dt)
    head = (x, ln) if time_in else (x, _on(cuda, b, t, d).to(dt), ln)
    mu = (0.5 + 0.2 * _on(cuda, 5 if time_in else 2, d)).to(dt)
    prev = _on(cuda, b, d).to(dt) if carried else None
    kern = getattr(rwkv6_glue, name)
    before = kern.launches
    got = kern(*head, mu, prev)
    normed = kern(*head, torch.zeros_like(mu), prev)[0 if time_in else 1]
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    want = getattr(plain, name)(*head, mu, prev)
    assert len(got) == len(want)
    assert all(g.dtype == dt and g.shape == w.shape for g, w in zip(got, want))
    if not time_in:
        assert torch.equal(got[0], want[0])             # x + att
    _close(normed, glue_common.rms_norm(x if time_in else want[0], ln),
           *GLUE_TOL[dtype])
    xp = rwkv6_glue._shift(normed, prev)
    mixes = got[:-1] if time_in else got[1:-1]
    for i, m in enumerate(mixes):
        assert torch.equal(m, normed + (xp - normed) * mu[i])
    assert torch.equal(got[-1], normed[:, -1])
    if dtype == "bfloat16":         # a norm rounds otherwise only rarely
        assert max(float((g != w).float().mean())
                   for g, w in zip(got, want)) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("shape", GLUE_SHAPES)
@pytest.mark.parametrize("name", ["rwkv6_time_in", "rwkv6_channel_in"])
def test_glue_prologues_match_plain(cuda, name, shape, carried, dtype):
    _glue_mix_check(cuda, name, shape, dtype, carried)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", GLUE_SHAPES)
def test_glue_decay_gives_the_plain_bits(cuda, shape, dtype):
    b, t, hd = shape
    dt = DTYPES[dtype]
    w0 = (_on(cuda, hd) - 1).to(dt)
    lora = (4 * _on(cuda, b, t, hd)).to(dt)       # both clamp bounds bite
    for out in (dt, torch.float32):
        before = rwkv6_glue.rwkv6_decay.launches
        got = rwkv6_glue.rwkv6_decay(w0, lora, out)
        assert rwkv6_glue.rwkv6_decay.launches == before + 1
        want = plain.rwkv6_decay(w0, lora, out)
        assert got.dtype == out and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("dh", [64, 16])
@pytest.mark.parametrize("bt", [(1, 4096), (2, 1), (2, 37), (2, 131)])
def test_glue_head_out_matches_plain(cuda, bt, dh, dtype):
    (b, t), h, dt = bt, 2560 // dh, DTYPES[dtype]
    o = _on(cuda, b, t, h, dh).to(dt)
    ln_x = (1 + 0.1 * _on(cuda, h, dh)).to(dt)
    g_pre = (2 * _on(cuda, b, t, h * dh)).to(dt)
    before = rwkv6_glue.rwkv6_head_out.launches
    got = rwkv6_glue.rwkv6_head_out(o, ln_x, g_pre)
    assert rwkv6_glue.rwkv6_head_out.launches == before + 1
    want = plain.rwkv6_head_out(o, ln_x, g_pre)
    assert got.dtype == dt and got.shape == want.shape
    if dtype == "float32":
        _close(got, want, *GLUE_TOL[dtype])
        return
    # silu(1.28125) rounds to exactly 1 in bfloat16: the gate passes the
    # kernel's normed values through unchanged
    one = torch.full_like(g_pre, 1.28125)
    assert torch.equal(F.silu(one), torch.ones_like(one))
    normed = rwkv6_glue.rwkv6_head_out(o, ln_x, one)
    _close(normed, glue_common.rms_norm(o, ln_x).reshape(got.shape),
           *GLUE_TOL[dtype])
    assert torch.equal(got, normed * F.silu(g_pre))
    assert float((got != want).float().mean()) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(1, 4096, 8960), (2, 1, 8960),
                                   (2, 37, 8960), (2, 131, 8960)])
def test_glue_relu2_and_channel_out_give_the_plain_bits(cuda, shape, dtype):
    dt = DTYPES[dtype]
    hid = (3 * _on(cuda, *shape)).to(dt)
    hid[..., :3] = torch.tensor([0.0, -0.0, float("nan")], dtype=dt)
    before = rwkv6_glue.rwkv6_relu2.launches
    got = rwkv6_glue.rwkv6_relu2(hid)
    assert rwkv6_glue.rwkv6_relu2.launches == before + 1
    want = plain.rwkv6_relu2(hid)
    assert torch.equal(got.isnan(), want.isnan())       # NaN passes relu
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    b, t, _ = shape
    x, r_pre, cv = ((s * _on(cuda, b, t, 2560)).to(dt) for s in (3, 4, 1))
    before = rwkv6_glue.rwkv6_channel_out.launches
    got = rwkv6_glue.rwkv6_channel_out(x, r_pre, cv)
    assert rwkv6_glue.rwkv6_channel_out.launches == before + 1
    assert torch.equal(got, plain.rwkv6_channel_out(x, r_pre, cv))


@pytest.mark.cuda
def test_glue_refuses_what_it_does_not_take(cuda):
    x = _on(cuda, 1, 8, 64)
    ln, mu = _on(cuda, 64), _on(cuda, 5, 64)
    with pytest.raises(TypeError, match="one dtype"):
        rwkv6_glue.rwkv6_time_in(x, ln.to(torch.bfloat16), mu)
    with pytest.raises(ValueError, match="contiguous"):
        rwkv6_glue.rwkv6_time_in(x[:, ::2], ln, mu)
    with pytest.raises(ValueError, match="shapes"):
        rwkv6_glue.rwkv6_channel_out(x, x[:, :4], x)
    with pytest.raises(ValueError, match="16-byte aligned"):
        rwkv6_glue.rwkv6_relu2(_on(cuda, 2, 100).to(torch.bfloat16))
    with pytest.raises(ValueError, match="D <= 2560"):   # float32
        rwkv6_glue.rwkv6_time_in(_on(cuda, 1, 2, 2564), _on(cuda, 2564),
                                 _on(cuda, 5, 2564))


@pytest.mark.cuda
def test_reduced_depth_forward_launches_each_glue_kernel_once_a_layer(cuda):
    """rwkv6-3b at full width and two layers: the forward launches every
    glue kernel once a layer, and so does a one-token decode step (with
    no recurrence kernel); the logits agree with the plain forward's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import rwkv6 as model

    cfg = dataclasses.replace(get_config("rwkv6-3b"), n_layers=2)
    params = model.init(cfg, seed=0, device="cuda")
    gen = torch.Generator(device=cuda).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (1, 300), device=cuda, generator=gen)
    counted = (*GLUE, rwkv6)
    with torch.no_grad():
        before = [k.launches for k in counted]
        logits = model.forward(params, cfg, {"tokens": tokens}, impl="cuda")
        torch.cuda.synchronize()
        assert [k.launches - n for k, n in zip(counted, before)] == \
            [cfg.n_layers] * len(counted)
        want = model.forward(params, cfg, {"tokens": tokens}, impl=plain)
        cos = F.cosine_similarity(logits.float(), want.float(), dim=-1)
        assert float(cos.min()) > 0.999
        cache = model.init_cache(cfg, 2, 64, device="cuda")
        before = [k.launches for k in counted]
        model.decode_step(params, cfg, cache, tokens[:, :2].T.contiguous(),
                          [0, 0], impl="cuda")
        assert [k.launches - n for k, n in zip(counted, before)] == \
            [cfg.n_layers] * len(GLUE) + [0]


# -- the Zamba2 Mamba layer's glue (kernels/mamba2_glue.py) --------------------
# Every kernel must give its plain version's bits, every output: conv_in's
# arithmetic rounds where the plain version's does, and the two norms sum
# their squares in the order PyTorch's CUDA reduction takes for the plain
# torch.mean (csrc/mamba2_glue.cu's torch_order_sum, read from PyTorch
# 2.11's Reduce.cuh), at every row count (the lanes of that reduction grow
# as the rows fall below 16).  With a PyTorch that sums in another order the
# norms would differ by that order alone, which glue_common.one_inv_a_row
# (chip_smoke's rule for them) tells apart from a fault.
# (d, heads, groups, eps): zamba2-7b's and zamba2-2.7b's Mamba widths
MAMBA2_WIDTHS = {"zamba2-7b": (3584, 112, 2, 1e-5),
                 "zamba2-2.7b": (2560, 80, 1, 1e-6)}
# (widths, B, S, a tail carried): the forwards' rows, a decode step, a
# slot prefill's ragged chunk and one shorter than the tail
MAMBA2_GLUE_CASES = [("zamba2-7b", 1, 4096, False),
                     ("zamba2-2.7b", 1, 4096, False),
                     ("zamba2-7b", 2, 1, True), ("zamba2-2.7b", 2, 1, True),
                     ("zamba2-7b", 2, 37, True), ("zamba2-2.7b", 3, 2, True),
                     ("zamba2-2.7b", 1, 1, True), ("zamba2-7b", 5, 3, True),
                     ("zamba2-2.7b", 8, 2, True)]


def _mamba2_glue_inputs(dev, arch, b, s, carried, dt):
    d, h, g, eps = MAMBA2_WIDTHS[arch]
    hp, gn = h * 64, g * 64
    c = hp + 2 * gn
    zx = (2 * _on(dev, b, s, hp + c + h)).to(dt)
    zx[..., -h:] = (8 * _on(dev, b, s, h)).to(dt)   # softplus's threshold
    zx[:, 0, -1] = 24.0
    return {"zx": zx, "conv_w": (0.3 * _on(dev, 4, c)).to(dt),
            "conv_b": (0.1 * _on(dev, c)).to(dt),
            "dt_bias": 0.5 * _on(dev, h), "a_log": 1 + 0.5 * _on(dev, h),
            "tail": (2 * _on(dev, b, 3, c)).to(dt) if carried else None,
            "x": (3 * _on(dev, b, s, d)).to(dt), "t": _on(dev, b, s, d).to(dt),
            "ln": (1 + 0.1 * _on(dev, d)).to(dt),
            "y": _on(dev, b, s, h, 64).to(dt), "d_skip": 1 + 0.5 * _on(dev, h),
            "norm": (1 + 0.1 * _on(dev, hp)).to(dt), "dims": (hp, g, eps)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", MAMBA2_GLUE_CASES)
def test_mamba2_glue_matches_plain(cuda, case, dtype):
    arch, b, s, carried = case
    dt = DTYPES[dtype]
    ins = _mamba2_glue_inputs(cuda, arch, b, s, carried, dt)
    hp, g, eps = ins["dims"]
    conv = (ins["zx"], ins["conv_w"], ins["conv_b"], ins["dt_bias"],
            ins["a_log"], ins["tail"])
    before = [k.launches for k in MAMBA2_GLUE]
    for decay in {dt, torch.float32}:
        got = mamba2_glue.mamba2_conv_in(*conv, decay, g)
        want = plain.mamba2_conv_in(*conv, decay, g)
        assert len(got) == len(want) == 6
        for a, w in zip(got, want):
            assert a.dtype == w.dtype and a.shape == w.shape
            assert torch.equal(a, w)
    xs = got[0]
    z = ins["zx"][..., :hp]
    for t in (None, ins["t"]):
        got = mamba2_glue.mamba2_norm_in(ins["x"], t, ins["ln"], eps)
        want = plain.mamba2_norm_in(ins["x"], t, ins["ln"], eps)
        assert got.dtype == dt and got.shape == want.shape
        assert torch.equal(got, want)
    gate = (ins["y"], xs, z, ins["d_skip"], ins["norm"], g, eps)
    got = mamba2_glue.mamba2_gate_out(*gate)
    want = plain.mamba2_gate_out(*gate)
    assert got.dtype == dt and got.shape == want.shape
    assert torch.equal(got, want)
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(MAMBA2_GLUE, before)] == \
        [2, len({dt, torch.float32}), 1]


@pytest.mark.cuda
def test_mamba2_glue_refuses_what_it_does_not_take(cuda):
    ins = _mamba2_glue_inputs(cuda, "zamba2-7b", 1, 8, True, torch.float32)
    hp, g, eps = ins["dims"]
    conv = [ins["zx"], ins["conv_w"], ins["conv_b"], ins["dt_bias"],
            ins["a_log"], ins["tail"]]
    with pytest.raises(TypeError, match="one dtype"):
        mamba2_glue.mamba2_norm_in(ins["x"], None,
                                   ins["ln"].to(torch.bfloat16), eps)
    with pytest.raises(ValueError, match="contiguous"):
        mamba2_glue.mamba2_norm_in(ins["x"][:, ::2], None, ins["ln"], eps)
    with pytest.raises(TypeError, match="decay"):
        mamba2_glue.mamba2_conv_in(*conv, torch.bfloat16, g)
    with pytest.raises(ValueError, match="shapes"):
        mamba2_glue.mamba2_conv_in(*conv[:-1], ins["tail"][:, :2],
                                   torch.float32, g)
    with pytest.raises(ValueError, match="shapes"):
        mamba2_glue.mamba2_gate_out(ins["y"], ins["y"], ins["zx"][..., :hp],
                                    ins["d_skip"], ins["norm"], 3, eps)
    with pytest.raises(ValueError, match="norms rows"):   # 8192 at most
        mamba2_glue.mamba2_norm_in(_on(cuda, 1, 2, 8200), None,
                                   _on(cuda, 8200), eps)


@pytest.mark.cuda
def test_zamba2_7b_forward_launches_each_mamba2_glue_kernel_81_times(cuda):
    """zamba2-7b at its published widths and depth: a forward launches
    each of the Mamba layer's three glue kernels once a layer, 81 times,
    and so does a one-token decode step (with no mamba2 kernel); at eight
    layers (one hybrid) the kernel forward agrees with the plain one."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import zamba2 as model

    cfg = get_config("zamba2-7b")
    assert cfg.n_layers == 81
    params = model.init(cfg, seed=0, device="cuda")
    gen = torch.Generator(device=cuda).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (1, 300), device=cuda, generator=gen)
    counted = (*MAMBA2_GLUE, mamba2)
    with torch.no_grad():
        before = [k.launches for k in counted]
        logits = model.forward(params, cfg, {"tokens": tokens}, impl="cuda")
        torch.cuda.synchronize()
        assert [k.launches - n for k, n in zip(counted, before)] == \
            [81] * len(counted)
        assert bool(torch.isfinite(logits).all())
        cache = model.init_cache(cfg, 2, 64, device="cuda")
        before = [k.launches for k in counted]
        model.decode_step(params, cfg, cache, tokens[:, :2].T.contiguous(),
                          [0, 0], impl="cuda")
        assert [k.launches - n for k, n in zip(counted, before)] == \
            [81] * len(MAMBA2_GLUE) + [0]
        del params, logits, cache
        small = dataclasses.replace(cfg, n_layers=8, hybrid_layer_ids=(6,))
        params = model.init(small, seed=0, device="cuda")
        got = model.forward(params, small, {"tokens": tokens}, impl="cuda")
        want = model.forward(params, small, {"tokens": tokens}, impl=plain)
        cos = F.cosine_similarity(got.float(), want.float(), dim=-1)
        assert float(cos.min()) > 0.999
