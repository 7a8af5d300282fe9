"""The GEMM and CONV2D kernels' geometry and decomposition, on the CPU.

``gemm.plan`` and ``conv2d.plan`` are the geometry ``csrc/gemm.cu`` and
``csrc/conv2d.cu`` run: the co-designed block picks a CTA tile from the
classes the kernels are compiled for (monotone in the block), and the
reduction (K, or C*R*S) is split over CTAs in spans of whole stages where
the output tiles are fewer than the SMs.  The kernels themselves run only
on the card (``tests/test_torch_kernels_cuda.py``); here a float32 numpy
emulation walks the plan's tiles, splits and stages and CONV2D's
implicit-GEMM gather with the kernel's own index arithmetic, shows that it
covers every output and every reduction index exactly once, and matches
the reference package's Pallas kernels run in interpret mode at the
tolerances of ``tests/test_kernels.py`` (float32: gemm rtol 1e-5 / atol
1e-4, conv 1e-4 / 2e-3; the emulation sums in other orders).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hw_space import AXES
from repro.kernels import ops as R_ops
from repro_torch.kernels import conv2d, gemm
from repro_torch.kernels.conv2d import STAGE_DEPTH, TILE_CHANNELS, TILE_PIXELS
from repro_torch.kernels.conv2d import plan as conv_plan
from repro_torch.kernels.gemm import (MAX_SPLITS, MAX_TILES, STAGE_DEPTHS,
                                      TILE_SIDES)
from repro_torch.kernels.gemm import plan as gemm_plan

H100_SMS = 132
SIDES, DEPTHS = AXES["pe_rows"], AXES["pe_depth"]   # 8-512, 8-2048
GEMM_TOL, CONV_TOL = (1e-5, 1e-4), (1e-4, 2e-3)


def _cdiv(a, b):
    return -(-a // b)


def _check_split(p, red):
    """Spans of whole stages that cover the reduction, none empty, and a
    grid within its limits."""
    assert p.span % p.tile[2] == 0
    assert p.splits * p.span >= red > (p.splits - 1) * p.span
    assert 1 <= p.splits <= MAX_SPLITS and p.ctas // p.splits <= MAX_TILES


# -- the tile follows the block, monotonely --------------------------------

@pytest.mark.parametrize("axis", [0, 1, 2])
def test_gemm_tile_is_monotone_in_each_block_side(axis):
    vals = DEPTHS if axis == 2 else SIDES
    tiles = []
    for v in vals:
        blk = [64, 64, 32]
        blk[axis] = v
        tiles.append(gemm_plan(4096, 4096, 4096, 4, H100_SMS, *blk).tile)
    picked = [t[axis] for t in tiles]
    assert picked == sorted(picked)
    assert set(picked) == set(STAGE_DEPTHS if axis == 2 else TILE_SIDES)
    for t in tiles:                      # the other sides do not move
        assert [t[i] for i in range(3) if i != axis] == \
            [x for i, x in enumerate((64, 64, 32)) if i != axis]


def test_conv_tile_is_monotone_in_the_block():
    picked = [conv_plan(512, 256, 14, 14, 3, 3, 4, H100_SMS, bk).tile
              for bk in SIDES]
    assert [t[0] for t in picked] == sorted(t[0] for t in picked)
    assert {t[0] for t in picked} == set(TILE_CHANNELS)
    assert {t[1:] for t in picked} == {(TILE_PIXELS, STAGE_DEPTH)}


@pytest.mark.parametrize("itemsize", [4, 2])
def test_blocks_in_different_classes_give_different_tiles(itemsize):
    g = {gemm_plan(1024, 1024, 1024, itemsize, H100_SMS, bm, bn, bk).tile
         for bm, bn, bk in itertools.product(TILE_SIDES, TILE_SIDES,
                                             STAGE_DEPTHS)}
    assert len(g) == len(TILE_SIDES) ** 2 * len(STAGE_DEPTHS)
    c = {conv_plan(256, 256, 14, 14, 3, 3, itemsize, H100_SMS, bk).tile
         for bk in TILE_CHANNELS}
    assert len(c) == len(TILE_CHANNELS)
    # blocks of one class share a tile: the largest class from 64 up
    assert len({gemm_plan(1024, 1024, 1024, itemsize, H100_SMS, b, b, 4 * b)
                .tile for b in (64, 128, 256, 512)}) == 1


# -- the plan fills the card -------------------------------------------------

GEMM_SHAPES = [(1024, 1024, 1024), (4096, 4096, 4096), (17, 129, 65),
               (1000, 300, 777), (96, 72, 80), (64, 64, 100000), (1, 1, 1),
               (3000, 20, 5000)]


@pytest.mark.parametrize("shape", GEMM_SHAPES)
@pytest.mark.parametrize("itemsize", [4, 2])
def test_gemm_plan_fills_the_card_wherever_the_work_allows(shape, itemsize):
    m, n, k = shape
    for bm, bn, bk in itertools.product(SIDES[::2], SIDES[1::2], DEPTHS[::2]):
        p = gemm_plan(m, n, k, itemsize, H100_SMS, bm, bn, bk)
        assert p.block == (min(bm, m), min(bn, n), min(bk, k))
        _check_split(p, k)
        tiles = _cdiv(m, p.tile[0]) * _cdiv(n, p.tile[1])
        assert p.ctas == tiles * p.splits
        stages = _cdiv(k, p.tile[2])
        if tiles >= H100_SMS:
            assert p.splits == 1                    # no split needed
        elif tiles * stages >= H100_SMS:
            assert p.ctas >= H100_SMS
        else:
            assert p.splits == stages               # one stage a split


CONV_SHAPES = [(256, 256, 14, 14, 3, 3), (64, 3, 224, 224, 7, 7),
               (512, 512, 7, 7, 3, 3), (24, 16, 9, 12, 3, 2),
               (1000, 2048, 1, 1, 1, 1), (5, 1, 3, 3, 1, 1)]


@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("itemsize", [4, 2])
def test_conv_plan_fills_the_card_wherever_the_work_allows(shape, itemsize):
    k, c, x, y, r, s = shape
    for bk in SIDES:
        p = conv_plan(k, c, x, y, r, s, itemsize, H100_SMS, bk)
        assert p.block == (min(bk, k),)
        _check_split(p, c * r * s)
        tiles = _cdiv(k, p.tile[0]) * _cdiv(x * y, TILE_PIXELS)
        stages = _cdiv(c * r * s, STAGE_DEPTH)
        assert p.ctas == tiles * p.splits
        if tiles >= H100_SMS:
            assert p.splits == 1
        elif tiles * stages >= H100_SMS:
            assert p.ctas >= H100_SMS
        else:
            assert p.splits == stages


@pytest.mark.parametrize("blocks", [(256, 256, 128), (256, 256, 512)])
def test_gemm_main_path_fills_the_card_at_its_blocks(blocks):
    # the committed and the default block: 16 CTAs under one CTA a block;
    # now 256 tiles of 64 x 64, K unsplit (so the float32 sums run in one
    # chain, in cuBLAS's order)
    p = gemm_plan(1024, 1024, 1024, 4, H100_SMS, *blocks)
    assert (p.tile, p.splits, p.span, p.ctas) == ((64, 64, 32), 1, 1024, 256)


@pytest.mark.parametrize("bk,tile,ctas", [(64, (64, 64, 32), 384),
                                          (128, (128, 64, 32), 192)])
def test_conv_main_path_fills_the_card_at_its_blocks(bk, tile, ctas):
    # ResNet-50's 3x3 layer at the committed bk 64 and the default 128: 8
    # and 4 CTAs under one CTA a block; now C*R*S = 2304 split 24 ways
    p = conv_plan(256, 256, 14, 14, 3, 3, 4, H100_SMS, bk)
    assert (p.tile, p.splits, p.span, p.ctas) == (tile, 24, 96, ctas)
    assert p.ctas >= H100_SMS


def test_plans_refuse_blocks_that_are_not_positive_and_odd_item_sizes():
    with pytest.raises(ValueError, match="positive"):
        gemm_plan(8, 8, 8, 4, H100_SMS, 0, 8, 8)
    with pytest.raises(ValueError, match="positive"):
        conv_plan(8, 8, 4, 4, 1, 1, 4, H100_SMS, -3)
    with pytest.raises(ValueError, match="2- or 4-byte"):
        gemm_plan(8, 8, 8, 8, H100_SMS, 8, 8, 8)


# -- a CPU emulation of the kernels' decomposition ---------------------------

def _emulate(a_mat, stage_b, m, n, red, p):
    """Walk the grid of ``tile_mm_kernel``: CTA (tile, split) stages A's
    rows and B's (via ``stage_b``) in the plan's stages, zero-filled past
    every edge, accumulates its tile in float32 and writes it (a partial
    with several splits); the partials are then summed in split order.
    -> (output, writes per (split, output), visits per (tile, reduction
    index))."""
    tm, tn, tk = p.tile
    tiles_n = _cdiv(n, tn)
    n_tiles = _cdiv(m, tm) * tiles_n
    assert n_tiles * p.splits == p.ctas
    partial = np.zeros((p.splits, m, n), np.float32)
    writes = np.zeros((p.splits, m, n), np.int64)
    visits = np.zeros((n_tiles, red), np.int64)
    for t, sp in itertools.product(range(n_tiles), range(p.splits)):
        row0, col0 = (t // tiles_n) * tm, (t % tiles_n) * tn
        lo, hi = sp * p.span, min(red, (sp + 1) * p.span)
        assert lo < hi                                  # no empty split
        acc = np.zeros((tm, tn), np.float32)
        for k0 in range(lo, hi, tk):
            kk = np.arange(k0, k0 + tk)
            ok_k = kk < hi
            rows = np.arange(row0, row0 + tm)
            a_st = np.zeros((tm, tk), np.float32)
            sel = (rows < m)[:, None] & ok_k[None, :]
            a_st[sel] = a_mat[np.broadcast_to(rows[:, None], sel.shape)[sel],
                              np.broadcast_to(kk[None, :], sel.shape)[sel]]
            b_st = stage_b(kk, ok_k, np.arange(col0, col0 + tn))
            visits[t, kk[ok_k]] += 1
            acc += a_st @ b_st
        r1, c1 = min(m, row0 + tm), min(n, col0 + tn)
        partial[sp, row0:r1, col0:c1] = acc[:r1 - row0, :c1 - col0]
        writes[sp, row0:r1, col0:c1] += 1
    out = np.zeros((m, n), np.float32)
    for sp in range(p.splits):                         # fixed order
        out += partial[sp]
    return out, writes, visits


def _gemm_stage_b(b):
    k_dim, n = b.shape

    def stage(kk, ok_k, cols):
        sel = ok_k[:, None] & (cols < n)[None, :]
        st = np.zeros(sel.shape, np.float32)
        st[sel] = b[np.broadcast_to(kk[:, None], sel.shape)[sel],
                    np.broadcast_to(cols[None, :], sel.shape)[sel]]
        return st
    return stage


def _conv_stage_b(a, r, s):
    """CONV2D's gather as ``csrc/conv2d.cu::ConvB`` computes it: stage row
    idx -> (c, r, s) and base offset c*H*W + r*W + s; column n -> pixel
    offset x*W + y (-1 past X*Y); element a.flat[base + offset]."""
    c_dim, h, w = a.shape
    x_dim, y_dim = h - r + 1, w - s + 1
    flat = a.reshape(-1)

    def stage(kk, ok_k, cols):
        c = kk // (r * s)
        rs = kk - c * (r * s)
        rr = rs // s
        base = (c * h + rr) * w + (rs - rr * s)
        off = np.where(cols < x_dim * y_dim,
                       (cols // y_dim) * w + cols % y_dim, -1)
        sel = ok_k[:, None] & (off >= 0)[None, :]
        st = np.zeros(sel.shape, np.float32)
        st[sel] = flat[(base[:, None] + off[None, :])[sel]]
        return st
    return stage


def _assert_once(writes, visits):
    assert (writes == 1).all()      # each split writes each output once
    assert (visits == 1).all()      # each tile sums each reduction index once


@pytest.mark.parametrize("shape,blocks,n_sm", [
    ((33, 50, 40), (17, 96, 9), H100_SMS),         # odd blocks, ragged
    ((70, 45, 203), (64, 40, 100), H100_SMS),
    ((40, 40, 3000), (40, 40, 1500), H100_SMS),    # few tiles: K split
    ((150, 70, 77), (128, 64, 16), 8),             # tiles cover a small card
    ((130, 200, 513), (300, 1, 600), H100_SMS),
])
def test_gemm_decomposition_covers_once_and_matches_the_reference(
        shape, blocks, n_sm):
    m, n, k = shape
    rng = np.random.default_rng(m * n + k)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    p = gemm_plan(m, n, k, 4, n_sm, *blocks)
    got, writes, visits = _emulate(a, _gemm_stage_b(b), m, n, k, p)
    _assert_once(writes, visits)
    bm, bn, bk = blocks
    want = R_ops.matmul(jnp.asarray(a), jnp.asarray(b), bm=bm, bn=bn, bk=bk,
                        implementation="interpret")
    np.testing.assert_allclose(got, np.asarray(want), *GEMM_TOL)


@pytest.mark.parametrize("shape,bk,n_sm", [
    ((24, 16, 11, 13, 3, 2), 17, H100_SMS),   # R != S; spans end mid-taps
    ((40, 17, 9, 20, 1, 4), 96, H100_SMS),
    ((130, 12, 16, 10, 5, 3), 200, H100_SMS),  # ragged K and X*Y
    ((70, 9, 12, 12, 2, 5), 33, 4),            # tiles cover a small card
])
def test_conv_decomposition_covers_once_and_matches_the_reference(
        shape, bk, n_sm):
    k, c, h, w, r, s = shape
    rng = np.random.default_rng(k * c + h)
    a = rng.standard_normal((c, h, w)).astype(np.float32)
    wt = rng.standard_normal((k, c, r, s)).astype(np.float32)
    x, y = h - r + 1, w - s + 1
    p = conv_plan(k, c, x, y, r, s, 4, n_sm, bk)
    got, writes, visits = _emulate(wt.reshape(k, -1), _conv_stage_b(a, r, s),
                                   k, x * y, c * r * s, p)
    _assert_once(writes, visits)
    if n_sm == H100_SMS:
        assert p.splits > 1                    # the split path is exercised
    want = R_ops.conv2d(jnp.asarray(a), jnp.asarray(wt), bk=bk,
                        implementation="interpret")
    np.testing.assert_allclose(got.reshape(k, x, y), np.asarray(want),
                               *CONV_TOL)


def test_a_split_span_ends_inside_a_channels_taps():
    # C*R*S = 96 in 3 spans of 32 with R*S = 6: the first span ends at
    # channel 5's third tap, and the emulation above still visits each once
    p = conv_plan(24, 16, 9, 12, 3, 2, 4, H100_SMS, 17)
    assert (p.splits, p.span) == (3, 32) and p.span % (3 * 2)


# -- the wrappers' block contract -------------------------------------------

BLOCKS = [(1, 1, 1), (17, 96, 9), (256, 256, 512), (10 ** 6, 10 ** 6, 10 ** 6)]


@pytest.mark.parametrize("bm,bn,bk", BLOCKS)
def test_wrappers_take_any_positive_block(bm, bn, bk):
    rng = np.random.default_rng(bm + bk)
    a = rng.standard_normal((33, 70)).astype(np.float32)
    b = rng.standard_normal((70, 21)).astype(np.float32)
    got = gemm(torch.from_numpy(a), torch.from_numpy(b), bm=bm, bn=bn, bk=bk)
    want = R_ops.matmul(jnp.asarray(a), jnp.asarray(b), bm=32, bn=32, bk=64,
                        implementation="interpret")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), *GEMM_TOL)
    gemm_plan(33, 21, 70, 4, H100_SMS, bm, bn, bk)      # the plan takes it too
    x = rng.standard_normal((5, 9, 8)).astype(np.float32)
    w = rng.standard_normal((6, 5, 3, 2)).astype(np.float32)
    got = conv2d(torch.from_numpy(x), torch.from_numpy(w), bk=bk)
    want = R_ops.conv2d(jnp.asarray(x), jnp.asarray(w), bk=8,
                        implementation="interpret")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), *CONV_TOL)
    conv_plan(6, 5, 7, 7, 3, 2, 4, H100_SMS, bk)


@pytest.mark.parametrize("bad", [0, -1])
def test_wrappers_refuse_a_block_that_is_not_positive(bad):
    a, b = torch.zeros(8, 16), torch.zeros(16, 4)
    for blk in (dict(bm=bad), dict(bn=bad), dict(bk=bad)):
        with pytest.raises(ValueError, match="positive"):
            gemm(a, b, **blk)
    with pytest.raises(ValueError, match="positive"):
        conv2d(torch.zeros(2, 5, 5), torch.zeros(3, 2, 3, 3), bk=bad)
