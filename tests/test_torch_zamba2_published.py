"""zamba2's published form (Zamba2-7B: ``hybrid_layer_ids``) against the
benchmark's plain float32 reference (``perfbench/reference/zamba2.py``),
on the CPU at a small size that keeps every part of its shape: two B/C
groups of two Mamba heads each, two alternating shared blocks, an irregular
hybrid list [1, 3, 4] (two hybrid layers in a row), rank-4 adapters, and an
attention head dim that is not d / heads.

Weights are drawn by ``perfbench.weights.make`` from the reference's
parameter tree, which is also the program's.  Tolerances: rtol/atol 1e-4
on float32 logits: the program and the reference compute the same float32
function, summed in other orders (the plain SSD's chunks of 128 against
the reference's 256, the chunked online-softmax attention against the
blocked one, the RoPE'd q's scale applied before or after the product).

Also: ``ops.mamba2`` with two groups against its oracle and against one
call per group, a mesh refused for several groups, and
``ModelConfig.params_dense`` for both zamba2 forms.
"""
import importlib

import numpy as np
import pytest
import torch

from perfbench import weights
from perfbench.reference import zamba2 as reference
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import abstract, reduced, zamba2
from repro_torch.models.config import ModelConfig
from repro_torch.models.tree import leaves

RTOL = ATOL = 1e-4
MODEL = dict(name="zamba2-published-small", family="zamba2", n_layers=5,
             d_model=16, n_heads=4, n_kv_heads=4, d_ff=40, vocab=96,
             head_dim=12, ssm_state=8, ssm_head_dim=8, ssm_expand=2,
             hybrid_layer_ids=[1, 3, 4], shared_blocks=2, adapter_rank=4,
             ssm_groups=2, norm_eps=1e-5, dtype="float32")
CFG = ModelConfig(**MODEL)


@pytest.fixture(scope="module")
def params():
    return weights.make(reference.param_tree(MODEL), 11, "cpu")


def _tokens(n, seed):
    return torch.randint(0, CFG.vocab, (1, n),
                         generator=torch.Generator().manual_seed(seed))


def _want(params, toks):
    with torch.no_grad():
        return reference.forward(params, MODEL, toks[0])


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=RTOL, atol=ATOL)


def test_the_small_config_keeps_the_published_shape():
    heads = CFG.ssm_expand * CFG.d_model // CFG.ssm_head_dim
    assert (heads, CFG.ssm_groups) == (4, 2)
    assert CFG.head_dim != CFG.d_model // CFG.n_heads
    ids = CFG.hybrid_layer_ids
    assert ids == (1, 3, 4) and ids[2] == ids[1] + 1


def test_program_tree_is_the_reference_tree(params):
    got = zamba2.init(CFG, 0, device="cpu")
    assert [tuple(t.shape) for t in leaves(got)] == \
        [tuple(t.shape) for t in leaves(params)]
    assert [t.dtype for t in leaves(got)] == [t.dtype for t in leaves(params)]


@pytest.mark.parametrize("n", [1, 37, 200])
def test_forward_matches_the_reference(params, n):
    toks = _tokens(n, n)
    with torch.no_grad():
        got = make_prefill_step(CFG, impl="torch")(params, {"tokens": toks})
    _close(got[0], _want(params, toks))


def test_prefill_then_dense_decode_matches_the_full_forward(params):
    toks = _tokens(48, 5)
    want = _want(params, toks)
    with torch.no_grad():
        logits, cache = make_prefill_step(CFG, impl="torch", cache_len=64)(
            params, toks[:, :30])
        _close(logits[0], want[:30])
        step = make_decode_step(CFG, impl="torch")
        for t in range(30, 48):
            logits, cache = step(params, cache, toks[:, t:t + 1],
                                 torch.tensor([t]))
            _close(logits[0, 0], want[t])


def test_paged_decode_matches_the_full_forward(params):
    """A 20-token prompt through the paged cache in two chunks, then
    decode steps, the attention KV of each hybrid call in the pool through
    a scattered page table."""
    toks = _tokens(28, 6)
    want = _want(params, toks)
    cache = zamba2.init_paged_cache(CFG, 2, 40, 32, device="cpu")
    row_map = np.full((2, 32), -1, np.int32)
    row_map[1] = np.r_[np.arange(20, 40), np.arange(0, 12)]   # slot 1
    pair = lambda t: torch.cat([torch.zeros_like(t), t])      # slot 0 idle
    with torch.no_grad():
        for a, b in ((0, 12), (12, 20)):
            logits, cache = zamba2.decode_step(
                params, CFG, cache, pair(toks[:, a:b]), [0, a],
                impl="torch", row_map=row_map)
            _close(logits[1], want[a:b])
        for t in range(20, 28):
            logits, cache = zamba2.decode_step(
                params, CFG, cache, pair(toks[:, t:t + 1]), [0, t],
                impl="torch", row_map=row_map)
            _close(logits[1, 0], want[t])
    # slot 0's pages (none mapped) stayed empty; slot 1's hold its KV
    assert cache["attn"]["k"].shape[0] == len(CFG.hybrid_layer_ids)
    assert cache["attn"]["k"][:, 20:40].abs().sum() > 0


def _ssd_inputs(b, t, h, p, g, n, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, h, p, generator=gen)
    a = -torch.rand(b, t, h, generator=gen)
    bm = torch.randn(b, t, g, n, generator=gen) * 0.5
    cm = torch.randn(b, t, g, n, generator=gen) * 0.5
    h0 = torch.randn(b, h, n, p, generator=gen)
    return x, a, bm, cm, h0


@pytest.mark.parametrize("t", [1, 70, 300])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_two_groups_against_its_oracle_and_one_call_a_group(
        t, with_state):
    x, a, bm, cm, h0 = _ssd_inputs(2, t, 6, 8, 2, 16, t)
    h0 = h0 if with_state else None
    y, hT = ops.mamba2(x, a, bm, cm, h0, implementation="torch")
    per = 3
    # the oracle, each group's b and c copied to its heads
    wy, wh = ref.mamba2_ref(x, a, bm.repeat_interleave(per, dim=2),
                            cm.repeat_interleave(per, dim=2), h0)
    np.testing.assert_allclose(y.numpy(), wy.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(hT.numpy(), wh.numpy(), rtol=1e-4, atol=1e-4)
    # one group a call: the halves of the heads, b/c stride 0 over them
    for i in range(2):
        hs = slice(i * per, (i + 1) * per)
        gy, gh = ops.mamba2(
            x[:, :, hs], a[:, :, hs],
            bm[:, :, i:i + 1].expand(2, t, per, 16),
            cm[:, :, i:i + 1].expand(2, t, per, 16),
            None if h0 is None else h0[:, hs], implementation="torch")
        assert torch.equal(gy, y[:, :, hs]) and torch.equal(gh, hT[:, hs])


def test_mamba2_refuses_groups_that_do_not_divide_the_heads():
    wrapper = importlib.import_module("repro_torch.kernels.mamba2")
    x, a, bm, cm, _ = _ssd_inputs(1, 8, 6, 8, 2, 16, 0)
    with pytest.raises(ValueError, match="mamba2 shapes"):
        wrapper.mamba2(x, a, bm[:, :, :1].repeat(1, 1, 4, 1),
                       cm[:, :, :1].repeat(1, 1, 4, 1))


def test_params_dense_counts_each_zamba2_form():
    z7, z27 = get_config("zamba2-7b"), get_config("zamba2-2.7b")
    tree = abstract(zamba2.init, z7, 0, device="cpu")
    assert z7.params_dense() == sum(t.numel() for t in leaves(tree))
    assert z7.params_dense() == pytest.approx(7.36e9, rel=2e-3)
    assert CFG.params_dense() == sum(
        t.numel() for t in leaves(zamba2.init(CFG, 0, device="cpu")))
    # the 2.7b's approximate count, as before the published form
    assert z27.params_dense() == 6_569_328_640


def test_a_mesh_with_several_groups_raises(params):
    """Several B/C groups (and the published blocks) have no sharding rule:
    the step refuses to run under a mesh, and the params refuse a
    model-parallel layout; zamba2-2.7b's form keeps its rule."""
    from repro_torch.distributed import context
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh()
    try:
        step = make_prefill_step(CFG, impl="torch", mesh=mesh)
        with pytest.raises(ValueError, match="B/C groups"):
            step(params, {"tokens": _tokens(8, 1)})
        with pytest.raises(ValueError, match="B/C groups"):
            zamba2.compute_segments(CFG, 2)
        assert zamba2.compute_segments(
            reduced(get_config("zamba2-2.7b")), 2)
    finally:
        context.reset()


def test_spec_trees_fit_the_published_trees(params):
    """Each spec tree has its tree's keys and one entry per dim of each
    leaf: the params, the dense cache and the paged cache."""
    from repro_torch.distributed.local import zip_specs

    for fn, tree in ((zamba2.specs, params),
                     (zamba2.cache_specs,
                      zamba2.init_cache(CFG, 2, 8, device="cpu")),
                     (zamba2.paged_cache_specs,
                      zamba2.init_paged_cache(CFG, 2, 8, 8, device="cpu"))):
        specs, pairs = fn(CFG), []
        zip_specs(lambda t, s, path: pairs.append((t, s, path)), tree, specs)
        assert len(pairs) == len(list(leaves(specs))) > 0
        for leaf, spec, path in pairs:
            assert len(spec) == leaf.dim(), (fn.__name__, path, spec)
    axes = zamba2.cache_slot_axes(CFG)
    assert (axes["conv"], axes["ssd"]) == (1, 1)
    assert zamba2.paged_slot_axes(CFG)["attn"] == {"k": "pool", "v": "pool"}
