"""The port's recurrent families (rwkv6-3b, zamba2-2.7b) against the
reference's, on the CPU, in reduced float32 configs.

Weights are the reference's own (``init`` with a fixed key), carried into
the port by ``models.params_from_numpy``; inputs are made with numpy.  The
port's full-sequence forward matches the reference's forward run with its
Pallas kernels interpreted and with its 'xla' recurrences (T 64, so every
reference chunk divides it); the port's decode and slot prefill match the
reference's logits and caches; and a prompt whose length no reference
chunk divides matches the reference's token-by-token decode.  Tolerances:
rtol/atol 1e-4 on float32 logits and states (the same math summed in other
orders; zamba2's KV cache is float32 here, as the config's dtype).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.steps import make_prefill_step as jmake_prefill_step
from repro.models import family_module as jfamily
from repro.models import reduced as jreduced
from repro_torch.configs import get_config
from repro_torch.kernels import plain
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import (family_module, params_from_numpy, reduced,
                                rwkv6, zamba2)
from repro_torch.models.tree import leaves

RTOL = ATOL = 1e-4
ARCHS = ("rwkv6-3b", "zamba2-2.7b")


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(port cfg, reference cfg, reference params, port params)."""
    jcfg = jreduced(jget_config(arch), dtype="float32")
    cfg = reduced(get_config(arch), dtype="float32")
    jparams = jfamily(jcfg).init(jcfg, jax.random.PRNGKey(0), tp=1)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    return cfg, jcfg, jparams, params


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _close_tree(got, want, rtol=RTOL, atol=ATOL):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(list(leaves(got)))
    for path, leaf in flat:
        t = got
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype)
        _close(t, leaf, rtol, atol)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


def test_family_module_and_published_dims():
    assert family_module(get_config("rwkv6-3b")) is rwkv6
    assert family_module(get_config("zamba2-2.7b")) is zamba2
    r, z = get_config("rwkv6-3b"), get_config("zamba2-2.7b")
    assert (r.n_layers, r.d_model, r.d_model // r.rwkv_head_dim, r.d_ff,
            r.vocab) == (32, 2560, 40, 8960, 65536)
    assert (z.n_layers, z.attn_every, z.ssm_expand * z.d_model
            // z.ssm_head_dim, z.ssm_state, z.head_dim) == (54, 6, 80, 64, 80)
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_reference_layout(arch):
    cfg, _, jparams, _ = _model(arch)
    mine = family_module(cfg).init(cfg, seed=0, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == len(list(leaves(mine)))
    for path, leaf in flat:
        t = mine
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype)
    # seeded: the same seed draws the same weights
    again = family_module(cfg).init(cfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(mine),
                                                 leaves(again)))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    cfg, jcfg, jparams, params = _model(arch)
    toks = _tokens(cfg, 2, 64, seed=0)
    got = family_module(cfg).forward(params, cfg,
                                     {"tokens": torch.from_numpy(toks)},
                                     impl="torch")
    assert got.shape == (2, 64, cfg.vocab) and got.dtype == torch.float32
    jmod = jfamily(jcfg)
    for impl in ("interpret", "xla"):
        _close(got, jmod.forward(jparams, jcfg,
                                 {"tokens": jnp.asarray(toks, jnp.int32)},
                                 tp=1, impl=impl))
    step = make_prefill_step(cfg, impl=plain)
    _close(step(params, {"tokens": torch.from_numpy(toks)}), got, 0, 0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s", [1, 4])
def test_decode_step_matches_reference(arch, s):
    """One port decode step against one reference step from the same
    cache (the reference's, after a 6-token prefill of both slots)."""
    cfg, jcfg, jparams, params = _model(arch)
    jmod = jfamily(jcfg)
    b, max_seq, pos = 2, 16, [6, 6]
    jcache = jmod.init_cache(jcfg, b, max_seq, 1)
    _, jcache = jmod.decode_step(jparams, jcfg, jcache,
                                 jnp.asarray(_tokens(cfg, b, 6, 1),
                                             jnp.int32),
                                 jnp.zeros((b,), jnp.int32), tp=1)
    cache = params_from_numpy(jax.tree_util.tree_map(np.asarray, jcache),
                              device="cpu")
    nxt = _tokens(cfg, b, s, 2)
    jlog, jcache = jmod.decode_step(jparams, jcfg, jcache,
                                    jnp.asarray(nxt, jnp.int32),
                                    jnp.asarray(pos, jnp.int32), tp=1)
    log, cache = make_decode_step(cfg, impl="torch")(
        params, cache, torch.from_numpy(nxt), np.asarray(pos))
    _close(log, jlog)
    _close_tree(cache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_prefill_step_matches_reference(arch):
    cfg, jcfg, jparams, params = _model(arch)
    toks = _tokens(cfg, 1, 9, 3)
    log, slot = make_prefill_step(cfg, impl="torch", cache_len=12)(
        params, torch.from_numpy(toks))
    jlog, jslot = jmake_prefill_step(jcfg, tp=1, cache_len=12)(
        jparams, jnp.asarray(toks, jnp.int32))
    _close(log, jlog)
    _close_tree(slot, jslot)


@pytest.mark.parametrize("arch,n", [("rwkv6-3b", 13), ("rwkv6-3b", 40),
                                    ("zamba2-2.7b", 13),
                                    ("zamba2-2.7b", 130)])
def test_ragged_prompt_matches_token_by_token_decode(arch, n):
    """A prompt of n tokens prefilled at once (through the recurrence's
    plain chunked version, padded past n when no chunk divides it) against
    the reference's decode fed one token at a time, which takes any
    length (its engine's one-shot prefill asserts n % chunk == 0 above 32
    or 128 tokens)."""
    cfg, jcfg, jparams, params = _model(arch)
    jmod = jfamily(jcfg)
    toks = _tokens(cfg, 1, n, 4)
    max_seq = n + 2
    jstep = jax.jit(lambda c, tok, pos: jmod.decode_step(
        jparams, jcfg, c, tok, pos, tp=1))
    jcache = jmod.init_cache(jcfg, 1, max_seq, 1)
    for t in range(n):
        jlog, jcache = jstep(jcache, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                             jnp.asarray([t], jnp.int32))
    mod = family_module(cfg)
    log, cache = mod.decode_step(params, cfg,
                                 mod.init_cache(cfg, 1, max_seq,
                                                device="cpu"),
                                 torch.from_numpy(toks), [0], impl="torch")
    _close(log[:, -1], jlog[:, -1])
    _close_tree(cache, jcache)
    # two halves, the state carried through decode_step, equal one whole
    half = n // 2
    cache2 = mod.init_cache(cfg, 1, max_seq, device="cpu")
    _, cache2 = mod.decode_step(params, cfg, cache2,
                                torch.from_numpy(toks[:, :half]), [0],
                                impl="torch")
    log2, cache2 = mod.decode_step(params, cfg, cache2,
                                   torch.from_numpy(toks[:, half:]), [half],
                                   impl="torch")
    _close(log2[:, -1], log[:, -1])
    for a, b in zip(leaves(cache2), leaves(cache)):
        _close(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_unported_variants_raise(arch):
    """The tensor-parallel specs are ported: each spec tree has its tree's
    keys and one entry per dim of each leaf; the paged cache is ported:
    rwkv6 pages nothing (its paged cache is its dense cache), and zamba2
    pools the shared-attention KV beside per-slot conv/SSD state, whose
    decode through a page table equals the dense decode."""
    from repro_torch.distributed.local import zip_specs
    cfg, _, _, params = _model(arch)
    mod = family_module(cfg)
    for fn, tree in ((mod.specs, params),
                     (mod.cache_specs, mod.init_cache(cfg, 1, 8,
                                                      device="cpu")),
                     (mod.paged_cache_specs,
                      mod.init_paged_cache(cfg, 1, 8, 8, device="cpu"))):
        specs = fn(cfg)
        pairs = []
        zip_specs(lambda t, s, path: pairs.append((t, s, path)), tree,
                   specs)
        assert len(pairs) == len(list(leaves(specs))) > 0
        for leaf, spec, path in pairs:
            assert len(spec) == leaf.dim(), (fn.__name__, path, spec)
    cache = mod.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        mod.pack_slot_cache(cfg, cache, 4, 5)
    with pytest.raises(ValueError, match="max_seq"):
        mod.pack_paged_slot(cfg, cache, 4, 5)
    paged = mod.init_paged_cache(cfg, 1, 8, 8, device="cpu")
    axes = mod.paged_slot_axes(cfg)
    pooled = [n for n, ax in axes.get("attn", {}).items() if ax == "pool"]
    assert pooled == (["k", "v"] if arch == "zamba2-2.7b" else [])
    row_map = np.full((1, 8), -1, np.int32)
    row_map[0, :4] = [6, 7, 2, 3]
    toks = torch.tensor([[3, 5, 7, 9]])
    got, _ = mod.decode_step(params, cfg, paged, toks, [0], impl="torch",
                             row_map=row_map)
    want, cache = mod.decode_step(params, cfg, cache, toks, [0],
                                  impl="torch")
    assert torch.equal(got, want)
    for name in pooled:
        rows = torch.tensor([6, 7, 2, 3])
        assert torch.equal(paged["attn"][name][:, rows],
                           cache["attn"][name][:, 0, :4])
