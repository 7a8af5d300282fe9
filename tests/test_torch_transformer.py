"""The port's transformer family against the reference's, on the CPU.

Weights are the reference's own (``init`` with a fixed key), carried into
the port by ``params_from_numpy``; inputs are made with numpy.  In float32
the port's full-sequence forward matches the reference's forward run with
its Pallas flash kernel interpreted (``impl="interpret"``) and with its
chunked 'xla' attention, and the port's decode path matches the reference's
logits and caches.  Tolerances: rtol/atol 1e-4 on float32 logits (the two
stacks sum in other orders; the KV cache rounds to bfloat16 in both).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.steps import make_prefill_step as jmake_prefill_step
from repro.models import family_module as jfamily
from repro.models import layers as JL
from repro.models import reduced as jreduced
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import plain
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import family_module, reduced
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

from _config_parity import same_config

RTOL = ATOL = 1e-4
KEY = jax.random.PRNGKey(0)
GEMMA_RING = (("local_window", 5), ("n_layers", 4))
CASES = [("qwen3-8b", ()), ("gemma2-2b", GEMMA_RING),
         ("hubert-xlarge", (("head_dim", 80),))]


@functools.lru_cache(maxsize=None)
def _model(arch, over=(), dtype="float32", **extra):
    """(port cfg, reference cfg, reference params, port params) for a
    reduced config, the port's weights copied from the reference's."""
    over = dict(over, dtype=dtype, **extra)
    jcfg = jreduced(jget_config(arch), **over)
    cfg = reduced(get_config(arch), **over)
    jparams = jfamily(jcfg).init(jcfg, KEY, tp=1)
    params = T.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                 device="cpu")
    return cfg, jcfg, jparams, params


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.float() if
                                          isinstance(got, torch.Tensor)
                                          else got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _inputs(cfg, b=2, s=12, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        frames = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        return {"frames": torch.from_numpy(frames)}, \
            {"frames": jnp.asarray(frames)}
    toks = rng.integers(0, cfg.vocab, (b, s))
    return {"tokens": torch.from_numpy(toks)}, \
        {"tokens": jnp.asarray(toks, jnp.int32)}


def test_configs_are_the_reference_configs():
    for arch in ARCH_IDS:
        same_config(get_config(arch), jget_config(arch))
        same_config(reduced(get_config(arch)), jreduced(jget_config(arch)))
    qwen = get_config("qwen3-8b")
    assert (qwen.n_layers, qwen.d_model, qwen.n_heads, qwen.n_kv_heads,
            qwen.head_dim, qwen.d_ff, qwen.vocab) == \
        (36, 4096, 32, 8, 128, 12288, 151936)


@pytest.mark.parametrize("arch,over", CASES, ids=[c[0] for c in CASES])
def test_init_has_the_reference_layout(arch, over):
    cfg, _, jparams, _ = _model(arch, over)
    mine = T.init(cfg, seed=0, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    flat_t = {jax.tree_util.keystr(p): None for p, _ in flat_j}
    seen = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + f"['{k}']")
            else:
                seen[path + f"['{k}']"] = v
    walk(mine, "")
    assert set(seen) == set(flat_t)
    for p, leaf in flat_j:
        t = seen[jax.tree_util.keystr(p)]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype)


@pytest.mark.parametrize("arch,over", CASES, ids=[c[0] for c in CASES])
def test_forward_matches_reference(arch, over):
    cfg, jcfg, jparams, params = _model(arch, over)
    tin, jin = _inputs(cfg)
    got = family_module(cfg).forward(params, cfg, tin, impl="torch")
    assert got.shape == (2, 12, cfg.vocab) and got.dtype == torch.float32
    jmod = jfamily(jcfg)
    for impl in ("interpret", "xla"):
        _close(got, jmod.forward(jparams, jcfg, jin, tp=1, impl=impl))
    # the prefill-scoring step is this forward, and so is the forward given
    # the plain versions as a namespace (how the card compares the two)
    _close(make_prefill_step(cfg, impl="torch")(params, tin), got, 0, 0)
    _close(make_prefill_step(cfg, impl=plain)(params, tin), got, 0, 0)


def test_layer_numerics_round_like_the_reference_in_bfloat16():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 4, 32)).astype(np.float32)
    w = rng.standard_normal((32,)).astype(np.float32)
    pos = np.tile(np.arange(6), (2, 1))
    tx, tw = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
    jx, jw = (jnp.asarray(a, jnp.bfloat16) for a in (x, w))
    one_ulp = dict(rtol=2 ** -7, atol=2 ** -7)   # bfloat16 outputs
    for plus_one in (False, True):
        got = L.rms_norm(tx, tw, plus_one=plus_one)
        assert got.dtype == torch.bfloat16
        _close(got, JL.rms_norm(jx, jw, plus_one=plus_one), **one_ulp)
    got = L.rope(tx, torch.from_numpy(pos), 1e6)
    assert got.dtype == torch.bfloat16
    _close(got, JL.rope(jx, jnp.asarray(pos), 1e6), **one_ulp)
    _close(L.softcap(tx * 40, 30.0), JL.softcap(jx * 40, 30.0), **one_ulp)


def _decode_case(arch, over, pos, s, extra=()):
    """One port decode step against one reference decode step, from the
    same cache state (the reference's, after a first step at pos 0)."""
    cfg, jcfg, jparams, params = _model(arch, over, **dict(extra))
    jmod, mod = jfamily(jcfg), family_module(cfg)
    rng = np.random.default_rng(7)
    b, max_seq = len(pos), 16
    first = rng.integers(0, cfg.vocab, (b, 6))
    nxt = rng.integers(0, cfg.vocab, (b, s))
    jcache = jmod.init_cache(jcfg, b, max_seq, 1)
    _, jcache = jmod.decode_step(jparams, jcfg, jcache,
                                 jnp.asarray(first, jnp.int32),
                                 jnp.zeros((b,), jnp.int32), tp=1)
    cache = T.params_from_numpy(jax.tree_util.tree_map(np.asarray, jcache),
                                device="cpu")
    jlog, jcache = jmod.decode_step(jparams, jcfg, jcache,
                                    jnp.asarray(nxt, jnp.int32),
                                    jnp.asarray(pos, jnp.int32), tp=1)
    log, cache = make_decode_step(cfg, impl="torch")(
        params, cache, torch.from_numpy(nxt), np.asarray(pos))
    _close(log, jlog)
    flat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    for path, leaf in flat:
        t = cache
        for key in path:
            t = t[key.key]
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype)
        _close(t, np.asarray(leaf, np.float32), rtol=2 ** -7, atol=2e-3)
    return cfg, cache


@pytest.mark.parametrize("arch,over,pos,s,extra", [
    ("qwen3-8b", (), [6, 9], 1, ()),
    ("qwen3-8b", (), [3, 6], 4, ()),
    ("qwen3-8b", (), [6, 2], 1, (("kv_int8", True),)),
    ("gemma2-2b", GEMMA_RING, [6, 11], 1, ()),
    ("gemma2-2b", GEMMA_RING, [6, 3], 7, ()),        # overflows the ring
], ids=["qwen-1tok", "qwen-4tok", "qwen-int8", "gemma-ring", "gemma-wrap"])
def test_decode_step_matches_reference(arch, over, pos, s, extra):
    _decode_case(arch, over, pos, s, extra)


def test_idle_slot_write_past_the_cache_is_dropped():
    """A retired slot parks at pos == max_seq and still rides the batched
    decode step: its K/V rows fall past the cache.  The reference drops
    them (mode="drop"); the port must too, without raising and without
    touching any row, including by wrapping a negative index."""
    cfg, jcfg, jparams, params = _model("qwen3-8b")
    mod, jmod = family_module(cfg), jfamily(jcfg)
    max_seq = 8
    cache = mod.init_cache(cfg, 2, max_seq, device="cpu")
    # seeded: the second layer's new K/V depend on the first layer's
    # attention over this content, and their bfloat16 rounding is held
    # exactly to the reference's, so the content must not change from run
    # to run (an unseeded draw made the test depend on the tests before it)
    rng = np.random.default_rng(0)
    for leaf in (cache["all"]["k"], cache["all"]["v"]):
        leaf.copy_(torch.from_numpy(rng.standard_normal(leaf.shape)
                                    .astype(np.float32)).to(leaf.dtype))
    before = {n: t.clone() for n, t in cache["all"].items()}
    toks = np.array([[5, 6, 7], [8, 9, 10]])
    pos = np.array([2, max_seq])        # slot 1 writes rows 8..10: all past
    jcache = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16), cache)
    log, cache = mod.decode_step(params, cfg, cache, torch.from_numpy(toks),
                                 pos, impl="torch")
    for n in ("k", "v"):
        assert torch.equal(cache["all"][n][:, 1], before[n][:, 1])
        assert torch.equal(cache["all"][n][:, 0, :2], before[n][:, 0, :2])
        assert torch.equal(cache["all"][n][:, 0, 5:], before[n][:, 0, 5:])
        assert not torch.equal(cache["all"][n][:, 0, 2:5],
                               before[n][:, 0, 2:5])
    jlog, jcache = jmod.decode_step(jparams, jcfg, jcache,
                                    jnp.asarray(toks, jnp.int32),
                                    jnp.asarray(pos, jnp.int32), tp=1)
    _close(log, jlog)
    _close(cache["all"]["k"], np.asarray(jcache["all"]["k"], np.float32),
           0, 0)
    # a straddling write keeps its in-range rows and drops the rest
    _, cache = mod.decode_step(params, cfg, cache, torch.from_numpy(toks),
                               np.array([6, 6]), impl="torch")
    _, jcache = jmod.decode_step(jparams, jcfg, jcache,
                                 jnp.asarray(toks, jnp.int32),
                                 jnp.asarray([6, 6], jnp.int32), tp=1)
    _close(cache["all"]["v"], np.asarray(jcache["all"]["v"], np.float32),
           0, 0)


@pytest.mark.parametrize("arch,over", CASES[:2], ids=["qwen3-8b", "gemma2"])
def test_slot_prefill_step_matches_reference(arch, over):
    cfg, jcfg, jparams, params = _model(arch, over)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (1, 9))
    log, slot = make_prefill_step(cfg, impl="torch", cache_len=12)(
        params, torch.from_numpy(toks))
    jlog, jslot = jmake_prefill_step(jcfg, tp=1, cache_len=12)(
        jparams, jnp.asarray(toks, jnp.int32))
    _close(log, jlog)
    for group in slot:
        for n in ("k", "v"):
            assert tuple(slot[group][n].shape) == jslot[group][n].shape
            _close(slot[group][n], np.asarray(jslot[group][n], np.float32),
                   rtol=2 ** -7, atol=2e-3)
    # the last position's logits are the full-sequence forward's, up to
    # the bfloat16 rounding of the cached K/V that the forward never does
    fwd = family_module(cfg).forward(params, cfg,
                                     {"tokens": torch.from_numpy(toks)},
                                     impl="torch")
    _close(log[0, -1], fwd[0, -1], rtol=2e-2, atol=2e-2)


def test_params_from_numpy_keeps_bfloat16_bits():
    a = jnp.asarray(np.random.default_rng(0).standard_normal((3, 5)),
                    jnp.bfloat16)
    t = T.params_from_numpy({"w": np.asarray(a)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(),
                          np.asarray(a).view(np.int16))


def test_unported_parts_raise():
    """Nothing of the family raises any more: MoE blocks and the internvl2
    patch prefix build and run, and a page table given with a dense
    (4-D) cache leaves the dense path as it is, as in the reference."""
    moe_cfg = reduced(get_config("granite-moe-3b-a800m"))
    moe_params = T.init(moe_cfg, device="cpu")
    assert set(moe_params["layers"]["all"]) >= {"moe"}
    assert "mlp" not in moe_params["layers"]["all"]
    vis_cfg = reduced(get_config("internvl2-76b"))
    toks = torch.zeros(1, 3, dtype=torch.int64)
    logits = T.forward(T.init(vis_cfg, device="cpu"), vis_cfg, {
        "tokens": toks, "patches": torch.zeros(1, vis_cfg.vis_tokens,
                                               vis_cfg.d_model,
                                               dtype=torch.bfloat16)},
        impl="torch")
    assert logits.shape == (1, 3 + vis_cfg.vis_tokens, vis_cfg.vocab)
    cfg, _, _, params = _model("qwen3-8b")
    cache = T.init_cache(cfg, 1, 8, device="cpu")
    dense = T.init_cache(cfg, 1, 8, device="cpu")
    got, _ = T.decode_step(params, cfg, cache, torch.ones(1, 1, dtype=int),
                           0, impl="torch", row_map=np.zeros((1, 8)))
    want, _ = T.decode_step(params, cfg, dense, torch.ones(1, 1, dtype=int),
                            0, impl="torch")
    assert torch.equal(got, want)
