"""The port's MoE layer and the MoE / vision-prefix transformers, on the CPU.

  * ``layers.moe`` matches ``repro.models.layers.moe`` in float32 on the
    same weights: with ample capacity, with ``capacity_factor`` 1.0 so that
    tokens are dropped (a dropped token adds zeros onto its expert's last
    slot, so the kept token there must survive), with router ties (two
    experts with equal logits: the lower index wins, as ``jax.lax.top_k``
    picks it), with padded experts routed -inf, and with the int8 dispatch;
  * the routing decisions themselves (expert, slot, keep) equal the
    reference's exactly;
  * granite-moe's and internvl2's (patch prefix) full-sequence forwards
    match the reference's, and ``params_from_numpy`` carries the MoE leaves
    across in their dtypes.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import family_module as jfamily
from repro.models import layers as JL
from repro.models import reduced as jreduced
from repro_torch.configs import get_config
from repro_torch.models import family_module, reduced
from repro_torch.models import layers as L
from repro_torch.models.tree import params_from_numpy

RTOL, ATOL = 1e-5, 1e-5


def _moe_case(n_experts=6, top_k=2, capacity_factor=1.25, tie=False,
              tp=1, int8=False, b=3, s=13, d=16, f=8, seed=0):
    cfg = dataclasses.replace(
        jreduced(jget_config("granite-moe-3b-a800m")), d_model=d,
        n_experts=n_experts, top_k=top_k, moe_d_ff=f,
        capacity_factor=capacity_factor, moe_int8_dispatch=int8,
        dtype="float32")
    jp = JL.moe_init(jax.random.PRNGKey(seed), cfg, tp, jnp.float32)
    if tie:   # experts 1 and 3 get equal logits for every token
        jp["router"] = jp["router"].at[:, 3].set(jp["router"][:, 1])
    jp = jax.tree_util.tree_map(np.asarray, jp)
    x = np.random.default_rng(seed).standard_normal((b, s, d)) \
        .astype(np.float32)
    return cfg, jp, x


CASES = {
    "ample": dict(capacity_factor=4.0),
    "drops": dict(capacity_factor=1.0, s=40),
    "tie": dict(tie=True, top_k=1, capacity_factor=1.0, s=40),
    "tie-top2": dict(tie=True, top_k=2),
    "padded-experts": dict(n_experts=5, tp=4),
    "int8-dispatch": dict(int8=True),
    "decode-batch": dict(b=4, s=1, top_k=3),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_matches_the_reference(name):
    cfg, jp, x = _moe_case(**CASES[name])
    tp = CASES[name].get("tp", 1)
    want = np.asarray(JL.moe(jax.tree_util.tree_map(jnp.asarray, jp), cfg,
                             jnp.asarray(x), tp))
    got = L.moe(params_from_numpy(jp, device="cpu"), cfg,
                torch.from_numpy(x), tp).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["drops", "tie", "tie-top2"])
def test_routing_decisions_equal_the_reference(name):
    """Expert, slot and keep for every (token, k) and the gates: the same
    decisions, so capacity drops hit the same tokens."""
    cfg, jp, x = _moe_case(**CASES[name])
    k = cfg.top_k
    e = jp["w_gate"].shape[0]
    s = x.shape[1]
    cap = max(8, int(np.ceil(s * k / e * cfg.capacity_factor)))
    logits = x @ jp["router"] + jp["router_mask"]
    jout = jax.vmap(lambda a, lg: JL._dispatch_group(a, lg, k, cap))(
        jnp.asarray(x), jnp.asarray(logits))
    tout = L._dispatch_group(torch.from_numpy(x), torch.from_numpy(logits),
                             k, cap)
    for name_, j, t in zip(("buf", "flat_e", "slot", "keep", "gates"),
                           jout, tout):
        j, t = np.asarray(j), t.numpy()
        if name_ in ("buf", "gates"):
            np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(t, j, err_msg=name_)
    keep = tout[3].numpy()
    if name in ("drops", "tie"):
        assert (keep == 0).any(), "no token was dropped"
    if name.startswith("tie"):
        flat_e = tout[1].numpy()
        assert 1 in flat_e and (k > 1 or 3 not in flat_e)


@functools.lru_cache(maxsize=None)
def _model(arch):
    over = dict(dtype="float32")
    jcfg = jreduced(jget_config(arch), **over)
    jparams = jfamily(jcfg).init(jcfg, jax.random.PRNGKey(0), tp=1)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    return reduced(get_config(arch), **over), jcfg, jparams, params


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "moonshot-v1-16b-a3b",
                                  "internvl2-76b"])
def test_forward_matches_the_reference(arch):
    cfg, jcfg, jparams, params = _model(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, size=(2, 11)).astype(np.int32)
    inputs = {"tokens": toks}
    if cfg.vis_tokens:
        inputs["patches"] = rng.standard_normal(
            (2, cfg.vis_tokens, cfg.d_model)).astype(np.float32)
    want = np.asarray(jfamily(jcfg).forward(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in inputs.items()},
        impl="xla"))
    got = family_module(cfg).forward(
        params, cfg, {k: torch.from_numpy(v).long() if k == "tokens"
                      else torch.from_numpy(v) for k, v in inputs.items()},
        impl="torch").numpy()
    assert got.shape == (2, 11 + cfg.vis_tokens, cfg.vocab)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_params_from_numpy_carries_the_moe_leaves():
    jcfg = jreduced(jget_config("granite-moe-3b-a800m"))   # bfloat16
    jparams = jfamily(jcfg).init(jcfg, jax.random.PRNGKey(0), tp=1)
    moe = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jparams["layers"]["all"]["moe"]), device="cpu")
    assert moe["router"].dtype == moe["router_mask"].dtype == torch.float32
    for name in ("w_gate", "w_up", "w_down"):
        assert moe[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            moe[name].view(torch.int16).numpy(),
            np.asarray(jparams["layers"]["all"]["moe"][name]).view(np.int16))
    cfg = reduced(get_config("granite-moe-3b-a800m"))
    mine = family_module(cfg).init(cfg, device="cpu")["layers"]["all"]["moe"]
    assert {k: (v.dtype, tuple(v.shape)) for k, v in mine.items()} == \
        {k: (v.dtype, tuple(v.shape)) for k, v in moe.items()}
