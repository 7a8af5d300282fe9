"""The port's optimizer, gradient compression and data pipeline against the
reference's, on the CPU, from the same numpy inputs.

* ``AdamW.update`` (float32 and bfloat16 params, float32 moments, with
  and without clipping, several steps of the cosine schedule) and
  ``cosine_schedule`` within 1e-6 of the reference's; the update gives the
  same result when it walks a leaf in slices; the reference's own
  behaviour cases (a quadratic minimised, the clip bound).
* ``ef_compress``: int8 codes bit-identical (``torch.round`` and
  ``jnp.round`` both round half to even), the compressed grads equal and
  the residual within float32 rounding; error feedback stays unbiased.
* ``SyntheticLM`` batches bit-identical at several steps and seeds;
  ``Prefetcher`` in order; the mesh-bound batchers give a rank its rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.optim.adamw as TA
from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.optim import AdamW as RAdamW
from repro.optim import cosine_schedule as rcosine
from repro.optim.compression import _quantize_int8 as r_quantize
from repro.optim.compression import ef_compress as ref_compress
from repro.optim.compression import ef_init as ref_init
from repro_torch.data import Prefetcher, SyntheticLM, make_global_batch
from repro_torch.optim import AdamW, cosine_schedule, ef_compress, ef_init
from repro_torch.optim.compression import _quantize_int8

TOL = 1e-6


def _draw(seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(rng.standard_normal(s), np.float32)
            for k, s in shapes.items()}


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(torch.bfloat16)


def _to_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_matches_reference(dtype, clip):
    shapes = {"w": (7, 5), "b": (5,), "s": ()}
    p0 = _draw(0, shapes)
    kw = dict(lr=cosine_schedule(1e-2, warmup=2, total=6), b1=0.9, b2=0.95,
              weight_decay=0.1, clip_norm=clip)
    ropt = RAdamW(**{**kw, "lr": rcosine(1e-2, warmup=2, total=6)})
    opt = AdamW(**kw)
    if dtype == "bfloat16":
        params = {k: _bf16(v) for k, v in p0.items()}
        rparams = {k: jnp.asarray(_to_np(v), jnp.bfloat16)
                   for k, v in params.items()}
    else:
        params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        rparams = {k: jnp.asarray(v) for k, v in p0.items()}
    state, rstate = opt.init(params), ropt.init(rparams)
    for step in range(5):
        g = _draw(10 + step, shapes)
        grads = {k: torch.from_numpy(np.asarray(v * 3.0)).to(
            getattr(torch, dtype)) for k, v in g.items()}
        rgrads = {k: jnp.asarray(_to_np(v), dtype) for k, v in grads.items()}
        params, state, gnorm = opt.update(grads, state, params)
        rparams, rstate, rgnorm = ropt.update(rgrads, rstate, rparams)
        np.testing.assert_allclose(float(gnorm), float(rgnorm), rtol=TOL)
        for k in shapes:
            assert params[k].dtype == getattr(torch, dtype)
            np.testing.assert_allclose(_to_np(params[k]),
                                       np.asarray(rparams[k], np.float32),
                                       rtol=TOL, atol=TOL)
            np.testing.assert_allclose(state.m[k].numpy(),
                                       np.asarray(rstate.m[k]), rtol=TOL,
                                       atol=TOL)
            np.testing.assert_allclose(state.v[k].numpy(),
                                       np.asarray(rstate.v[k]), rtol=TOL,
                                       atol=TOL)
        assert int(state.step) == int(rstate.step) == step + 1


def test_adamw_slices_give_the_whole_leaf_result(monkeypatch):
    shapes = {"w": (33, 31)}
    grads = {"w": torch.from_numpy(_draw(1, shapes)["w"])}

    def run():
        params = {"w": torch.from_numpy(_draw(0, shapes)["w"])}
        opt = AdamW(lr=1e-2)
        state = opt.init(params)
        for _ in range(3):
            params, state, gnorm = opt.update(grads, state, params)
        return params["w"], state.m["w"], state.v["w"]

    whole = run()
    monkeypatch.setattr(TA, "SLICE", 100)          # 11 slices a leaf
    for a, b in zip(run(), whole):
        assert torch.equal(a, b)


def test_adamw_minimizes_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0, clip_norm=0.0)
    params = {"x": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(150):
        grads = {"x": 2.0 * params["x"]}
        params, state, _ = opt.update(grads, state, params)
    assert float(params["x"].abs().max()) < 0.15


def test_adamw_clipping_bounds_update():
    opt = AdamW(lr=1.0, clip_norm=1.0, weight_decay=0.0)
    params = {"x": torch.zeros(3)}
    state = opt.init(params)
    _, _, gnorm = opt.update({"x": torch.tensor([1e4, 0.0, 0.0])}, state,
                             params)
    assert float(gnorm) == pytest.approx(1e4)
    # the moments keep the params' full specs (ZeRO-1's layout)
    from repro_torch.distributed.sharding import P
    specs = {"x": P("data", "model")}
    got = opt.init_specs(specs)
    assert got.step == P() and got.m == specs and got.v == specs


@pytest.mark.parametrize("step", [0, 1, 3, 10, 11, 50, 99, 100, 150])
def test_cosine_schedule_matches_reference(step):
    lr = cosine_schedule(1.0, warmup=10, total=100, floor=0.1)
    rlr = rcosine(1.0, warmup=10, total=100, floor=0.1)
    got = float(lr(torch.tensor(step, dtype=torch.int32)))
    assert got == pytest.approx(float(rlr(jnp.int32(step))), rel=TOL,
                                abs=TOL)
    assert lr(torch.tensor(step)).dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ef_compress_codes_bit_identical(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(4096) * 10 ** rng.uniform(-3, 3)).astype(
        np.float32)
    # exact halves of the step: round half to even must agree
    x[:8] = (np.arange(8) + 0.5) * (np.abs(x).max() / 127.0)
    q, scale = _quantize_int8(torch.from_numpy(x))
    rq, rscale = r_quantize(jnp.asarray(x))
    assert float(scale) == float(rscale)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))

    g = {"w": x.reshape(64, 64), "b": x[:64] * 0.5}
    e = {k: rng.standard_normal(v.shape).astype(np.float32) * 1e-2
         for k, v in g.items()}
    cg, ce = ef_compress({k: torch.from_numpy(v) for k, v in g.items()},
                         {k: torch.from_numpy(v) for k, v in e.items()})
    rcg, rce = ref_compress({k: jnp.asarray(v) for k, v in g.items()},
                            {k: jnp.asarray(v) for k, v in e.items()})
    for k in g:
        np.testing.assert_array_equal(cg[k].numpy(), np.asarray(rcg[k]))
        scale = float(np.abs(np.asarray(rce[k])).max()) + 1e-30
        np.testing.assert_allclose(ce[k].numpy(), np.asarray(rce[k]),
                                   rtol=0, atol=1e-6 * max(scale, 1.0))


def test_ef_compression_error_feedback_unbiased():
    """With constant gradients, EF-int8 compressed sums converge to the
    true sum: the residual never escapes."""
    g = {"w": torch.linspace(-1, 1, 64) * 0.37}
    ef = ef_init(g)
    rg = {"w": jnp.asarray(g["w"].numpy())}
    ref = ref_init(rg)
    assert ef["w"].dtype == torch.float32 and ef["w"].shape == (64,)
    total = torch.zeros(64)
    for _ in range(50):
        cg, ef = ef_compress(g, ef)
        total = total + cg["w"]
        _, ref = ref_compress(rg, ref)
    np.testing.assert_allclose(total.numpy(), g["w"].numpy() * 50,
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(ef["w"].numpy(), np.asarray(ref["w"]),
                               atol=1e-6)


@pytest.mark.parametrize("seed", [0, 3, 17])
@pytest.mark.parametrize("step", [0, 1, 5, 1000])
def test_synthetic_lm_bit_identical(seed, step):
    args = dict(vocab=32000, seq_len=33, global_batch=3, seed=seed)
    got = SyntheticLM(**args).batch(step)
    want = RSyntheticLM(**args).batch(step)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])


def test_data_step_determinism():
    d = SyntheticLM(vocab=100, seq_len=8, global_batch=4, seed=3)
    a, b = d.batch(5), d.batch(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], d.batch(6)["tokens"])
    # on a one-rank mesh the rank's rows are the whole batch, bit for bit
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh()
    for got in (d.global_arrays(5, mesh), make_global_batch(d, mesh, 5)):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], a[k])


def test_prefetcher_order():
    seen = []

    def fn(step):
        seen.append(step)
        return {"x": step}

    pf = Prefetcher(fn, start_step=2)
    got = [pf.get() for _ in range(4)]
    assert [s for s, _ in got] == [2, 3, 4, 5]
    assert [b["x"] for _, b in got] == [2, 3, 4, 5]
