"""The port's training path (``repro_torch.launch.steps``/``train``)
against the reference's, on the CPU, in reduced float32 configs.

Weights are the reference's own (``init`` with a fixed key), carried into
the port by ``models.params_from_numpy``; batches are made with numpy.

* Step-0 loss and gradients: the port's ``make_loss_fn`` under
  ``torch.autograd`` against the reference's
  ``jax.value_and_grad(make_loss_fn(cfg, tp=1))`` (its 'xla'
  implementation, run without a mesh) for the archs of
  ``tests/test_models_smoke.py`` and internvl2 (the loss on the text tail):
  loss within 1e-5 relative, every gradient leaf within 2e-5 of its own
  largest |grad| (float32 summed in other orders).
* A 3-step ``make_train_step`` trajectory with AdamW + cosine schedule:
  losses and params within 1e-4.
* A model with ``impl='cuda'`` under autograd raises, naming the missing
  backward, even with no card (never a silent switch to the plain
  versions); without grad it still dispatches as before.
* The attention ``torch.autograd.Function`` (``kernels.xla_attention``)
  against ``jax.vjp`` of the reference's ``chunked_attention`` (its custom
  VJP): GQA, soft-cap, window, Sq < Skv, Sq > Skv (rows that see no key:
  zero output, zero gradients), Skv 300 over chunks of 256; dq, dk, dv
  within 1e-5 of each tensor's largest value; in bfloat16 no further from
  float32 than autograd through the forward loop, times 2; ``gradcheck``
  in float64; only (q, k, v, out, lse) saved.
* The train CLI on the CPU (``--device cpu``): failure injection and
  resume, as ``tests/test_system.py`` asks of the reference's; granite-moe
  with ``--grad-compression``; ``--device cuda`` with no card refuses.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels.xla_attention import chunked_attention
from repro.launch.steps import make_loss_fn as jmake_loss_fn
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import family_module as jfamily
from repro.models import reduced as jreduced
from repro.optim import AdamW as JAdamW
from repro.optim import cosine_schedule as jcosine
from repro_torch.configs import get_config
from repro_torch.kernels import plain, xla_attention
from repro_torch.launch.steps import (make_loss_fn, make_train_step,
                                      value_and_grad)
from repro_torch.models import family_module, params_from_numpy, reduced
from repro_torch.models.tree import leaves, tree_map
from repro_torch.optim import AdamW, cosine_schedule

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-8b", "gemma2-2b", "granite-moe-3b-a800m", "rwkv6-3b",
         "zamba2-2.7b", "hubert-xlarge", "internvl2-76b")
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-5          # of each leaf's largest |grad|
B, S = 2, 16


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(port cfg, reference cfg, reference params as numpy)."""
    jcfg = jreduced(jget_config(arch), dtype="float32")
    cfg = reduced(get_config(arch), dtype="float32")
    jparams = jfamily(jcfg).init(jcfg, jax.random.PRNGKey(0), tp=1)
    return cfg, jcfg, jax.tree_util.tree_map(np.asarray, jparams)


def _batch(cfg, seed=0):
    """A numpy batch the family takes (hubert frames, internvl2 patches)."""
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.embed_inputs:
        out["frames"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.vis_tokens:
        out["patches"] = rng.standard_normal(
            (B, cfg.vis_tokens, cfg.d_model)).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in batch.items()}


def _at(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    cfg, jcfg, jnp_params = _model(arch)
    batch = _batch(cfg)
    jloss, jgrads = jax.value_and_grad(jmake_loss_fn(jcfg, tp=1))(
        jax.tree_util.tree_map(jnp.asarray, jnp_params),
        {k: jnp.asarray(v) for k, v in batch.items()})

    params = params_from_numpy(jnp_params, device="cpu")
    loss, grads = value_and_grad(make_loss_fn(cfg), params,
                                 _torch_batch(batch))

    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat) == len(list(leaves(grads)))
    for path, want in flat:
        got = _at(grads, path)
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape, path
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= GRAD_TOL * scale, (jax.tree_util.keystr(path), err,
                                         scale)


@pytest.mark.parametrize("arch", ["qwen3-8b", "zamba2-2.7b"])
def test_train_step_trajectory_matches_reference(arch):
    cfg, jcfg, jnp_params = _model(arch)
    jopt = JAdamW(lr=jcosine(3e-3, warmup=2, total=3))
    jstep = jmake_train_step(jcfg, jopt, tp=1)
    jp = jax.tree_util.tree_map(jnp.asarray, jnp_params)
    jstate = jopt.init(jp)

    opt = AdamW(lr=cosine_schedule(3e-3, warmup=2, total=3))
    step = make_train_step(cfg, opt)
    params = params_from_numpy(jnp_params, device="cpu")
    state = opt.init(params)
    for i in range(3):
        batch = _batch(cfg, seed=i)
        jp, jstate, jm = jstep(jp, jstate,
                               {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, m = step(params, state, _torch_batch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        for path, want in jax.tree_util.tree_flatten_with_path(jp)[0]:
            np.testing.assert_allclose(_at(params, path).numpy(),
                                       np.asarray(want), rtol=1e-4,
                                       atol=1e-4)
    assert int(state.step) == 3
    assert all(not p.requires_grad and p.grad is None
               for p in leaves(params))


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-3b", "zamba2-2.7b"])
def test_cuda_impl_under_grad_raises(arch):
    cfg = reduced(get_config(arch), dtype="float32")
    params = family_module(cfg).init(cfg, seed=0, device="cpu")
    batch = _torch_batch(_batch(cfg))
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    with pytest.raises(RuntimeError, match="has no backward.*kernels.plain"):
        make_loss_fn(cfg, impl="cuda")(live, batch)
    # without grad, 'cuda' dispatch is what it was: CPU tensors refused
    with torch.no_grad(), pytest.raises(ValueError, match="cuda"):
        make_loss_fn(cfg, impl="cuda")(live, batch)


def test_unused_leaf_gets_zero_grad_and_step_leaves_no_grad_state():
    cfg, _, jnp_params = _model("hubert-xlarge")
    params = params_from_numpy(jnp_params, device="cpu")
    before = params["embed"]["table"].clone()
    opt = AdamW(lr=1e-3, weight_decay=0.0)
    state = opt.init(params)
    params, state, m = make_train_step(cfg, opt)(
        params, state, _torch_batch(_batch(cfg)))
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    # hubert reads frames, never its embedding table: zero grad, no move
    assert torch.equal(params["embed"]["table"], before)
    assert torch.count_nonzero(state.m["embed"]["table"]) == 0


# ---------------------------------------------------------------------------
# the attention VJP
# ---------------------------------------------------------------------------

# (B, Sq, Skv, H, Hkv, D, causal, softcap, window, chunk)
ATTN_CASES = {
    "gqa": (2, 24, 24, 4, 2, 8, True, 0.0, 0, 8),
    "softcap": (1, 16, 16, 4, 4, 8, True, 5.0, 0, 8),
    "window": (1, 20, 20, 2, 1, 8, True, 0.0, 6, 8),
    "sq_lt_skv": (1, 5, 21, 4, 2, 8, True, 3.0, 9, 8),
    "sq_gt_skv": (1, 12, 7, 2, 2, 8, True, 0.0, 0, 4),   # rows see nothing
    "skv300": (1, 40, 300, 2, 1, 16, True, 0.0, 0, 256),
    "bidirectional": (2, 9, 9, 2, 2, 8, False, 0.0, 0, 4),
}


def _attn_inputs(case, dtype=np.float32, seed=0):
    b, sq, skv, h, hkv, d = ATTN_CASES[case][:6]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)) * 2.0
    k, v = (rng.standard_normal((b, skv, hkv, d)) for _ in range(2))
    do = rng.standard_normal((b, sq, h, d))
    return [x.astype(dtype) for x in (q, k, v, do)]


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_vjp_matches_reference(case):
    causal, softcap, window, chunk = ATTN_CASES[case][6:]
    q, k, v, do = _attn_inputs(case)
    out_ref, vjp = jax.vjp(
        lambda q, k, v: chunked_attention(q, k, v, causal, softcap, window,
                                          None, chunk), *map(jnp.asarray,
                                                             (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = plain.attention(tq, tk, tv, causal=causal, softcap=softcap,
                          window=window, chunk=chunk)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               rtol=1e-5, atol=1e-5)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1.0))
    if case == "sq_gt_skv":     # query i < Sq - Skv sees no key
        blind = ATTN_CASES[case][1] - ATTN_CASES[case][2]
        assert not out[:, :blind].any() and not got[0][:, :blind].any()


@pytest.mark.parametrize("case", ["gqa", "softcap", "sq_lt_skv"])
def test_attention_vjp_bfloat16_as_close_as_autograd_through_the_loop(case):
    """bfloat16 inputs: the Function's gradients are no further from
    autograd through the forward loop in float32 (same values) than
    autograd through the loop in bfloat16 is, times 2 (the card's check,
    ``chip_smoke.py`` phase 19)."""
    causal, softcap, window, chunk = ATTN_CASES[case][6:]
    xs = [torch.from_numpy(x).to(torch.bfloat16)
          for x in _attn_inputs(case)]
    sc = xs[0].shape[-1] ** -0.5

    def grads(fn, dtype):
        q, k, v = (x.to(dtype).requires_grad_() for x in xs[:3])
        return torch.autograd.grad(fn(q, k, v), (q, k, v), xs[3].to(dtype))

    loop = lambda q, k, v: xla_attention._forward(
        q, k, v, causal, softcap, window, sc, chunk)[0].to(q.dtype)
    got = grads(lambda q, k, v: plain.attention(
        q, k, v, causal=causal, softcap=softcap, window=window, chunk=chunk),
        torch.bfloat16)
    for g, s_, w in zip(got, grads(loop, torch.bfloat16),
                        grads(loop, torch.float32)):
        assert g.dtype == torch.bfloat16
        err = float((g.float() - w).abs().max())
        assert err <= 2 * float((s_.float() - w).abs().max())


def test_attention_vjp_gradcheck_float64():
    q, k, v, _ = _attn_inputs("sq_lt_skv", np.float64)
    ts = [torch.from_numpy(x[:, :, :, :4].copy()).requires_grad_()
          for x in (q, k, v)]
    fn = lambda q, k, v: plain.attention(q, k, v, softcap=3.0, window=9,
                                         chunk=8)
    assert torch.autograd.gradcheck(fn, ts, eps=1e-6, atol=1e-6)


def test_attention_saves_only_q_k_v_out_lse():
    q, k, v, _ = _attn_inputs("skv300")
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        out = xla_attention.attention(tq, tk, tv)
    b, sq, h, d = tq.shape
    hkv = tk.shape[2]
    assert [tuple(t.shape) for t in saved] == [
        tuple(tq.shape), tuple(tk.shape), tuple(tv.shape), tuple(out.shape),
        (b, sq, hkv, h // hkv)]
    assert saved[0] is tq and saved[1] is tk and saved[2] is tv
    assert sum(t.numel() for t in saved) < 2 * sum(
        t.numel() for t in (tq, tk, tv, out))   # nothing of size Sq x Skv


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _run(args, timeout=300):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], text=True, capture_output=True,
                          timeout=timeout, env=env, cwd=ROOT)


def test_cli_failure_injection_and_resume(tmp_path):
    ck = str(tmp_path / "ck")
    common = ["--arch", "qwen3-8b", "--smoke", "--device", "cpu", "--steps",
              "12", "--checkpoint-every", "4", "--checkpoint-dir", ck]
    first = _run(common + ["--inject-failure-at", "6"])
    assert first.returncode != 0
    assert "injected failure at step 6" in (first.stdout + first.stderr)
    second = _run(common)
    assert second.returncode == 0, second.stderr[-2000:]
    assert "resumed from checkpoint step 4" in second.stdout
    assert "step   11" in second.stdout
    assert "done; checkpoints in" in second.stdout


def test_cli_grad_compression(tmp_path):
    out = _run(["--arch", "granite-moe-3b-a800m", "--smoke", "--device",
                "cpu", "--steps", "4", "--checkpoint-dir",
                str(tmp_path / "ck2"), "--grad-compression"])
    assert out.returncode == 0, out.stderr[-2000:]
    assert "step    3" in out.stdout


def test_cli_refuses_a_missing_card_and_a_mesh(tmp_path):
    from repro_torch.launch import train

    ck = str(tmp_path / "ck")
    # the production mesh needs 256 ranks; this process group has one
    with pytest.raises(SystemExit, match="needs 256 ranks, the process "
                                         "group has 1"):
        train.main(["--smoke", "--device", "cpu", "--production-mesh",
                    "--checkpoint-dir", ck])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            train.main(["--smoke", "--checkpoint-dir", ck])  # default: card
