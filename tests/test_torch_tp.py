"""Tensor-parallel compute on the port, on the CPU: multi-rank tests run
as ``gloo`` process groups (``launch.mesh.run_ranks``, a ``FileStore``
rendezvous under ``tmp_path``), each with its own timeout.

* The reference's decode oracle (``tests/test_distributed.py``): reduced
  qwen3 in float32, a ``model=4`` mesh against one process holding the
  same tp=4 params, max error below 1e-3 and the same argmax; and the
  one-process tp=4 port against the reference's ``make_decode_step(tp=4,
  impl="xla")`` on carried weights, at float32 tolerance.
* The paged engine on a ``model=1`` mesh is bit-identical to no mesh.
* At ``model=2`` the engines are token-identical to one process, float32,
  for qwen3, gemma2 (ring), zamba2, rwkv6 and granite-moe; and at
  ``data=2, model=2`` for qwen3.
* zamba2's segment split (``compute_segments``) and its gated norm at
  ``model=2``, one layer at a time against the whole layer: outputs, the
  carried state and every gradient.
"""
import dataclasses
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.steps import make_decode_step as jmake_decode_step
from repro.models import family_module as jfamily
from repro.models import reduced as jreduced
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh, rank_json, run_ranks
from repro_torch.launch.serve import PagedServeEngine, Request, ServeEngine
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import family_module, params_from_numpy, reduced

SRC = str(Path(__file__).resolve().parents[1] / "src")
ONE_THREAD = {"OMP_NUM_THREADS": "1", "PYTHONPATH": SRC}

# shared by the rank scripts: an f32 reduced config, requests, engines
_COMMON = textwrap.dedent("""
    import dataclasses, json, os, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.models import family_module, reduced
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import (PagedServeEngine, Request,
                                          ServeEngine)

    def f32(arch):
        return dataclasses.replace(reduced(get_config(arch)),
                                   dtype="float32")

    def requests(cfg, n=4, seed=0):
        rng = np.random.default_rng(seed)
        return [Request(i, rng.integers(0, cfg.vocab,
                                        size=int(rng.integers(3, 12))), 6)
                for i in range(n)]

    def tokens(engine, cfg):
        for r in requests(cfg):
            engine.submit(r)
        return [r.out for r in engine.run()]

    def paged(cfg, params, mesh=None, tp=1):
        return PagedServeEngine(cfg, params, slots=2, max_seq=32,
                                page_size=4, n_pages=12, prefill_chunk=5,
                                impl="torch", tp=tp, mesh=mesh)

    def dense(cfg, params, mesh=None, tp=1):
        return ServeEngine(cfg, params, slots=2, max_seq=32, impl="torch",
                           tp=tp, mesh=mesh)

    def emit(obj):
        if dist.get_rank() == 0:
            print(json.dumps(obj), flush=True)
        else:
            print(json.dumps({"rank": dist.get_rank()}), flush=True)
        dist.destroy_process_group()
        # skip the interpreter's teardown: a gloo or autograd thread still
        # joinable there can abort the process after its work is done
        os._exit(0)
""")


def _run(tmp_path, body: str, world: int, timeout: float = 110):
    procs = run_ranks(["-c", _COMMON + textwrap.dedent(body)], world,
                      tmp_path, timeout=timeout, env=ONE_THREAD)
    for p in procs:
        assert p.returncode == 0, p.stderr[-4000:]
    return rank_json(procs[0])


def test_decode_oracle_model4_against_one_process(tmp_path):
    got = _run(tmp_path, """
        from repro_torch.launch.steps import (make_cache, make_decode_step,
                                              shard_params)
        mesh = make_host_mesh(tp=4)
        cfg = f32("qwen3-8b")
        mod = family_module(cfg)
        params = mod.init(cfg, seed=0, tp=4, device="cpu")
        prompt = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab, size=(2, 6)))

        def rollout(step, p, cache):
            outs = []
            for t in range(prompt.shape[1]):
                logits, cache = step(p, cache, prompt[:, t:t + 1], t)
                outs.append(logits[:, -1].double())
            return torch.stack(outs)

        build = lambda dev: mod.init_cache(cfg, 2, 8, 4,
                                           dtype=torch.float32, device=dev)
        ref = rollout(make_decode_step(cfg, tp=4, impl="torch"), params,
                      build("cpu"))
        got = rollout(make_decode_step(cfg, impl="torch", mesh=mesh),
                      shard_params(cfg, params, mesh),
                      make_cache(cfg, mesh, build, mod.cache_specs(cfg),
                                 "cpu"))
        emit({"err": float((ref - got).abs().max()),
              "argmax": bool((ref.argmax(-1) == got.argmax(-1)).all())})
    """, 4)
    assert got["err"] < 1e-3 and got["argmax"], got


def test_one_process_tp4_against_the_reference_decode():
    arch = "qwen3-8b"
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), dtype="float32")
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    jmod, mod = jfamily(jcfg), family_module(cfg)
    jparams = jmod.init(jcfg, jax.random.PRNGKey(0), tp=4)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    jstep = jax.jit(jmake_decode_step(jcfg, tp=4, impl="xla"))
    step = make_decode_step(cfg, tp=4, impl="torch")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 6))
    jcache = jmod.init_cache(jcfg, 2, 8, 4, jnp.float32)
    cache = mod.init_cache(cfg, 2, 8, 4, dtype=torch.float32, device="cpu")
    for t in range(prompt.shape[1]):
        jl, jcache = jstep(jparams, jcache,
                           jnp.asarray(prompt[:, t:t + 1], jnp.int32),
                           jnp.int32(t))
        tl, cache = step(params, cache, torch.from_numpy(prompt[:, t:t + 1]),
                         t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("arch", ["qwen3-8b", "zamba2-2.7b"])
def test_paged_engine_on_a_one_rank_mesh_is_bit_identical(arch):
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    params = family_module(cfg).init(cfg, seed=0, device="cpu")
    mesh = make_host_mesh()

    def run(**kw):
        eng = PagedServeEngine(cfg, params, slots=2, max_seq=32,
                               page_size=4, n_pages=12, prefill_chunk=5,
                               impl="torch", **kw)
        rng = np.random.default_rng(0)
        for i in range(4):
            eng.submit(Request(i, rng.integers(0, cfg.vocab, size=7), 6))
        out = [r.out for r in eng.run()]
        return out, eng.cache

    want, wcache = run()
    got, gcache = run(mesh=mesh)
    assert got == want
    from repro_torch.models.tree import leaves
    for a, b in zip(leaves(gcache), leaves(wcache)):
        assert torch.equal(a, b)
    dense = ServeEngine(cfg, params, slots=2, max_seq=32, impl="torch",
                        mesh=mesh)
    assert dense.params["embed"]["table"].shape == \
        params["embed"]["table"].shape


def test_model2_token_identical_for_five_families(tmp_path):
    got = _run(tmp_path, """
        mesh = make_host_mesh(tp=2)
        out = {}
        for arch in ("qwen3-8b", "gemma2-2b", "zamba2-2.7b", "rwkv6-3b",
                     "granite-moe-3b-a800m"):
            cfg = f32(arch)
            params = family_module(cfg).init(cfg, seed=0, tp=2,
                                             device="cpu")
            want = tokens(paged(cfg, params, tp=2), cfg)
            got = tokens(paged(cfg, params, mesh=mesh), cfg)
            out[arch] = [got == want, got]
        cfg = f32("qwen3-8b")
        params = family_module(cfg).init(cfg, seed=0, tp=2, device="cpu")
        out["qwen3 dense"] = [tokens(dense(cfg, params, mesh=mesh), cfg)
                              == tokens(dense(cfg, params, tp=2), cfg)]
        emit(out)
    """, 2)
    for arch, res in got.items():
        assert res[0], arch


def test_data2_model2_token_identical_for_qwen3(tmp_path):
    got = _run(tmp_path, """
        mesh = make_host_mesh(tp=2)
        assert mesh.size(0) == 2
        cfg = f32("qwen3-8b")
        params = family_module(cfg).init(cfg, seed=0, tp=2, device="cpu")
        emit({"paged": tokens(paged(cfg, params, mesh=mesh), cfg)
              == tokens(paged(cfg, params, tp=2), cfg),
              "dense": tokens(dense(cfg, params, mesh=mesh), cfg)
              == tokens(dense(cfg, params, tp=2), cfg)})
    """, 4)
    assert got == {"paged": True, "dense": True}


def test_zamba2_segment_split_and_gated_norm_per_layer(tmp_path):
    got = _run(tmp_path, """
        from repro_torch.distributed import context, local
        from repro_torch.launch.steps import shard_params
        from repro_torch.models import zamba2 as Z
        from repro_torch.models.tree import layer, leaves
        mesh = make_host_mesh(tp=2)
        cfg = f32("zamba2-2.7b")
        params = Z.init(cfg, seed=0, tp=2, device="cpu")
        # a non-trivial norm and conv bias, so a wrong split shows
        g = torch.Generator().manual_seed(3)
        for name in ("norm", "conv_b", "dt_bias", "a_log"):
            t = params["layers"][name]
            t.copy_(torch.randn(t.shape, generator=g) * 0.5
                    + (1.0 if name == "norm" else 0.0))
        lp = shard_params(cfg, params, mesh)
        x = torch.randn(2, 9, cfg.d_model, generator=g)
        r = torch.randn(2, 9, cfg.d_model, generator=g)
        specs = {k: v for k, v in Z.specs(cfg)["layers"].items()}
        segs = {k[1:]: v for k, v in Z.compute_segments(cfg, 2).items()
                if k[0] == "layers"}
        errs = []
        for li in range(cfg.n_layers // 2):
            whole = {k: v[0, li].clone().requires_grad_()
                     for k, v in params["layers"].items()}
            mine = {k: v[0, li].clone().requires_grad_()
                    for k, v in lp["layers"].items()}
            y0, st0 = Z._mamba_block(whole, cfg, x, 2, "torch")
            (y0 * r).sum().backward()
            with context.use_mesh(mesh):
                y1, st1 = Z._mamba_block(mine, cfg, x, 2, "torch")
                (y1 * r).sum().backward()
            errs.append(float((y0 - y1).detach().abs().max()))
            # the carried SSD state: this rank's heads
            rank = mesh.get_local_rank("model")
            h = st0["ssd"].shape[1] // 2
            errs.append(float((st0["ssd"][:, rank * h:(rank + 1) * h]
                               - st1["ssd"]).detach().abs().max()))
            # every gradient, made whole again
            lspecs = {k: type(s)(*s[2:]) for k, s in specs.items()}
            grads = {k: v.grad for k, v in mine.items()}
            whole_g = local.full_params(
                grads, lspecs, mesh, {k: v.grad for k, v in whole.items()},
                {(k,): v for (k,), v in segs.items()})
            for k in whole:
                errs.append(float((whole_g[k] - whole[k].grad).abs().max()))
        emit({"errs": errs})
    """, 2)
    assert max(got["errs"]) < 1e-4, got
