"""FSDP training on the port (``distributed.local.Fsdp``), and the
multi-pod train step, on the CPU as ``gloo`` process groups
(``launch.mesh.run_ranks``, a ``FileStore`` rendezvous under the test's
temporary directory), each run with its own timeout.

* One FSDP AdamW step (``AdamW.shard(fsdp=True)``, ``make_train_step``)
  at data=2 and at data=2 x model=2 against one process on the global
  batch, for qwen3-8b, zamba2-2.7b, rwkv6-3b, granite-moe-3b-a800m and
  gemma2-2b (its head the embedding) at reduced size in float32: loss within 1e-6 relative, the grads (from one
  ``value_and_grad`` under the layout) and the updated params within 1e-5
  of their largest value; every param shard a rank holds has the shape
  its spec gives (the ceil rule on the 'data' dim, 'model' as the
  compute view cuts it), and so have the moments.
* A (pod 2, data 2, model 1) step against one process: the loss and the
  grads are averaged over both batch axes, under ZeRO-1 and under FSDP.
* The FSDP trainer CLI on 2 ranks, crashed and resumed, ends on an
  uninterrupted run's checkpoint bytes; the checkpoint restores in one
  process (elastic 2 -> 1).
"""
import json
import textwrap
from pathlib import Path

import pytest

from repro_torch.launch.mesh import rank_json, run_ranks

SRC = str(Path(__file__).resolve().parents[1] / "src")
ONE_THREAD = {"OMP_NUM_THREADS": "1", "PYTHONPATH": SRC}
# gemma2-2b: the head tied to the embedding, gathered at both uses
ARCHS = ("qwen3-8b", "zamba2-2.7b", "rwkv6-3b", "granite-moe-3b-a800m",
         "gemma2-2b")

_COMMON = textwrap.dedent("""
    import dataclasses, json, os
    import numpy as np, torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import local
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.launch.steps import (make_loss_fn, make_train_step,
                                          shard_params, value_and_grad)
    from repro_torch.launch.train import to_device
    from repro_torch.models import family_module, reduced
    from repro_torch.models.tree import leaves, tree_map
    from repro_torch.optim import AdamW

    def f32(arch):
        return dataclasses.replace(reduced(get_config(arch)),
                                   dtype="float32")

    def batch(host):
        return to_device(host, "cpu", torch.float32)

    def rel(a, b):
        # the worst leaf's max abs difference over that leaf's max
        return max(float((x - y).abs().max())
                   / max(float(y.abs().max()), 1e-30)
                   for x, y in zip(leaves(a), leaves(b)))

    def step_vs_one(cfg, mesh, fsdp, n_batch=4):
        '''One AdamW step on ``mesh`` (FSDP or ZeRO-1) against one process
        on the global batch: relative errors, and the shard shapes.'''
        mod = family_module(cfg)
        tp = local.mesh_axis(mesh, "model")
        tp = 1 if tp is None else tp.size
        specs, segs = mod.specs(cfg), mod.compute_segments(cfg, tp)
        whole = mod.init(cfg, seed=0, tp=tp, device="cpu")
        data = SyntheticLM(cfg.vocab, 16, n_batch, seed=0)
        full, mine = batch(data.batch(0)), batch(data.global_arrays(0, mesh))
        # eps 1e-3: Adam's scaling g / (|g| + eps) would turn the float32
        # rounding of a near-zero grad into a whole update at eps 1e-8
        opt = lambda: AdamW(lr=1e-2, eps=1e-3)
        pa = tree_map(torch.clone, whole)
        oa = opt()
        pa, sa, ma = make_train_step(cfg, oa, tp=tp, impl="torch")(
            pa, oa.init(pa), full)
        ob = opt().shard(mesh, specs, segs, fsdp=fsdp)
        pb = shard_params(cfg, tree_map(torch.clone, whole), mesh, fsdp=fsdp)
        sb = ob.init(pb)
        shapes_ok = True
        if fsdp:
            # DTensor's own shards by the specs; a concatenated dim's
            # compute view (zamba2's segments over 'model') differs on it
            dt = local.distribute(whole, specs, mesh)

            def same(p, spec, path):
                d = dt
                for k in path:
                    d = d[k]
                want, got = list(d.to_local().shape), list(p.shape)
                seg = segs.get(path)
                if seg is not None:
                    del want[seg[0]], got[seg[0]]
                return got == want
            shapes_ok = all(leaves(local.zip_specs(same, pb, specs)))
            # the layout's zeros (a rank's state made without its whole)
            zeros = local.local_zeros(whole, specs, mesh, "cpu", segs,
                                      fsdp=True)
            shapes_ok &= all(z.shape == p.shape for z, p in
                             zip(leaves(zeros), leaves(pb)))
            shapes_ok &= all(m.shape == p.shape for m, p in
                             zip(leaves(sb.m), leaves(pb)))
        step = make_train_step(cfg, ob, impl="torch", mesh=mesh)
        pb, sb, mb = step(pb, sb, mine)
        got = local.full_params(pb, specs, mesh, whole, segs, fsdp=fsdp)
        return {"loss_rel": float(abs(mb["loss"] - ma["loss"])
                                  / abs(ma["loss"])),
                "gnorm_rel": float(abs(mb["grad_norm"] - ma["grad_norm"])
                                   / ma["grad_norm"]),
                "params": rel(got, pa), "shapes": bool(shapes_ok)}

    def grads_vs_one(cfg, mesh):
        '''The FSDP grads (one value_and_grad under the layout, averaged
        as the train step does) against one process's, whole.'''
        mod = family_module(cfg)
        tp = local.mesh_axis(mesh, "model")
        tp = 1 if tp is None else tp.size
        specs, segs = mod.specs(cfg), mod.compute_segments(cfg, tp)
        whole = mod.init(cfg, seed=0, tp=tp, device="cpu")
        data = SyntheticLM(cfg.vocab, 16, 4, seed=0)
        full, mine = batch(data.batch(0)), batch(data.global_arrays(0, mesh))
        _, g0 = value_and_grad(make_loss_fn(cfg, tp=tp, impl="torch"),
                               whole, full)
        layout = local.Fsdp(specs, mesh, whole)
        lp = shard_params(cfg, whole, mesh, fsdp=True)
        with local.context.use_mesh(mesh):
            _, g1 = value_and_grad(make_loss_fn(cfg, tp=tp, impl="torch"),
                                   lp, mine, layout)
        ax = local.mesh_axis(mesh, "data")
        g1 = layout.map(lambda g, part: (g if part else local.all_reduce(
            g, ax.group)) / ax.size, g1)
        g1 = local.full_params(g1, specs, mesh, whole, segs, fsdp=True)
        return rel(g1, g0)

    def finish():
        dist.destroy_process_group()
        # skip the interpreter's teardown: a gloo or autograd thread still
        # joinable there can abort the process after its work is done
        os._exit(0)

    def emit(obj):
        print(json.dumps(obj if dist.get_rank() == 0
                         else {"rank": dist.get_rank()}), flush=True)
        finish()
""")


def _run(tmp_path, body: str, world: int, timeout: float = 120):
    procs = run_ranks(["-c", _COMMON + textwrap.dedent(body)], world,
                      tmp_path, timeout=timeout, env=ONE_THREAD)
    for p in procs:
        assert p.returncode == 0, p.stderr[-4000:]
    return [rank_json(p) for p in procs]


_FSDP_BODY = """
    mesh = make_host_mesh(tp=TP)
    out = {}
    for arch in ARCHS:
        cfg = f32(arch)
        out[arch] = step_vs_one(cfg, mesh, fsdp=True)
        out[arch]["grads"] = grads_vs_one(cfg, mesh)
    emit(out)
"""


@pytest.fixture(scope="module", params=[(2, 1), (4, 2)],
                ids=["data2", "data2xmodel2"])
def fsdp_runs(request, tmp_path_factory):
    world, tp = request.param
    body = f"ARCHS = {ARCHS!r}\nTP = {tp}\n" + textwrap.dedent(_FSDP_BODY)
    return _run(tmp_path_factory.mktemp(request.node.name), body, world)[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_step_equals_one_process(fsdp_runs, arch):
    r = fsdp_runs[arch]
    assert r["shapes"], r
    assert r["loss_rel"] < 1e-6, r
    assert r["grads"] < 1e-5 and r["gnorm_rel"] < 1e-5, r
    assert r["params"] < 1e-5, r


_UNEVEN = """
    from repro_torch.distributed.sharding import P
    mesh = make_host_mesh()
    g = torch.Generator().manual_seed(0)
    # 5 rows over 2 ranks: 3 and 2 (the ceil rule); a stack of 3 layers
    whole = {"w": torch.randn(5, 3, generator=g),
             "s": torch.randn(3, 5, 4, generator=g),
             "b": torch.randn(3, generator=g)}
    specs = {"w": P("data", None), "s": P(None, "data", None), "b": P(None)}
    x = torch.randn(4, 5, generator=g)
    mine = x[2 * dist.get_rank():2 * dist.get_rank() + 2]

    def loss_fn(params, xs):
        h = xs @ local.take(params, ("w",)) + local.take(params, ("b",))
        for i in range(3):
            h = torch.tanh(torch.cat([h, h[:, :2]], -1)) \\
                @ local.take(params, ("s",), (i,))
            h = h[:, :3]
        # no gathered weight outlives its layer: the backward gathers again
        if local._SCOPE["now"] is not None:
            alive.append(len(local._SCOPE["now"].gathered))
        return (h * h).sum()

    alive = []

    _, g0 = value_and_grad(loss_fn, whole, x)
    layout = local.Fsdp(specs, mesh, whole)
    lp = local.local_params(whole, specs, mesh, fsdp=True)
    local.STATS.clear()
    _, g1 = value_and_grad(loss_fn, lp, mine, layout)
    gathers = local.STATS["all_gather"][0]
    ax = local.mesh_axis(mesh, "data")
    g1 = layout.map(lambda t, part: t if part else local.all_reduce(
        t, ax.group), g1)
    g1 = local.full_params(g1, specs, mesh, whole, fsdp=True)
    emit({"rows": [list(t.shape) for t in leaves(lp)],
          "err": rel(g1, g0),
          "gathers": gathers, "alive": alive})
"""


def test_fsdp_gathers_uneven_shards_and_a_stack_layer_by_layer(tmp_path):
    got = _run(tmp_path, _UNEVEN, 2)[0]
    assert got["rows"] == [[3, 3], [3, 3, 4], [3]]
    assert got["err"] < 1e-6, got
    # w and each layer of s gathered forward; each layer of s again where
    # the backward reads it (w's product saves no weight: its input needs
    # no gradient)
    assert got["gathers"] == 4 + 3, got
    assert got["alive"] == [0], got


_POD = """
    init_distributed("cpu")
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2, 1),
                      mesh_dim_names=("pod", "data", "model"))
    cfg = f32("qwen3-8b")
    emit({"zero1": step_vs_one(cfg, mesh, fsdp=False),
          "fsdp": step_vs_one(cfg, mesh, fsdp=True)})
"""


def test_multi_pod_step_averages_over_pod_and_data(tmp_path):
    got = _run(tmp_path, _POD, 4)[0]
    for layout, r in got.items():
        assert r["shapes"], (layout, r)
        assert r["loss_rel"] < 1e-6, (layout, r)
        assert r["gnorm_rel"] < 1e-5 and r["params"] < 1e-5, (layout, r)


def _ckpt(ckdir: Path, step: int) -> dict[str, bytes]:
    d = ckdir / f"step-{step:012d}"
    manifest = json.loads((d / "manifest.json").read_text())["leaves"]
    return {k: (d / e["file"]).read_bytes() for k, e in manifest.items()}


def test_fsdp_train_cli_resumes_bit_exact_and_restores_in_one(tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import reduced

    def args(ck):
        return ["-m", "repro_torch.launch.train", "--smoke", "--device",
                "cpu", "--arch", "zamba2-2.7b", "--steps", "6",
                "--checkpoint-every", "2", "--global-batch", "4",
                "--seq-len", "16", "--checkpoint-dir", str(ck)]

    whole = run_ranks(args(tmp_path / "whole"), 2, tmp_path / "w",
                      timeout=60, env=ONE_THREAD)
    crashed = run_ranks(args(tmp_path / "ck") + ["--inject-failure-at",
                                                 "3"], 2, tmp_path / "a",
                        timeout=60, env=ONE_THREAD)
    resumed = run_ranks(args(tmp_path / "ck"), 2, tmp_path / "b",
                        timeout=60, env=ONE_THREAD)
    for p in whole + resumed:
        assert p.returncode == 0, p.stderr[-3000:]
    for p in crashed:
        assert "injected failure at step 3" in p.stderr
    assert "resumed from checkpoint step 2" in resumed[0].stdout
    name = reduced(get_config("zamba2-2.7b")).name
    want = _ckpt(tmp_path / "whole" / name, 5)
    got = _ckpt(tmp_path / "ck" / name, 5)
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key
    # whole arrays: one process restores them and trains on
    train.main(args(tmp_path / "ck")[2:] + ["--steps", "7"])
    assert set(_ckpt(tmp_path / "ck" / name, 6)) == set(want)
