"""Data-parallel and sharded training on the port, on the CPU, as
``gloo`` process groups (``launch.mesh.run_ranks``, a ``FileStore``
rendezvous under ``tmp_path``), each test with its own timeout.

* A two-rank data-parallel step (``make_train_step(mesh=)``) against one
  process on the global batch: loss at rel 1e-6, grads and the updated
  params at float32 tolerance, with ZeRO-1's moments sharded over 'data'
  (half a leaf a rank) and gathered back equal.
* ``SyntheticLM.global_arrays``: each rank's rows are ``batch(step)``'s,
  bit for bit (two and four ranks).
* A ``model=2`` train step differentiates through the collectives: loss
  and every grad against one process with the same tp=2 params, with the
  activation spec installed (sequence-parallel) and without, for qwen3 and
  zamba2.
* The reference's elastic scenario (``tests/test_distributed.py``): a
  checkpoint saved from 4 ranks restores onto 2.
* The 4-stage GPipe pipeline against the sequential loop (atol 1e-5).
"""
import textwrap
from pathlib import Path

from repro_torch.launch.mesh import rank_json, run_ranks

SRC = str(Path(__file__).resolve().parents[1] / "src")
ONE_THREAD = {"OMP_NUM_THREADS": "1", "PYTHONPATH": SRC}

_COMMON = textwrap.dedent("""
    import dataclasses, json, os
    import numpy as np, torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import context, local
    from repro_torch.distributed.context import DEFAULT_TRAIN_SPEC
    from repro_torch.launch.mesh import make_host_mesh
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

    def maxerr(a, b):
        return max(float((x - y).abs().max())
                   for x, y in zip(leaves(a), leaves(b)))

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


def _run(tmp_path, body: str, world: int, timeout: float = 110):
    procs = run_ranks(["-c", _COMMON + textwrap.dedent(body)], world,
                      tmp_path, timeout=timeout, env=ONE_THREAD)
    for p in procs:
        assert p.returncode == 0, p.stderr[-4000:]
    return [rank_json(p) for p in procs]


def test_data_parallel_zero1_step_equals_one_process(tmp_path):
    got = _run(tmp_path, """
        mesh = make_host_mesh()
        assert mesh.size(0) == 2
        out = {}
        for arch in ("qwen3-8b", "zamba2-2.7b"):
            cfg = f32(arch)
            mod = family_module(cfg)
            whole = mod.init(cfg, seed=0, device="cpu")
            data = SyntheticLM(cfg.vocab, 16, 4, seed=0)
            mine = data.global_arrays(0, mesh)
            full = data.batch(0)
            r = dist.get_rank()
            rows_ok = all(np.array_equal(mine[k], full[k][2 * r:2 * r + 2])
                          for k in ("tokens", "labels"))
            # the grads: local rows averaged over 'data' vs the whole batch
            loss_fn = make_loss_fn(cfg, impl="torch")
            l0, g0 = value_and_grad(loss_fn, whole, batch(full))
            l1, g1 = value_and_grad(loss_fn, whole, batch(mine))
            ax = local.mesh_axis(mesh, "data")
            l1 = local.all_reduce(l1, ax.group) / 2
            g1 = tree_map(lambda g: local.all_reduce(g, ax.group) / 2, g1)
            # one AdamW step: one process vs ZeRO-1 on the mesh
            pa = tree_map(torch.clone, whole)
            oa = AdamW(lr=1e-2)
            pa, sa, ma = make_train_step(cfg, oa, impl="torch")(
                pa, oa.init(pa), batch(full))
            ob = AdamW(lr=1e-2).shard(mesh, mod.specs(cfg),
                                      mod.compute_segments(cfg, 1))
            pb = shard_params(cfg, tree_map(torch.clone, whole), mesh)
            sb = ob.init(pb)
            halves = sum(int(m.numel() * 2 == p.numel())
                         for m, p in zip(leaves(sb.m), leaves(pb)))
            pb, sb, mb = make_train_step(cfg, ob, impl="torch",
                                         mesh=mesh)(pb, sb, batch(mine))
            out[arch] = {
                "rows": rows_ok,
                "loss_rel": float(abs(l1 - l0) / abs(l0)),
                "grad": maxerr(g0, g1),
                "step_loss_rel": float(abs(mb["loss"] - ma["loss"])
                                       / abs(ma["loss"])),
                "gnorm_rel": float(abs(mb["grad_norm"] - ma["grad_norm"])
                                   / ma["grad_norm"]),
                "params": maxerr(pa, pb),
                "m": maxerr(sa.m, ob.gather_moments(sb.m)),
                "v": maxerr(sa.v, ob.gather_moments(sb.v)),
                "halves": halves, "leaves": len(list(leaves(pb)))}
        emit(out)
    """, 2)
    for arch, r in got[0].items():
        assert r["rows"], arch
        assert r["loss_rel"] < 1e-6 and r["step_loss_rel"] < 1e-6, r
        assert r["grad"] < 1e-5 and r["gnorm_rel"] < 1e-5, r
        assert r["m"] < 1e-6 and r["v"] < 1e-8, r
        # Adam divides by sqrt(v): where a grad is ~0 its f32 rounding
        # moves the update, so the params are held to 1% of one update
        # (lr 1e-2)
        assert r["params"] < 1e-4, r
        # ZeRO-1: every leaf the specs shard over 'data' holds half
        assert r["halves"] >= r["leaves"] // 2, r


def test_global_arrays_rows_on_four_ranks(tmp_path):
    got = _run(tmp_path, """
        out = []
        for tp in (1, 2):
            mesh = make_host_mesh(tp=tp)
            d = SyntheticLM(100, 8, 8, seed=3)
            n = 8 // mesh.size(0)
            lo = mesh.get_coordinate()[0] * n
            mine, full = d.global_arrays(7, mesh), d.batch(7)
            out.append(all(np.array_equal(mine[k], full[k][lo:lo + n])
                           for k in ("tokens", "labels")))
        emit({"ok": out})
    """, 4)
    assert got[0]["ok"] == [True, True]


def test_model2_train_step_differentiates_with_and_without_the_spec(
        tmp_path):
    got = _run(tmp_path, """
        mesh = make_host_mesh(tp=2)
        out = {}
        for arch in ("qwen3-8b", "zamba2-2.7b"):
            cfg = f32(arch)
            mod = family_module(cfg)
            whole = mod.init(cfg, seed=0, tp=2, device="cpu")
            data = SyntheticLM(cfg.vocab, 16, 2, seed=1)
            b = batch(data.batch(0))
            l0, g0 = value_and_grad(make_loss_fn(cfg, tp=2, impl="torch"),
                                    whole, b)
            lp = shard_params(cfg, whole, mesh)
            loss_fn = make_loss_fn(cfg, tp=2, impl="torch")
            res = []
            for spec in (None, DEFAULT_TRAIN_SPEC):
                with context.use_mesh(mesh), context.activation_spec(spec):
                    sp = context.sequence_parallel(16)
                    l1, g1 = value_and_grad(loss_fn, lp, b)
                g1 = local.full_params(g1, mod.specs(cfg), mesh, whole,
                                       mod.compute_segments(cfg, 2))
                res.append([sp, float(abs(l1 - l0) / l0), maxerr(g0, g1)])
            out[arch] = res
        emit(out)
    """, 2)
    for arch, res in got[0].items():
        # the transformer's stream goes sequence-parallel under the spec
        assert [r[0] for r in res] == [False, True]
        for _, loss_rel, grad in res:
            assert loss_rel < 1e-6 and grad < 1e-5, (arch, res)


_SAVE4 = """
    from repro_torch.distributed.sharding import P
    from repro_torch.ft import CheckpointManager
    mesh = make_host_mesh()
    assert mesh.size(0) == 4
    arr = local.distribute({"w": torch.arange(32.0).reshape(8, 4)},
                           {"w": P("data", None)}, mesh)
    assert arr["w"].to_local().shape == (2, 4)
    CheckpointManager(CKPT).save(1, arr)
    emit({"saved": True})
"""

_RESTORE2 = """
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed.sharding import P
    from repro_torch.ft import CheckpointManager
    mesh = make_host_mesh()
    got = CheckpointManager(CKPT).restore(
        1, like={"w": torch.zeros(8, 4)}, mesh=mesh,
        specs={"w": P("data", None)})
    w = got["w"]
    r = dist.get_rank()
    emit({"data": w.device_mesh.size(0),
          "placements": [isinstance(p, Shard) and p.dim == 0
                         for p in w.placements],
          "local": bool(torch.equal(w.to_local(),
                                    torch.arange(32.0).reshape(8, 4)
                                    [4 * r:4 * r + 4])),
          "whole": bool(torch.equal(local.full_tensor(w),
                                    torch.arange(32.0).reshape(8, 4)))})
"""


def test_elastic_restore_from_four_ranks_onto_two(tmp_path):
    ck = repr(str(tmp_path / "ck"))
    _run(tmp_path / "save", f"CKPT = {ck}\n" + textwrap.dedent(_SAVE4), 4)
    got = _run(tmp_path / "restore", f"CKPT = {ck}\n"
               + textwrap.dedent(_RESTORE2), 2)
    # (data, model): rows over 'data', replicated over 'model'
    assert got[0] == {"data": 2, "placements": [True, False],
                      "local": True, "whole": True}


def test_pipeline_four_stages_against_the_sequential_loop(tmp_path):
    got = _run(tmp_path, """
        from torch.distributed.device_mesh import DeviceMesh
        from repro_torch.distributed.pipeline import pipeline_apply
        from repro_torch.launch.mesh import init_distributed
        init_distributed("cpu")
        mesh = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("stage",))
        g = torch.Generator().manual_seed(0)
        S, B, D = 4, 8, 16
        ws = torch.randn(S, D, D, generator=g) * 0.3
        x = torch.randn(B, D, generator=g)

        def layer(w, h):
            return torch.tanh(h @ w)

        errs = []
        for m in (None, 8):
            got = pipeline_apply(layer, ws, x, mesh=mesh, axis="stage",
                                 n_microbatches=m)
            want = x
            for i in range(S):
                want = layer(ws[i], want)
            errs.append(float((got - want).abs().max()))
        print(json.dumps({"errs": errs}), flush=True)   # every stage
        finish()
    """, 4)
    for r in got:                 # replicated to every stage
        assert max(r["errs"]) < 1e-5, r
