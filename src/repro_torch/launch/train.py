"""End-to-end training driver, in PyTorch.

Port of ``repro/launch/train.py``: real AdamW steps on the card (or, with
``--device cpu``, on the CPU), with

  * the deterministic data pipeline with background prefetch,
  * AdamW + clipping + cosine schedule, optional EF-int8 grad compression
    (applied to each step's grads; its residual is checkpointed beside the
    params and the optimizer state, so a resumed run carries it on),
  * atomic/async checkpointing with auto-resume,
  * the heartbeat watchdog with straggler accounting,
  * simulated failure injection (``--inject-failure-at``) to demonstrate
    the checkpoint/restart path.

Each step runs eagerly on the plain versions under autograd (the
reference's ``impl="xla"``; the kernels have no backward).

Launched as a process group (``torchrun``), it trains on
``make_host_mesh()`` in the reference trainer's layout, FSDP: params and
AdamW moments laid out by the family's specs (``mod.specs(cfg)``), so each
rank holds its shard over 'data' (and 'model') of every leaf; each layer's
weights are gathered over 'data' where the layer runs and their grads
reduce-scattered (``distributed.local.Fsdp``); each rank takes its rows of
the global batch.  ``--production-mesh`` trains on the 16 x 16 production
mesh and refuses any world but 256 ranks.  Checkpoints hold whole arrays
whatever the mesh, and restore onto the current one.  Rank 0 prints and
writes.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
      --smoke --device cpu --steps 30 --inject-failure-at 12
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch qwen3-8b --smoke --device cpu --steps 12
"""
from __future__ import annotations

import argparse
import os
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.distributed import context, local
from repro_torch.distributed.context import DEFAULT_TRAIN_SPEC
from repro_torch.distributed.sharding import tp_size
from repro_torch.ft import CheckpointManager, Watchdog
from repro_torch.launch.steps import make_train_step
from repro_torch.models import family_module, reduced
from repro_torch.models.tree import tree_map
from repro_torch.optim import AdamW, cosine_schedule, ef_init


def _mesh(args, device):
    """The production mesh with ``--production-mesh``; the host mesh when
    launched as a process group of more than one rank; else None."""
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    if args.production_mesh:
        try:
            return make_production_mesh(device=device)
        except ValueError as e:
            raise SystemExit(f"--production-mesh: {e}")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return make_host_mesh(device=device)
    return None


class _Sharded:
    """The trainer's state on a mesh, FSDP: the params', the moments' and
    the residual's shards on this rank by the family's specs, and their
    whole form for checkpoints."""

    def __init__(self, cfg, mod, opt: AdamW, mesh):
        self.mesh = mesh
        self.specs = mod.specs(cfg)
        self.segments = mod.compute_segments(cfg, tp_size(mesh))
        opt.shard(mesh, self.specs, self.segments, fsdp=True)

    def layout_specs(self, with_ef: bool):
        """Checkpoint specs: every leaf by the family's specs."""
        specs = (self.specs, AdamW.init_specs(self.specs))
        return specs + (self.specs,) if with_ef else specs

    def local(self, tree):
        return local.local_params(tree, self.specs, self.mesh,
                                  self.segments, fsdp=True)

    def local_state(self, state):
        m, v = (self.local(t) for t in (state.m, state.v))
        return type(state)(local.full_tensor(state.step).clone(), m, v)

    def whole(self, tree, shapes):
        return local.full_params(tree, self.specs, self.mesh, shapes,
                                 self.segments, fsdp=True)

    def whole_state(self, state, shapes):
        m, v = (self.whole(t, shapes) for t in (state.m, state.v))
        return type(state)(state.step, m, v)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default the card)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--checkpoint-dir", default="artifacts/ckpt")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--production-mesh", action="store_true",
                    help="use the 16x16 mesh (requires 256 ranks)")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--inject-failure-at", type=int, default=-1,
                    help="simulate a crash at this step (tests restart)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tuning-db", default=None,
                    help="tuning database (tuner/db.py); defaults to "
                         "artifacts/torch_tuning_db.json")
    ap.add_argument("--tuned-app", default=None,
                    help="co-design app whose tuned kernel blocks to "
                         "install (default: the arch name)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: train on the card, or pass "
                         "--device cpu")
    mesh = _mesh(args, device)
    rank0 = mesh is None or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    # measured-autotuning pickup (DESIGN.md §8.4): install the app's tuned
    # block shapes as dispatch defaults; shape-exact DB records still win
    from repro_torch.kernels import ops
    tuned = ops.configure(app=args.tuned_app or args.arch,
                          db_path=args.tuning_db)
    if tuned:
        say(f"tuned kernel blocks installed: gemm={tuned['gemm']}")
    mod = family_module(cfg)
    tp = 1 if mesh is None else tp_size(mesh)

    opt = AdamW(lr=cosine_schedule(args.lr, warmup=5, total=args.steps))
    whole = mod.init(cfg, seed=args.seed, tp=tp, device=device)
    sharded = None if mesh is None else _Sharded(cfg, mod, opt, mesh)
    comp = args.grad_compression

    ckpt = CheckpointManager(Path(args.checkpoint_dir) / cfg.name)
    start = 0
    latest = ckpt.latest_step()
    state = None
    if latest is not None:
        # a checkpoint written without the residual restores; the residual
        # then starts at zero
        saved_ef = ckpt.arity(latest) == 3
        if comp and not saved_ef:
            warnings.warn(f"checkpoint step {latest} holds no "
                          f"--grad-compression residual; it restarts at "
                          f"zero", stacklevel=1)
        like = (whole, AdamW().init(whole))
        if saved_ef:
            like = like + (ef_init(whole),)
        specs = None if mesh is None else sharded.layout_specs(saved_ef)
        state = ckpt.restore(latest, like=like, mesh=mesh, specs=specs)
    ef_state = None
    if state is not None:
        params, opt_state = state[0], state[1]
        if comp:
            ef_state = state[2] if len(state) == 3 else ef_init(params)
        start = latest + 1
        say(f"resumed from checkpoint step {latest}")
    else:
        params, opt_state = whole, None
        if comp:
            ef_state = ef_init(whole)
    shapes = tree_map(lambda t: t.to("meta"), whole)
    if mesh is not None:
        params = sharded.local(params)
        opt_state = (opt.init(params) if opt_state is None
                     else sharded.local_state(opt_state))
        if ef_state is not None:
            ef_state = sharded.local(ef_state)
        del whole
    elif opt_state is None:
        opt_state = opt.init(params)

    data = SyntheticLM(cfg.vocab, args.seq_len, args.global_batch, args.seed)
    step_fn = make_train_step(cfg, opt, ef_state=ef_state, mesh=mesh)
    watchdog = Watchdog(n_workers=1 if mesh is None
                        else dist.get_world_size())

    def checkpoint(step: int, blocking: bool):
        tree = (params, opt_state) + ((ef_state,) if comp else ())
        if mesh is not None:
            tree = (sharded.whole(params, shapes),
                    sharded.whole_state(opt_state, shapes)) + (
                (sharded.whole(ef_state, shapes),) if comp else ())
        ckpt.save(step, tree, blocking=blocking)

    batch_of = (data.batch if mesh is None
                else lambda s: data.global_arrays(s, mesh))
    fetch = Prefetcher(batch_of, start_step=start)
    with context.activation_spec(DEFAULT_TRAIN_SPEC if tp > 1 else None,
                                 mesh):
        for step in range(start, args.steps):
            got_step, host_batch = fetch.get()
            if got_step != step:
                raise RuntimeError(f"prefetcher gave step {got_step}, "
                                   f"expected {step}")
            if cfg.vis_tokens or cfg.embed_inputs:
                host_batch = _adapt_batch(cfg, host_batch)
            batch = to_device(host_batch, device, getattr(torch, cfg.dtype))
            t0 = time.time()
            if step == args.inject_failure_at:
                # drain the async writer first: the injection simulates a
                # crash *after* the last checkpoint landed, so the rerun
                # demonstrably resumes from it (a writer killed mid-write is
                # already safe: it only ever loses the in-flight step)
                ckpt.wait()
                raise SystemExit(
                    f"[injected failure at step {step}] — rerun the same "
                    f"command; training auto-resumes from the last "
                    f"checkpoint")
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if device.type == "cuda":
                torch.cuda.synchronize()
            dt = time.time() - t0
            if mesh is None:
                watchdog.beat(0, step, step_time_s=dt)
            else:       # every rank's step time, so each sees stragglers
                dts = local.all_gather(torch.tensor([dt], device=device),
                                       dist.group.WORLD, 0)
                for r, d in enumerate(dts.tolist()):
                    watchdog.beat(r, step, step_time_s=d)
            if step % 5 == 0 or step == args.steps - 1:
                say(f"step {step:4d}  loss {float(metrics['loss']):.4f}  "
                    f"gnorm {float(metrics['grad_norm']):.3f}  "
                    f"{dt*1e3:.0f}ms  health {watchdog.check()}", flush=True)
            if step and step % args.checkpoint_every == 0:
                checkpoint(step, blocking=False)
    ckpt.wait()
    checkpoint(args.steps - 1, blocking=True)
    say(f"done; checkpoints in {ckpt.dir}")
    if mesh is not None:
        dist.destroy_process_group()


def to_device(host_batch: dict, device, dtype) -> dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``: token ids as int64, float
    inputs (hubert's frames, internvl2's patches) in the model's ``dtype``
    (jnp promotes a bfloat16 model to float32 on float32 frames; a torch
    matmul refuses mixed dtypes)."""
    return {k: (torch.from_numpy(v.astype(np.int64)).to(device)
                if v.dtype.kind in "iu"
                else torch.from_numpy(v).to(device=device, dtype=dtype))
            for k, v in host_batch.items()}


def _adapt_batch(cfg, batch):
    toks, labels = batch["tokens"], batch["labels"]
    if cfg.embed_inputs:   # hubert: frames stand in for the CNN frontend
        rng = np.random.default_rng(int(toks[0, 0]) + 1)
        frames = rng.standard_normal(
            (toks.shape[0], toks.shape[1], cfg.d_model)).astype("float32")
        return {"frames": frames, "labels": labels % cfg.vocab}
    if cfg.vis_tokens:     # internvl2: patch prefix
        rng = np.random.default_rng(int(toks[0, 0]) + 1)
        patches = rng.standard_normal(
            (toks.shape[0], cfg.vis_tokens, cfg.d_model)).astype("float32")
        return {"tokens": toks, "patches": patches, "labels": labels}
    return batch


if __name__ == "__main__":
    main()
