"""End-to-end training driver, in PyTorch.

Port of ``repro/launch/train.py``: real AdamW steps on the card (or, with
``--device cpu``, on the CPU), with

  * the deterministic data pipeline with background prefetch,
  * AdamW + clipping + cosine schedule, optional EF-int8 grad compression
    (applied to each step's grads; its residual restarts at zero on
    resume),
  * atomic/async checkpointing with auto-resume,
  * the heartbeat watchdog with straggler accounting,
  * simulated failure injection (``--inject-failure-at``) to demonstrate
    the checkpoint/restart path.

Each step runs eagerly on the plain versions under autograd (the
reference's ``impl="xla"``; the kernels have no backward).  Not ported yet
(ROADMAP A.8): ``--production-mesh``; it raises rather than being ignored.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
      --smoke --device cpu --steps 30 --inject-failure-at 12
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.ft import CheckpointManager, Watchdog
from repro_torch.launch.steps import make_train_step
from repro_torch.models import family_module, reduced
from repro_torch.optim import AdamW, cosine_schedule, ef_init


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
                    help="not ported yet (ROADMAP A.8): raises")
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

    if args.production_mesh:
        raise SystemExit("--production-mesh: training on a device mesh is "
                         "not ported yet (ROADMAP A.8)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: train on the card, or pass "
                         "--device cpu")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    # measured-autotuning pickup (DESIGN.md §8.4): install the app's tuned
    # block shapes as dispatch defaults; shape-exact DB records still win
    from repro_torch.kernels import ops
    tuned = ops.configure(app=args.tuned_app or args.arch,
                          db_path=args.tuning_db)
    if tuned:
        print(f"tuned kernel blocks installed: gemm={tuned['gemm']}")
    mod = family_module(cfg)

    opt = AdamW(lr=cosine_schedule(args.lr, warmup=5, total=args.steps))
    params = mod.init(cfg, seed=args.seed, device=device)
    opt_state = opt.init(params)

    ckpt = CheckpointManager(Path(args.checkpoint_dir) / cfg.name)
    start = 0
    latest = ckpt.latest_step()
    state = None
    if latest is not None:
        state = ckpt.restore(latest, like=(params, opt_state))
    if state is not None:
        params, opt_state = state
        start = latest + 1
        print(f"resumed from checkpoint step {latest}")

    data = SyntheticLM(cfg.vocab, args.seq_len, args.global_batch, args.seed)
    ef_state = ef_init(params) if args.grad_compression else None
    step_fn = make_train_step(cfg, opt, ef_state=ef_state)
    watchdog = Watchdog(n_workers=1)

    fetch = Prefetcher(lambda s: data.batch(s), start_step=start)
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
            # drain the async writer first: the injection simulates a crash
            # *after* the last checkpoint landed, so the rerun demonstrably
            # resumes from it (a writer killed mid-write is already safe:
            # it only ever loses the in-flight step, never corrupts)
            ckpt.wait()
            raise SystemExit(
                f"[injected failure at step {step}] — rerun the same "
                f"command; training auto-resumes from the last checkpoint")
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.time() - t0
        watchdog.beat(0, step, step_time_s=dt)
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  {dt*1e3:.0f}ms  "
                  f"health {watchdog.check()}", flush=True)
        if step and step % args.checkpoint_every == 0:
            ckpt.save(step, (params, opt_state), blocking=False)
    ckpt.wait()
    ckpt.save(args.steps - 1, (params, opt_state))
    print(f"done; checkpoints in {ckpt.dir}")


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
