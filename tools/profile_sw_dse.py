"""Where ``bench_sw_dse``'s round loop spends its time, engine by engine:
the host profile (cProfile), the device side (``torch.profiler``), the
per-round spans and the garbage collector's pauses.

At bench_sw_dse's sizes (16 searches, pool 12, 16 rounds, k 6) and after
its warm-up (one run of each engine):

  times  — five timed runs of each engine, in turn, each with the
           collector's pauses inside it (``gc.callbacks``);
  spans  — one batched run with ``repro_torch.obs`` on: every round's
           ``sw_dse.round`` and ``sw_dse.train_round`` span;
  host   — one run of each engine under cProfile: every function of the
           ``repro_torch`` package by calls, own and cumulative seconds;
  device — on the card, one batched run under ``torch.profiler``: the
           device time by kernel and the share of the run's wall clock the
           card was busy;
  replay — on the card, a round's train steps (16 slots x 6 steps, the
           batched engine's) and one step (1 x 1, the per-search engine's)
           as ``_State.train`` runs them, and the 16 x 6 forward: the host
           time until the call returns with the card idle before it, and
           the device time between events.

Prints a summary (the host profile's first 25 functions by own time) and,
as its last line, one JSON object; ``--out PATH`` also writes that object
to PATH.  Gates nothing.

    PYTHONPATH=src python tools/profile_sw_dse.py [--device cpu] [--out PATH]
"""
from __future__ import annotations

import argparse
import cProfile
import gc
import json
import pstats
import time
from pathlib import Path

REPEATS = 5
TOP = 25


class _GCPauses:
    """The collector's pauses while installed: (generation, seconds)."""

    def __init__(self):
        self.pauses: list[tuple[int, float]] = []
        self._t0 = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.pauses.append((info["generation"],
                                time.perf_counter() - self._t0))

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)
        return False


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def _timed(run, device: str) -> dict:
    _sync(device)
    with _GCPauses() as g:
        t0 = time.perf_counter()
        run()
        _sync(device)
        sec = time.perf_counter() - t0
    return {"s": sec, "gc_s": sum(p for _, p in g.pauses),
            "gc": [sum(1 for gen, _ in g.pauses if gen == i)
                   for i in range(3)]}


def _host(run) -> dict:
    """cProfile of one run: every function of the ``repro_torch`` package,
    keyed ``module.function`` (one key for a name defined twice in a
    module), by own time."""
    prof = cProfile.Profile()
    prof.enable()
    run()
    prof.disable()
    stats = pstats.Stats(prof).stats
    items: dict[str, tuple] = {}
    for (fname, _line, func), (_cc, nc, tt, ct, _callers) in stats.items():
        path = Path(fname)
        if "repro_torch" not in path.parts:
            continue
        key = f"{path.stem}.{func}"
        c, t, cum = items.get(key, (0, 0.0, 0.0))
        items[key] = (c + nc, t + tt, cum + ct)
    return {"total_s": sum(v[2] for v in stats.values()),
            "items": {k: {"calls": c, "own_s": t, "cum_s": cum}
                      for k, (c, t, cum) in sorted(
                          items.items(), key=lambda kv: -kv[1][1])}}


def _spans(run) -> dict:
    from repro_torch import obs
    from repro_torch.obs.trace import DUR, NAME, PH

    st = obs.enable()
    try:
        run()
        evs = st.tracer.events()
    finally:
        obs.disable()
    out = {}
    for name in ("sw_dse.round", "sw_dse.train_round"):
        out[name] = [e[DUR] / 1e3 for e in evs
                     if e[PH] == "X" and e[NAME] == name]
    return out


def _device(run) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    busy = 0.0
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        if dev > 0:
            rows.append({"name": e.key[:60], "count": e.count,
                         "device_ms": dev})
            busy += dev
        elif e.key in ("cudaGraphLaunch", "cudaMemcpyAsync",
                       "cudaLaunchKernel", "cudaStreamSynchronize"):
            rows.append({"name": e.key, "count": e.count,
                         "host_ms": e.self_cpu_time_total / 1e3})
    rows.sort(key=lambda r: -r.get("device_ms", 0.0))
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "busy_share": busy / (wall * 1e3), "rows": rows[:25]}


def _replay(device: str, n_feat: int, n_moves: int, reps: int = 20) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.qlearning import DQNBank

    out = {}
    for n, m in ((16, 6), (1, 1)):
        bank = DQNBank(n_feat, n_moves, list(range(n)), device=device)
        # do_train all false: every kernel runs, no leaf moves
        packed = np.zeros((n, m, bank.batch, 2 * n_feat + 4), np.float32)
        feats = np.zeros((n, m, n_feat), np.float32)
        calls = {"train": lambda: bank.state.train(packed)}
        if m > 1:
            calls["forward"] = lambda: bank.state.forward(feats)
        for name, call in calls.items():
            call()                            # captures where it must
            host, dev = [], []
            for _ in range(reps):
                torch.cuda.synchronize()
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                t0 = time.perf_counter()
                e0.record()
                call()
                e1.record()
                host.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                dev.append(e0.elapsed_time(e1))
            out[f"{name} {n}x{m}"] = {"host_ms": sorted(host),
                                      "device_ms": sorted(dev)}
    return out


def main(argv=None) -> dict:
    from repro_torch.bench import bench_sw_dse as B
    from repro_torch.bench._results import parse_device
    from repro_torch.core.sw_dse import run_searches

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = parse_device(argv, parser=ap)
    device = args.device
    cfg = dict(pool_size=B.POOL, rounds=B.ROUNDS, k=B.K, device=device)
    specs = B._specs()
    runs = {e: (lambda e=e: run_searches(specs, engine=e, **cfg))
            for e in ("batched", "reference")}
    for run in runs.values():                 # bench_sw_dse's warm-up
        run()
    res = {"device": device, "sizes": [B.N_SEARCHES, B.POOL, B.ROUNDS, B.K],
           "times": {e: [] for e in runs}}
    for _ in range(REPEATS):
        for e, run in runs.items():
            res["times"][e].append(_timed(run, device))
    res["spans"] = _spans(runs["batched"])
    res["host"] = {e: _host(run) for e, run in runs.items()}
    if device.startswith("cuda"):
        res["device_side"] = _device(runs["batched"])
        space = specs[0]
        from repro_torch.core.sw_space import SoftwareSpace
        sp = SoftwareSpace(space.workload, space.choices, space.hw)
        res["replay"] = _replay(device, sp.n_features, len(sp.moves))

    for e, ts in res["times"].items():
        print(f"{e}: " + ", ".join(f"{t['s']:.4f} s (gc {t['gc_s']:.4f} s, "
                                   f"{t['gc']})" for t in ts))
    for name, ms in res["spans"].items():
        print(f"{name}: {len(ms)} spans, ms " +
              " ".join(f"{x:.2f}" for x in ms))
    for e, h in res["host"].items():
        print(f"cProfile {e}: {h['total_s']:.3f} s own in all")
        for k, v in list(h["items"].items())[:TOP]:
            print(f"  {k}: {v['calls']} calls, own {v['own_s']:.4f} s, "
                  f"cum {v['cum_s']:.4f} s")
    if "device_side" in res:
        d = res["device_side"]
        print(f"device: busy {d['device_busy_ms']:.2f} of {d['wall_ms']:.2f} "
              f"ms ({d['busy_share']:.3f})")
    for name, r in res.get("replay", {}).items():
        print(f"{name}: host ms {r['host_ms'][0]:.4f}-{r['host_ms'][-1]:.4f} "
              f"(median {r['host_ms'][len(r['host_ms']) // 2]:.4f}), device "
              f"ms {r['device_ms'][0]:.4f}-{r['device_ms'][-1]:.4f}")
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return res


if __name__ == "__main__":
    main()
