"""Tensor-parallel serving gate (DESIGN.md §15).  Port of
``benchmarks/bench_serve_tp.py``.

Three scenarios, all gated (exit 1 on miss):

  * ``model=1``: the paged engine hosted on a (data=1, model=1) mesh must
    produce BIT-IDENTICAL per-request outputs to the plain
    ``PagedServeEngine`` — a trivial mesh adds sharding machinery but no
    collectives, so any drift is a bug in the mesh plumbing, not numerics.
    It runs on ``--device``: on the card a one-rank NCCL group, on the CPU
    a one-rank gloo group, either started in this process.
  * ``8-way``: 8 gloo ranks on the CPU (the card hidden; a ``FileStore``
    rendezvous, ``launch.mesh.run_ranks``) decode the same traffic on a
    (data=1, model=8) mesh, and each rank on its own with the SAME tp=8
    padded params; greedy tokens must match token-for-token (sharded
    reductions may reassociate ulps; argmax token identity is the
    contract).  The reference widens XLA to 8 host devices in a subprocess
    for this; the port's ranks are processes.
  * ``codesign``: with the interconnect term in the cost model, a seeded
    codesign run over (chip config × TP degree) must commit a *different*,
    TP-aware solution (hw.tp > 1, lower modeled latency) than the TP-blind
    run on the same workloads (the DQNs on ``--device``).

Tokens/s for every serving run is published into
``artifacts/torch_bench_results.json``.  ``--full-width`` serves the
published qwen3-8b config in float32 in the ``model=1`` scenario (the card
only); the 8-way scenario stays at the reduced config on the CPU.

    PYTHONPATH=src python -m repro_torch.bench.bench_serve_tp [--device cpu]
"""
from __future__ import annotations

import json
import tempfile
import textwrap
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[2]

SLOTS = 4
MAX_SEQ = 48
N_REQUESTS = 8
MAX_NEW = 8
PAGE_SIZE = 8
PREFILL_CHUNK = 16
TP8_TIMEOUT_S = 600

LAST_METRICS: dict = {}


def _serve(cfg, params, *, tp=1, mesh=None):
    from repro_torch.bench.bench_serve import _impl
    from repro_torch.launch.serve import make_requests, serve_requests

    reqs = make_requests(cfg, N_REQUESTS, MAX_NEW, seed=0)
    t0 = time.perf_counter()
    done, stats = serve_requests(
        cfg, params, reqs, slots=SLOTS, max_seq=MAX_SEQ, tp=tp, mesh=mesh,
        impl=_impl(params), paged=True, page_size=PAGE_SIZE,
        prefill_chunk=PREFILL_CHUNK)
    dt = time.perf_counter() - t0
    done = sorted(done, key=lambda r: r.rid)
    return [r.out for r in done], stats["generated"] / dt


def run_model1(cfg=None, params=None, device="cuda") -> dict:
    """Trivial mesh vs no mesh: bit-identical outputs on one device."""
    from repro_torch.bench.bench_serve import model
    from repro_torch.launch.mesh import make_host_mesh

    if cfg is None:
        cfg, params = model(device)
    mesh = make_host_mesh(tp=1, device=params["embed"]["table"].device)
    for _ in range(2):                       # second run is the warm timing
        outs_plain, tok_s_plain = _serve(cfg, params)
        outs_mesh, tok_s_mesh = _serve(cfg, params, mesh=mesh)
    return {
        "tok_s_plain": round(tok_s_plain, 1),
        "tok_s_mesh": round(tok_s_mesh, 1),
        "outputs_identical": outs_plain == outs_mesh,
    }


_TP8 = textwrap.dedent("""
    import dataclasses, json, os, time
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import make_requests, serve_requests
    from repro_torch.models import family_module, reduced

    # f32 so token identity is a meaningful gate: sharded partial sums
    # round at shard boundaries, and bf16's 2^-8 steps are the same order
    # as this random-init model's top-2 logit gaps
    cfg = dataclasses.replace(reduced(get_config("qwen3-8b")),
                              dtype="float32")
    params = family_module(cfg).init(cfg, seed=0, tp=8, device="cpu")
    mesh = make_host_mesh(tp=8)
    assert mesh.mesh.shape == (1, 8), mesh

    def serve(mesh_arg):
        reqs = make_requests(cfg, __N__, __MAX_NEW__, seed=0)
        t0 = time.perf_counter()
        done, stats = serve_requests(
            cfg, params, reqs, slots=__SLOTS__, max_seq=__MAX_SEQ__,
            tp=8, mesh=mesh_arg, impl="torch", paged=True,
            page_size=__PAGE_SIZE__, prefill_chunk=__CHUNK__)
        dt = time.perf_counter() - t0
        done = sorted(done, key=lambda r: r.rid)
        return [r.out for r in done], stats["generated"] / dt

    for _ in range(2):                      # second run is the warm timing
        outs_ref, tok_s_ref = serve(None)   # one rank alone, same params
        outs_tp, tok_s_tp = serve(mesh)
    print(json.dumps({"rank": dist.get_rank(),
                      "outputs_identical": outs_ref == outs_tp,
                      "outs": outs_tp,
                      "tok_s_single": round(tok_s_ref, 1),
                      "tok_s_tp8": round(tok_s_tp, 1)}), flush=True)
    dist.destroy_process_group()
    os._exit(0)     # no interpreter teardown racing gloo's threads
""")


def run_tp8(store_dir=None, timeout: float = TP8_TIMEOUT_S) -> dict:
    """8-way mesh decode vs one rank alone, same tp=8 params, on 8 gloo
    ranks on the CPU with the card hidden.  Every rank must match its own
    single-device tokens, and all ranks must agree."""
    from repro_torch.launch.mesh import rank_json, run_ranks

    script = (_TP8.replace("__N__", str(N_REQUESTS))
              .replace("__MAX_NEW__", str(MAX_NEW))
              .replace("__SLOTS__", str(SLOTS))
              .replace("__MAX_SEQ__", str(MAX_SEQ))
              .replace("__PAGE_SIZE__", str(PAGE_SIZE))
              .replace("__CHUNK__", str(PREFILL_CHUNK)))
    env = {"PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1",
           "CUDA_VISIBLE_DEVICES": ""}
    with tempfile.TemporaryDirectory() as tmp:
        procs = run_ranks(["-c", script], 8, store_dir or tmp,
                          timeout=timeout, env=env)
    bad = [p for p in procs if p.returncode != 0]
    if bad:
        raise SystemExit(f"tp8 rank failed (rc {bad[0].returncode}):\n"
                         f"{bad[0].stdout[-2000:]}\n{bad[0].stderr[-4000:]}")
    ranks = [rank_json(p) for p in procs]
    return {"outputs_identical": all(r["outputs_identical"] for r in ranks)
            and all(r["outs"] == ranks[0]["outs"] for r in ranks),
            "tok_s_single": ranks[0]["tok_s_single"],
            "tok_s_tp8": ranks[0]["tok_s_tp8"],
            "outs": ranks[0]["outs"]}


def run_codesign(device="cuda") -> dict:
    """Seeded (chip × TP) search vs the TP-blind search: the interconnect
    term must change the committed solution."""
    from repro_torch.core import workloads as W
    from repro_torch.core.codesign import codesign
    from repro_torch.core.hw_space import PARALLELISM_AXES

    wl = W.table1_gemm()[:2]
    kw = dict(intrinsics=["GEMM"], n_trials=8, n_init=4, seed=0, q=2,
              device=device)
    blind = codesign(wl, **kw).solution
    aware = codesign(wl, space_axes=PARALLELISM_AXES, **kw).solution
    return {
        "hw_blind": list(blind.hw.encode()),
        "hw_aware": list(aware.hw.encode()),
        "tp_blind": blind.hw.tp,
        "tp_aware": aware.hw.tp,
        "latency_blind_s": blind.latency_s,
        "latency_aware_s": aware.latency_s,
        "solutions_differ": blind.hw.encode() != aware.hw.encode(),
    }


def gate(m1: dict, m8: dict, mc: dict) -> bool:
    return bool(m1["outputs_identical"] and m8["outputs_identical"]
                and mc["solutions_differ"] and mc["tp_aware"] > 1
                and mc["latency_aware_s"] < mc["latency_blind_s"])


def main(argv=None) -> None:
    global LAST_METRICS
    from repro_torch.bench._results import publish
    from repro_torch.bench.bench_serve import model, parse_args

    args = parse_args(argv, __doc__.splitlines()[0])
    cfg, params = model(args.device, args.full_width)
    m1 = run_model1(cfg, params)
    del params
    m8 = run_tp8()
    m8.pop("outs")
    mc = run_codesign(args.device)
    ok = gate(m1, m8, mc)
    m = {"model1": m1, "tp8": m8, "codesign": mc, "pass": ok,
         "model": cfg.name, "dtype": cfg.dtype, "device": args.device}
    LAST_METRICS = m

    print("bench,case,detail")
    print(f"bench_serve_tp,model1_bit_exact,"
          f"identical={m1['outputs_identical']},"
          f"tok_s={m1['tok_s_mesh']}_vs_{m1['tok_s_plain']}")
    print(f"bench_serve_tp,tp8_token_exact,"
          f"identical={m8['outputs_identical']},"
          f"tok_s={m8['tok_s_tp8']}_vs_{m8['tok_s_single']}")
    print(f"bench_serve_tp,codesign_tp_aware,"
          f"tp={mc['tp_aware']}_vs_{mc['tp_blind']},"
          f"latency={mc['latency_aware_s']:.3g}_vs_"
          f"{mc['latency_blind_s']:.3g}")
    publish("bench_serve_tp", m, failed=not ok)
    if not ok:
        raise SystemExit(
            f"bench_serve_tp gate missed: model1_identical="
            f"{m1['outputs_identical']} tp8_identical="
            f"{m8['outputs_identical']} codesign_differ="
            f"{mc['solutions_differ']} tp_aware={mc['tp_aware']}")


if __name__ == "__main__":
    main()
