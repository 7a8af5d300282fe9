"""Kernel microbenchmarks: the reference's four rows (``gemm``,
``flash_attention``, ``rwkv6``, ``mamba2``) at its shapes, through
``kernels.ops`` on the port's device.  Port of
``benchmarks/kernel_micro.py``.

On the card each row runs the hand-written kernel, checked first against
its plain PyTorch version on the same inputs (``max_abs_err``), then timed
twice: by CUDA events around ``iters`` back-to-back calls after a warm-up
(``us_per_call``: at these shapes mostly the wrapper's host time), and by
replaying ``iters`` calls captured in one CUDA graph
(``us_per_call_graph``: the device's own time).  Beside them: the plain
version's time by events, the GFLOP/s the kernel reached in the replayed
time, and its bound, the larger of its bytes (each input read once, each
output written once) over the HBM rate and its operations over the peak
rate for its type, from ``launch.roofline.CARDS``.  On the CPU (``--device
cpu``) each row runs the plain version, timed by the host clock, with no
bound.  No TPU figure is printed: the reference's modeled TPU latency has
no counterpart here.

Operation counts: gemm 2 M N K; attention 4 H D per (query, key) pair
under the causal mask (the reference counts the full square); rwkv6 4 Dk Dv
+ 3 L Dk + L Dv per token and head (chunks of L = 16); mamba2 4 N P + L N +
L P per token and head (chunks of L = 64).

    PYTHONPATH=src python -m repro_torch.bench.kernel_micro [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np
import torch

ITERS = 20

LAST_METRICS: dict = {}


def _inputs(device):
    """The reference's inputs, drawn in its order from one generator."""
    rng = np.random.default_rng(0)
    t = lambda a, dt=torch.float32: torch.from_numpy(  # noqa: E731
        np.asarray(a, np.float32)).to(device=device, dtype=dt)
    m = n = k = 512
    a = t(rng.standard_normal((m, k)))
    b = t(rng.standard_normal((k, n)))
    q = t(rng.standard_normal((1, 1024, 8, 64)), torch.bfloat16)
    kk = t(rng.standard_normal((1, 1024, 2, 64)), torch.bfloat16)
    r = t(rng.standard_normal((1, 512, 8, 64)))
    w = t(-np.exp(rng.standard_normal((1, 512, 8, 64)) * .3))
    u = t(rng.standard_normal((8, 64)))
    x = t(rng.standard_normal((1, 512, 8, 64)))
    av = t(-np.abs(rng.standard_normal((1, 512, 8)) * .3))
    bc = t(rng.standard_normal((1, 512, 8, 32)))
    return dict(a=a, b=b, q=q, kk=kk, r=r, w=w, u=u, x=x, av=av, bc=bc)


def cases(device) -> list[dict]:
    """One dict a row: the kernel's call, its plain version's call on the
    same inputs, its shape tag, operations, bytes and dtype."""
    from repro_torch.bench._results import impl_for
    from repro_torch.kernels import ops, plain, ref

    impl = impl_for(torch.device(device).type)
    z = _inputs(device)
    a, b, q, kk = z["a"], z["b"], z["q"], z["kk"]
    r, w, u, x, av, bc = z["r"], z["w"], z["u"], z["x"], z["av"], z["bc"]
    nb = lambda *ts: sum(t_.numel() * t_.element_size() for t_ in ts)  # noqa
    s, h, d = 1024, 8, 64
    t_, hr, dk = 512, 8, 64
    return [
        dict(kernel="gemm", shape="512x512x512", dtype="float32",
             call=lambda: ops.matmul(a, b, implementation=impl),
             plain=lambda: ref.gemm_ref(a, b),
             flops=2 * 512 ** 3, bytes=nb(a, b) * 3 // 2),
        dict(kernel="flash_attention", shape="b1s1024h8d64", dtype="bfloat16",
             call=lambda: ops.attention(q, kk, kk, implementation=impl),
             plain=lambda: plain.attention(q, kk, kk),
             flops=4 * h * d * s * (s + 1) // 2, bytes=nb(q, kk, kk, q)),
        dict(kernel="rwkv6", shape="b1s512h8", dtype="float32",
             call=lambda: ops.rwkv6(r, r, r, w, u, implementation=impl)[0],
             plain=lambda: plain.rwkv6(r, r, r, w, u)[0],
             flops=t_ * hr * (4 * dk * dk + 3 * 16 * dk + 16 * dk),
             bytes=nb(r, r, r, w, u, r) + hr * dk * dk * 4),
        dict(kernel="mamba2_ssd", shape="b1s512h8n32", dtype="float32",
             call=lambda: ops.mamba2(x, av, bc, bc, implementation=impl)[0],
             plain=lambda: plain.mamba2(x, av, bc, bc)[0],
             flops=t_ * hr * (4 * 32 * 64 + 64 * 32 + 64 * 64),
             bytes=nb(x, av, bc, bc, x) + hr * 32 * 64 * 4),
    ]


def time_events_us(fn, iters: int = ITERS) -> float:
    """Mean µs a call of ``iters`` back-to-back calls between two CUDA
    events, after a warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def time_graph_us(fn, iters: int = ITERS) -> float:
    """Mean µs a call of ``iters`` calls captured in one CUDA graph and
    replayed: the device's time without the host's cost of each launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                        # warm-up on a side stream before capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return time_events_us(graph.replay, 3) / iters


def time_host_us(fn, iters: int = ITERS) -> float:
    """Mean µs a call of a CPU function by the host clock, after a warm-up
    call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6


def run(device="cuda", iters: int = ITERS) -> list[dict]:
    """Each row: the kernel's error against its plain version, its times
    (events and graph replay on the card, the host clock on the CPU), the
    plain version's, GFLOP/s and the bound."""
    from repro_torch.launch.roofline import card_rates

    on_card = torch.device(device).type == "cuda"
    rates = card_rates(torch.cuda.get_device_name(device)) if on_card \
        else None
    rows = []
    for c in cases(device):
        got, want = c["call"](), c["plain"]()
        err = float((got.float() - want.float()).abs().max())
        row = {"kernel": c["kernel"], "shape": c["shape"],
               "dtype": c["dtype"], "max_abs_err": err,
               "finite": bool(torch.isfinite(got).all())}
        if on_card:
            us = time_events_us(c["call"], iters)
            row.update(
                us_per_call=us,
                us_per_call_graph=time_graph_us(c["call"], iters),
                plain_us_per_call=time_events_us(c["plain"], iters))
            peak = rates["bf16" if c["dtype"] == "bfloat16" else "f32"]
            t_bytes, t_ops = c["bytes"] / rates["hbm"], c["flops"] / peak
            row.update(bound_us=max(t_bytes, t_ops) * 1e6,
                       bound_by="bytes" if t_bytes >= t_ops
                       else "operations")
        else:
            us = time_host_us(c["call"], iters)
            row.update(us_per_call=us, us_per_call_graph=None,
                       plain_us_per_call=us, bound_us=None, bound_by=None)
        t_dev = row["us_per_call_graph"] or row["us_per_call"]
        row["gflops"] = c["flops"] / t_dev / 1e3
        rows.append(row)
    return rows


def _f(v, fmt: str) -> str:
    return "" if v is None else format(v, fmt)


def main(argv=None) -> None:
    from repro_torch.bench._results import parse_device

    args = parse_device(argv, description=__doc__.splitlines()[0])
    rows = run(args.device, ITERS)
    print("benchmark,kernel,shape,us_per_call,derived_gflops,"
          "us_per_call_graph,plain_us_per_call,bound_us,bound_by,"
          "max_abs_err")
    for r in rows:
        print(f"micro,{r['kernel']},{r['shape']},{r['us_per_call']:.1f},"
              f"{r['gflops']:.2f},{_f(r['us_per_call_graph'], '.2f')},"
              f"{r['plain_us_per_call']:.1f},{_f(r['bound_us'], '.2f')},"
              f"{r['bound_by'] or ''},{r['max_abs_err']:.3g}")
    global LAST_METRICS
    LAST_METRICS = {"device": args.device,
                    "rows": {r["kernel"]: {k: v for k, v in r.items()
                                           if k != "kernel"} for r in rows}}


if __name__ == "__main__":
    main()
