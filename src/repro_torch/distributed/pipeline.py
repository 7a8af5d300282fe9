"""Pipeline parallelism over a 'stage' mesh axis (DESIGN.md §6).

Port of ``repro/distributed/pipeline.py``: a GPipe-style microbatched
pipeline.  Stage s holds its own layer slice, microbatches stream stage to
stage, and the bubble is the classic (S - 1) / (M + S - 1).  The reference
writes it as ``shard_map`` with a ``ppermute`` a tick; here each rank runs
its stage, and neighbours exchange activations with
``torch.distributed.batch_isend_irecv``.  The output is replicated to every
stage (a broadcast from the last).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.tree import tree_map

from .local import broadcast
from .sharding import axis_names


def pipeline_apply(layer_fn, params_stacked, x: torch.Tensor, *, mesh,
                   axis: str = "stage",
                   n_microbatches: int | None = None) -> torch.Tensor:
    """Run ``y = layer_fn(stage_params, x)`` through S pipeline stages.

    params_stacked: a tree with leading dim S (one slice a stage; every rank
    passes the whole stack and keeps its stage's slice); x: (B, ...) batch,
    the same on every rank, split into M microbatches (default S).  Returns
    the pipelined output on every rank."""
    names = axis_names(mesh)
    s = mesh.size(names.index(axis))
    stage = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    m = n_microbatches or s
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} does not split into {m} microbatches")
    xs = x.reshape(m, b // m, *x.shape[1:])
    params = tree_map(lambda p: p[stage], params_stacked)
    prev = dist.get_global_rank(group, stage - 1) if stage > 0 else None
    nxt = dist.get_global_rank(group, stage + 1) if stage < s - 1 else None

    outputs = torch.zeros_like(xs)
    inp = torch.zeros_like(xs[0])
    for t in range(m + s - 1):
        mb = t - stage                     # the microbatch at this stage
        y = None
        if 0 <= mb < m:
            y = layer_fn(params, xs[mb] if stage == 0 else inp)
            if stage == s - 1:
                outputs[mb] = y
        # stream s -> s + 1: what this stage made goes on, and the input
        # of the next tick comes in
        ops = []
        if nxt is not None and y is not None:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), nxt))
        if prev is not None and 0 <= mb + 1 < m:
            inp = torch.empty_like(xs[0])
            ops.append(dist.P2POp(dist.irecv, inp, prev))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    broadcast(outputs, dist.get_global_rank(group, s - 1), group=group)
    return outputs.reshape(b, *x.shape[1:])
