"""Step functions: the train step, the prefill step (both forms) and the
decode (serve) step, shared by the trainer, the server and
``chip_smoke.py``.

Port of ``repro/launch/steps.py``.  The train step runs eagerly (the
reference jits it and donates its buffers; here the optimizer updates the
params in place).  It trains with ``impl=kernels.plain`` by default, the
reference's ``impl="xla"``: the plain versions under autograd, attention
through its custom VJP.  The hand-written kernels have no backward, and a
model run with ``impl="cuda"`` under autograd raises.

Every builder takes ``mesh=``: the step then runs under that ambient mesh
(``distributed.context.use_mesh``) on the compute view of the params
(:func:`shard_params`), each rank on its own shard, and ``tp`` is the
mesh's 'model' axis.  The train step under a mesh takes this rank's rows
of the global batch and averages loss and grads over every batch axis
('pod' and 'data'), as the reference's step averages the global batch.
It trains in the optimizer's layout: ZeRO-1 (params whole over 'data') or
FSDP (params this rank's 'data' shard, each layer gathered where it runs,
``distributed.local.Fsdp``).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch import obs
from repro_torch.distributed import context, local
from repro_torch.distributed.sharding import BATCH_AXES, tp_size
from repro_torch.kernels import plain
from repro_torch.models import abstract, family_module
from repro_torch.models.config import ModelConfig
from repro_torch.models.tree import leaves, tree_map
from repro_torch.optim import AdamW, ef_compress

Params = Any


def resolve_tp(mesh, tp: int) -> int:
    """TP degree of a mesh-hosted step: the mesh's 'model' axis.  An
    explicit non-default ``tp`` must agree (params were padded with
    it)."""
    if mesh is None:
        return tp
    if not hasattr(mesh, "mesh_dim_names"):
        raise TypeError(f"mesh must be a DeviceMesh with named axes, got "
                        f"{type(mesh).__name__}")
    mtp = tp_size(mesh)
    if tp not in (1, mtp):
        raise ValueError(f"tp={tp} conflicts with the mesh's model axis "
                         f"({mtp}); the mesh decides the TP degree")
    return mtp


def shard_params(cfg: ModelConfig, params: Params, mesh, *,
                 specs=None, fsdp: bool = False) -> Params:
    """The compute view on this rank (``distributed.local``) of whole
    params (padded for the mesh's 'model' axis) or of DTensors laid out by
    ``specs`` (default the family's): with ``fsdp``, each leaf this rank's
    shard over 'data' too."""
    mod = family_module(cfg)
    return local.local_params(params, specs or mod.specs(cfg), mesh,
                              mod.compute_segments(cfg, tp_size(mesh)),
                              fsdp=fsdp)


def _on_mesh(fn, mesh):
    """``fn`` run under the ambient ``mesh`` (unchanged without one)."""
    if mesh is None:
        return fn

    def run(*args, **kwargs):
        with context.use_mesh(mesh):
            return fn(*args, **kwargs)
    return run


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE in float32; padded-vocab rows arrive already
    masked to -1e30 by unembed, so logsumexp ignores them."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def model_inputs(batch: dict, cfg: ModelConfig) -> dict:
    return {k: v for k, v in batch.items() if k != "labels"}


def make_loss_fn(cfg: ModelConfig, *, tp: int = 1, impl=plain):
    mod = family_module(cfg)

    def loss_fn(params, batch):
        logits = mod.forward(params, cfg, model_inputs(batch, cfg),
                             tp=tp, impl=impl)
        labels = batch["labels"]
        if cfg.vis_tokens:           # loss on the text tail only
            logits = logits[:, cfg.vis_tokens:]
        return cross_entropy(logits, labels)

    return loss_fn


def value_and_grad(loss_fn, params: Params, batch: dict,
                   fsdp: local.Fsdp | None = None
                   ) -> tuple[torch.Tensor, Params]:
    """(loss, grads) of ``loss_fn(params, batch)``, the grads a tree like
    ``params``, from ``torch.autograd.grad`` over detached aliases of the
    param leaves: no ``.grad`` and no ``requires_grad`` is left on the
    params.  A leaf the loss does not read (hubert's embedding table) gets
    zeros, as in ``jax.value_and_grad``.  With ``fsdp`` the params are
    this rank's shards in that layout, gathered layer by layer
    (``local.fsdp_scope``); the grad of a leaf cut over 'data' is then its
    slice of the sum over the 'data' ranks."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad(), local.fsdp_scope(fsdp):
        loss = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, list(leaves(live)),
                                    allow_unused=True, materialize_grads=True)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(cfg: ModelConfig, optimizer: AdamW, *, tp: int = 1,
                    impl=plain, ef_state: Params | None = None, mesh=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: :func:`value_and_grad`, then the optimizer
    updates the params in place.  With ``ef_state``
    (``optim.ef_init(params)``) the grads are int8-compressed with error
    feedback before the update and the residual is carried in
    ``ef_state``, in place.

    Under ``mesh`` the params are this rank's compute view in the layout
    ``optimizer.shard`` set (ZeRO-1, or FSDP with ``fsdp=True``),
    ``batch`` this rank's rows of the global batch
    (``SyntheticLM.global_arrays``); the loss and the grads are averaged
    over the batch axes 'pod' and 'data' (equal rows a rank, so the
    global batch's mean).  Under FSDP the grad of a leaf cut over 'data'
    arrives summed over 'data' from the backward's reduce-scatter, so only
    'pod' is left to sum; the optimizer then updates each rank's shard,
    with no gather."""
    tp = resolve_tp(mesh, tp)
    loss_fn = make_loss_fn(cfg, tp=tp, impl=impl)
    axes = {a: local.mesh_axis(mesh, a) for a in BATCH_AXES}
    axes = {a: ax for a, ax in axes.items() if ax is not None}
    ways = math.prod(ax.size for ax in axes.values())
    layout = None
    if mesh is not None and optimizer.fsdp:
        shapes = abstract(family_module(cfg).init, cfg, tp=tp, device="cpu")
        layout = local.Fsdp(optimizer.specs, mesh, shapes)

    def mean(x, summed=()):
        """``x`` summed over the batch axes but those in ``summed``,
        divided by the global batch's ranks."""
        for a, ax in axes.items():
            if a not in summed:
                x = local.all_reduce(x, ax.group)
        return x / ways

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(loss_fn, params, batch, layout)
        if axes:
            loss = mean(loss)
            if layout is None:
                grads = tree_map(mean, grads)
            else:
                grads = layout.map(lambda g, part: mean(
                    g, ("data",) if part else ()), grads)
        if ef_state is not None:
            grads, new_ef = ef_compress(grads, ef_state)
            for e, n in zip(leaves(ef_state), leaves(new_ef)):
                e.copy_(n)
        params, opt_state, gnorm = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return _on_mesh(train_step, mesh)


def make_cache(cfg: ModelConfig, mesh, build, specs, device) -> Params:
    """``build(device)``'s cache -- under ``mesh``, this rank's compute
    view of it, allocated without its whole: ``build`` is called with
    ``"meta"`` for the shapes, laid out by ``specs``."""
    if mesh is None:
        return build(device)
    return local.local_zeros(
        build("meta"), specs, mesh, device,
        family_module(cfg).compute_segments(cfg, tp_size(mesh)))


def make_prefill_step(cfg: ModelConfig, *, tp: int = 1, impl: str = "cuda",
                      cache_len: int | None = None, mesh=None):
    """Prefill step builder.

    Without ``cache_len`` (prefill scoring): a plain full-sequence forward
    returning logits; its attention runs ``impl`` ('cuda': the flash
    kernel; see ``models.layers`` for the other choices).

    With ``cache_len`` (serving): one causal forward over ``tokens (1, S)``
    through the decode path against a fresh batch-1 cache on the tokens'
    device, returning ``(logits, slot_cache)`` where ``slot_cache`` is
    packed into the serving layout (length ``cache_len``, ring folds
    applied): what S sequential decode steps would have left.

    Under ``mesh`` the params are this rank's compute view
    (:func:`shard_params`) and so is the slot cache; the logits are whole
    on every rank.
    """
    mod = family_module(cfg)
    tp = resolve_tp(mesh, tp)

    if cache_len is None:
        def prefill_step(params, batch):
            st = obs.recording()
            if st is None:
                return mod.forward(params, cfg, batch, tp=tp, impl=impl)
            # the session's count of forwards indexes this one
            forwards = st.metrics.counter("prefill.forwards")
            tokens = batch["tokens"]
            args = {"batch": tokens.shape[0], "seq": tokens.shape[1],
                    "forward": int(forwards.value)}
            forwards.inc()
            with st.tracer.span("prefill.forward", args, tokens.device):
                return mod.forward(params, cfg, batch, tp=tp, impl=impl)

        return _on_mesh(prefill_step, mesh)

    def slot_prefill_step(params, tokens):
        b, s = tokens.shape
        pcache = make_cache(
            cfg, mesh, lambda dev: mod.init_prefill_cache(cfg, b, s, tp,
                                                          device=dev),
            mod.cache_specs(cfg), tokens.device)
        logits, pcache = mod.decode_step(
            params, cfg, pcache, tokens, torch.zeros(b, dtype=torch.int64),
            tp=tp, impl=impl)
        return logits, mod.pack_slot_cache(cfg, pcache, cache_len, s)

    return _on_mesh(slot_prefill_step, mesh)


def make_decode_step(cfg: ModelConfig, *, tp: int = 1, impl: str = "cuda",
                     mesh=None):
    mod = family_module(cfg)
    tp = resolve_tp(mesh, tp)

    def decode_step(params, cache, tokens, pos, row_map=None):
        """tokens (B, S); pos (B,) per-slot absolute positions (scalar
        broadcasts).  The cache is written in place and returned."""
        return mod.decode_step(params, cfg, cache, tokens, pos,
                               tp=tp, impl=impl, row_map=row_map)

    return _on_mesh(decode_step, mesh)
