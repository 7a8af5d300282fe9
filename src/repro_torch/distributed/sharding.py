"""Sharding rules for a device mesh, in PyTorch.

Port of ``repro/distributed/sharding.py``.  Model code describes params,
caches and optimizer state by spec trees over the logical mesh axes
('pod', 'data', 'model', and 'stage' for the pipeline); these helpers
adapt the specs to the mesh the job brings up (a single-host mesh has no
'pod' axis) and turn them into placements on a
``torch.distributed.device_mesh.DeviceMesh``.

A spec (:class:`P`) is a tuple with one entry per tensor dim: ``None``
(replicated), an axis name, or a tuple of axis names (the dim split over
those axes, the first outermost).  ``named`` is the counterpart of
``NamedSharding``: each spec becomes DTensor placements, one per mesh dim
(``Shard(d)`` where the spec names that mesh dim on tensor dim ``d``, else
``Replicate()``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

# logical mesh axes: batch over (pod, data), FSDP over data, tensor over model
FSDP = "data"
TP = "model"
BATCH_AXES = ("pod", "data")


class P(tuple):
    """A partition spec: ``P(FSDP, TP)`` is the tuple ``("data",
    "model")``; it equals the reference's ``PartitionSpec`` read as a
    tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def spec_map(fn, tree):
    """``fn`` over the spec leaves of a tree of dicts, lists and tuples
    (a :class:`P` is a leaf, though it is a tuple)."""
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: spec_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(spec_map(fn, v) for v in tree)
    return fn(tree)


def axis_names(mesh) -> tuple[str, ...]:
    """The axis names of ``mesh``: a ``DeviceMesh`` (its
    ``mesh_dim_names``) or a tuple of names."""
    if isinstance(mesh, tuple):
        return mesh
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh, name: str) -> int:
    names = axis_names(mesh)
    return mesh.size(names.index(name)) if name in names else 1


def _filter_axes(entry, names: tuple[str, ...]):
    if entry is None:
        return None
    if isinstance(entry, str):
        return entry if entry in names else None
    kept = tuple(a for a in entry if a in names)
    return kept if len(kept) > 1 else (kept[0] if kept else None)


def prune_specs(tree, mesh):
    """Drop mesh axes the current mesh does not have from every spec."""
    names = axis_names(mesh)
    return spec_map(lambda s: P(*(_filter_axes(e, names) for e in s)), tree)


def zero1_specs(tree):
    """ZeRO-1 parameter specs: drop the 'data' (FSDP) axis from parameters
    -- weights become TP-only (replicated over data), while optimizer
    moments keep the original fully-sharded specs."""
    def strip(entry):
        if entry == "data":
            return None
        if isinstance(entry, tuple):
            kept = tuple(a for a in entry if a != "data")
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        return entry

    return spec_map(lambda s: P(*(strip(e) for e in s)), tree)


def batch_specs(cfg) -> dict[str, P]:
    """Input specs: batch dim over (pod, data)."""
    b = BATCH_AXES
    if cfg.embed_inputs:
        return {"frames": P(b, None, None), "labels": P(b, None)}
    if cfg.vis_tokens:
        return {"tokens": P(b, None), "patches": P(b, None, None),
                "labels": P(b, None)}
    return {"tokens": P(b, None), "labels": P(b, None)}


def tp_size(mesh) -> int:
    return axis_size(mesh, TP)


def mesh_dims_of(spec: P, names: tuple[str, ...]) -> list[list[int]]:
    """For each tensor dim of ``spec`` (pruned to ``names``), the mesh dims
    that split it, outermost first."""
    out = []
    for entry in prune_specs(spec, names):
        if entry is None:
            out.append([])
        else:
            axes = (entry,) if isinstance(entry, str) else entry
            out.append([names.index(a) for a in axes])
    return out


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for dim, mdims in enumerate(mesh_dims_of(spec, names)):
        if mdims != sorted(mdims):
            raise ValueError(f"{spec}: a dim split over several axes must "
                             f"name them in the mesh's order {names} "
                             f"(DTensor nests shards in mesh-dim order)")
        for m in mdims:
            out[m] = Shard(dim)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the pruned ``spec`` and its DTensor
    ``placements``."""
    mesh: Any
    spec: P
    placements: tuple


def named(tree, mesh):
    """Spec tree -> :class:`NamedSharding` tree (pruned to the mesh)."""
    return spec_map(lambda s: NamedSharding(mesh, s, placements(s, mesh)),
                    prune_specs(tree, mesh))


def param_shardings(model_module, cfg, mesh):
    return named(model_module.specs(cfg), mesh)


def cache_shardings(model_module, cfg, mesh):
    return named(model_module.cache_specs(cfg), mesh)
