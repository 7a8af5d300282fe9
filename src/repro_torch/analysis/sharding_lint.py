"""Sharding lint: the port of ``repro/analysis/sharding_lint.py``.

Validates each model family's declared spec trees -- ``specs()`` /
``cache_specs()`` / ``paged_cache_specs()`` -- against the *real* tensor
shapes the family initializers produce (built on fake tensors by
``models.abstract``, so a 67B config lints in about a second without
allocating a byte) and against a target mesh described as a plain
``{axis: size}`` dict (no devices needed):

  * every axis named by a spec must be a known logical axis
    ('pod' | 'data' | 'model');
  * specs must structurally match the init tree and never exceed a leaf's
    rank or name the same mesh axis twice;
  * every dim sharded over mesh axes must be divisible by their product at
    the tensor-parallel padding the mesh implies (``tp = mesh['model']``);
  * large parameter leaves whose spec prunes to fully-replicated on a
    multi-device mesh are flagged (the silent memory cliff);
  * pooled paged-KV leaves must keep the physical-row axis replicated (the
    host-side page table addresses rows on every shard) and must not carry
    batch axes at all -- pool rows are shared across slots, so
    batch-sharding them is meaningless.

Given a ``DeviceMesh`` as well (``mesh=``), every leaf that passes those
rules must also turn into DTensor placements through
``distributed.sharding.placements``; a spec it refuses is reported, never
raised (DTensor itself takes an indivisible dim as an uneven shard, so the
rule above is what reports that).

Spec leaves are the port's :class:`~repro_torch.distributed.sharding.P`;
trees are walked with dict keys sorted (the reference's pytree order), and
a site names its leaf as ``jax.tree_util.keystr`` does:
``qwen3-8b/params['layers']['all']['attn']['wq']``.
"""
from __future__ import annotations

import functools
import math

from repro_torch.distributed.sharding import P

from .findings import Finding, rule

R_UNKNOWN_AXIS = rule(
    "sharding/unknown-axis",
    "spec names a mesh axis outside the logical axis set (pod/data/model): "
    "it will never match any production mesh and silently replicates")
R_RANK = rule(
    "sharding/rank-mismatch",
    "spec has more entries than the leaf has dims")
R_TREE = rule(
    "sharding/tree-mismatch",
    "spec tree structure differs from the init tree it must annotate")
R_DUP_AXIS = rule(
    "sharding/duplicate-axis",
    "the same mesh axis appears twice in one spec")
R_INDIVISIBLE = rule(
    "sharding/indivisible-dim",
    "a sharded dim is not divisible by the product of its mesh axis sizes")
R_REPLICATED = rule(
    "sharding/fully-replicated",
    "a large parameter leaf prunes to fully-replicated on this mesh: every "
    "device holds a whole copy")
R_POOL_ROWS = rule(
    "sharding/pool-rows-sharded",
    "paged-KV pool physical-row axis is sharded: the page table must "
    "address every row on every shard")
R_POOL_BATCH = rule(
    "sharding/pool-batch-axis",
    "paged-KV pool leaf sharded over a batch axis: pool rows are shared "
    "across slots, batch-sharding them is meaningless")
R_PLACEMENT = rule(
    "sharding/no-placement",
    "a spec that passes every rule above does not turn into DTensor "
    "placements on the mesh (a dim split over several axes out of the "
    "mesh's order)")

KNOWN_AXES = ("pod", "data", "model")

#: A replicated param leaf bigger than this on a >1-device mesh is flagged.
_REPLICATE_WARN_BYTES = 8 << 20


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def flatten_with_path(tree, is_leaf=lambda x: False, path: str = ""):
    """[(path, leaf)] of a tree of dicts, lists and tuples, dict keys in
    sorted order and paths in ``keystr`` notation (``['a'][0]``); ``None``
    is an empty subtree, as in a pytree."""
    if tree is None:
        return []
    if is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in flatten_with_path(tree[k], is_leaf,
                                              f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in flatten_with_path(v, is_leaf, f"{path}[{i}]")]
    return [(path, tree)]


def _is_spec(x) -> bool:
    return isinstance(x, P)


def lint_tree(specs_tree, shape_tree, mesh_axes: dict[str, int] | None, *,
              site: str, warn_replicated: bool = False,
              pool_axes=None, mesh=None) -> list[Finding]:
    """Check one spec tree against the matching tree of tensors (fake ones
    will do: only shapes and dtypes are read).

    ``mesh_axes`` is ``{axis_name: size}`` (None = linting off-mesh: only
    structural and axis-name rules apply).  ``pool_axes`` is the family's
    ``paged_slot_axes`` tree; leaves marked ``"pool"`` get the pooled-KV
    rules.  ``mesh`` (a ``DeviceMesh``) adds the placement check.
    """
    if mesh is not None and mesh_axes is None:
        mesh_axes = {n: mesh.size(i)
                     for i, n in enumerate(mesh.mesh_dim_names)}
    axes = mesh_axes or {}
    spec_leaves = flatten_with_path(specs_tree, _is_spec)
    shape_leaves = flatten_with_path(shape_tree)
    out: list[Finding] = []
    if [p for p, _ in spec_leaves] != [p for p, _ in shape_leaves]:
        out.append(Finding(
            "error", R_TREE, site,
            f"spec tree ({len(spec_leaves)} leaves) does not match the init "
            f"tree ({len(shape_leaves)} leaves)"))
        return out
    pool_flags = [None] * len(spec_leaves)
    if pool_axes is not None:
        pl = [leaf for _, leaf in flatten_with_path(pool_axes)]
        if len(pl) == len(spec_leaves):
            pool_flags = pl

    for (path, spec), (_, leaf), marker in zip(spec_leaves, shape_leaves,
                                               pool_flags):
        where = site + path
        shape = tuple(leaf.shape)
        entries = tuple(spec)
        if len(entries) > len(shape):
            out.append(Finding("error", R_RANK, where,
                               f"spec {spec} has {len(entries)} entries for "
                               f"a rank-{len(shape)} leaf {list(shape)}"))
            continue
        seen: set[str] = set()
        bad = False
        for d, entry in enumerate(entries):
            for a in _entry_axes(entry):
                if a not in KNOWN_AXES:
                    out.append(Finding(
                        "error", R_UNKNOWN_AXIS, where,
                        f"dim {d} names unknown axis {a!r} (known: "
                        f"{'/'.join(KNOWN_AXES)})"))
                    bad = True
                elif a in seen:
                    out.append(Finding("error", R_DUP_AXIS, where,
                                       f"axis {a!r} appears twice in {spec}"))
                    bad = True
                seen.add(a)
        if bad:
            continue
        sharded = False
        for d, entry in enumerate(entries):
            div = math.prod(axes.get(a, 1) for a in _entry_axes(entry))
            if div > 1:
                sharded = True
                if shape[d] % div:
                    out.append(Finding(
                        "error", R_INDIVISIBLE, where,
                        f"dim {d} of size {shape[d]} not divisible by "
                        f"{div} (axes {_entry_axes(entry)} on mesh "
                        f"{axes})"))
        nbytes = math.prod(shape) * leaf.dtype.itemsize
        if warn_replicated and not sharded and axes and \
                max(axes.values()) > 1 and nbytes >= _REPLICATE_WARN_BYTES:
            out.append(Finding(
                "warning", R_REPLICATED, where,
                f"{nbytes >> 20} MiB leaf replicated on every device of "
                f"mesh {axes}"))
        if marker == "pool":
            if len(entries) > 1 and entries[1] is not None:
                out.append(Finding(
                    "error", R_POOL_ROWS, where,
                    f"physical-row axis (dim 1) sharded as "
                    f"{entries[1]!r} in {spec}"))
            batch = [a for e in entries for a in _entry_axes(e)
                     if a in ("pod", "data")]
            if batch:
                out.append(Finding(
                    "error", R_POOL_BATCH, where,
                    f"pool leaf carries batch axis(es) {batch} in {spec}"))
        if mesh is not None:
            out += _placement_findings(spec, mesh, where)
    return out


def _placement_findings(spec: P, mesh, where: str) -> list[Finding]:
    from repro_torch.distributed.sharding import placements
    try:
        placements(spec, mesh)
    except ValueError as e:
        return [Finding("error", R_PLACEMENT, where, str(e))]
    return []


@functools.lru_cache(maxsize=None)
def abstract_trees(cfg, tp: int, slots: int, max_seq: int):
    """(params, cache, paged cache) of ``cfg`` at TP degree ``tp`` as fake
    tensors (the caches None for an encoder-only config), built once per
    argument set."""
    from repro_torch.models import abstract, family_module

    mod = family_module(cfg)
    params = abstract(mod.init, cfg, tp=tp, device="cpu")
    if cfg.embed_inputs:
        return params, None, None
    cache = abstract(mod.init_cache, cfg, slots, max_seq, tp, device="cpu")
    paged = abstract(mod.init_paged_cache, cfg, slots, slots * max_seq,
                     max_seq, tp, device="cpu")
    return params, cache, paged


def lint_config(cfg, mesh_axes: dict[str, int] | None = None, *,
                slots: int = 4, max_seq: int = 64,
                mesh=None) -> list[Finding]:
    """Lint one model config's param/cache/paged-cache specs against a mesh
    (``{axis: size}``; None = single device).  Shapes come from the real
    initializers run on fake tensors at the mesh's TP degree, so
    padding/divisibility is checked exactly as serving would see it.
    ``mesh`` (a ``DeviceMesh``, its axes taken when ``mesh_axes`` is None)
    adds the placement check.
    """
    from repro_torch.models import family_module

    if mesh is not None and mesh_axes is None:
        mesh_axes = {n: mesh.size(i)
                     for i, n in enumerate(mesh.mesh_dim_names)}
    mod = family_module(cfg)
    tp = (mesh_axes or {}).get("model", 1)
    params, cache, paged = abstract_trees(cfg, tp, slots, max_seq)
    out = lint_tree(mod.specs(cfg), params, mesh_axes,
                    site=f"{cfg.name}/params", warn_replicated=True,
                    mesh=mesh)
    if cfg.embed_inputs:     # encoder-only: no serving caches to lint
        return out
    out += lint_tree(mod.cache_specs(cfg), cache, mesh_axes,
                     site=f"{cfg.name}/cache", mesh=mesh)
    out += lint_tree(mod.paged_cache_specs(cfg), paged, mesh_axes,
                     site=f"{cfg.name}/paged_cache",
                     pool_axes=mod.paged_slot_axes(cfg), mesh=mesh)
    return out
