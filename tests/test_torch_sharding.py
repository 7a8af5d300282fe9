"""The port's sharding rules (``repro_torch.distributed``) against the
reference's (``repro.distributed``).

* Every family's ``specs`` / ``cache_specs`` / ``paged_cache_specs`` equal
  the reference's, each ``PartitionSpec`` read as a tuple, for qwen3-8b,
  gemma2-2b, zamba2-2.7b, rwkv6-3b and granite-moe-3b-a800m at reduced
  configs (the reference builds them with pure functions that run here).
* ``prune_specs``, ``zero1_specs``, ``batch_specs`` and ``tp_size`` give
  equal trees.
* The activation context of ``tests/test_distributed.py``, restated for
  the port (its own reset fixture stands in for the conftest's), the lazy
  pruning included.
* ``make_host_mesh`` factors the ranks and keeps the reference's errors
  (one rank in this process; four ranks, as a ``gloo`` process group with a
  ``FileStore`` rendezvous, in one multi-rank test); the layout helpers cut
  and rebuild uneven shards by DTensor's chunk rule.
"""
import textwrap

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jget_config
from repro.distributed import sharding as jsharding
from repro.models import family_module as jfamily
from repro.models import reduced as jreduced
from repro_torch.configs import get_config
from repro_torch.distributed import context, sharding
from repro_torch.distributed.context import (DEFAULT_TRAIN_SPEC,
                                             activation_spec,
                                             constrain_activations,
                                             get_activation_spec,
                                             set_activation_spec)
from repro_torch.distributed.sharding import P, prune_specs, spec_map
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     rank_json, run_ranks)
from repro_torch.models import family_module, reduced

FAMILIES = ["qwen3-8b", "gemma2-2b", "zamba2-2.7b", "rwkv6-3b",
            "granite-moe-3b-a800m"]
SRC = str(__import__("pathlib").Path(__file__).resolve().parents[1] / "src")
ONE_THREAD = {"OMP_NUM_THREADS": "1", "PYTHONPATH": SRC}


@pytest.fixture(autouse=True)
def _reset_port_context():
    yield
    context.reset()


def _ref_tuples(tree):
    return jax.tree_util.tree_map(lambda s: tuple(s), tree,
                                  is_leaf=lambda x: isinstance(x, JP))


def _port_tuples(tree):
    return spec_map(tuple, tree)


@pytest.mark.parametrize("arch", FAMILIES)
def test_spec_trees_equal_the_reference(arch):
    jcfg = jreduced(jget_config(arch))
    cfg = reduced(get_config(arch))
    jmod, mod = jfamily(jcfg), family_module(cfg)
    for name in ("specs", "cache_specs", "paged_cache_specs"):
        want = _ref_tuples(getattr(jmod, name)(jcfg))
        got = _port_tuples(getattr(mod, name)(cfg))
        assert got == want, name
    # and each spec has one entry per dim of its leaf
    params = mod.init(cfg, seed=0, device="cpu")
    flat = []
    from repro_torch.distributed.local import zip_specs
    zip_specs(lambda t, s, p: flat.append((t.dim(), len(s))), params,
               mod.specs(cfg))
    assert all(a == b for a, b in flat) and flat


@pytest.mark.parametrize("arch", FAMILIES)
def test_prune_zero1_batch_specs_and_tp_size_equal_the_reference(arch):
    jcfg = jreduced(jget_config(arch))
    cfg = reduced(get_config(arch))
    jspecs = jfamily(jcfg).specs(jcfg)
    specs = family_module(cfg).specs(cfg)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    names = ("data", "model")
    assert _port_tuples(prune_specs(specs, names)) == _ref_tuples(
        jsharding.prune_specs(jspecs, jmesh))
    assert _port_tuples(sharding.zero1_specs(specs)) == _ref_tuples(
        jsharding.zero1_specs(jspecs))
    cache = family_module(cfg).cache_specs(cfg)
    assert _port_tuples(prune_specs(cache, names)) == _ref_tuples(
        jsharding.prune_specs(jfamily(jcfg).cache_specs(jcfg), jmesh))
    for a in ("hubert-xlarge", "internvl2-76b", arch):
        assert _port_tuples(sharding.batch_specs(get_config(a))) == \
            _ref_tuples(jsharding.batch_specs(jget_config(a)))
    mesh = make_host_mesh()
    assert sharding.tp_size(mesh) == jsharding.tp_size(jmesh) == 1


def test_prune_specs_drops_missing_axes():
    mesh = make_host_mesh()
    tree = {"a": P(("pod", "data"), "model"), "b": P("pod"), "c": P(None)}
    got = prune_specs(tree, mesh)
    assert got["a"] == P("data", "model")
    assert got["b"] == P(None)
    assert got["c"] == P(None)
    assert prune_specs(P(("pod", "data", "model")), mesh) == P(
        ("data", "model"))


def test_named_builds_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_host_mesh()
    sh = sharding.named({"w": P("model", "data"), "b": P(("pod", "data"))},
                        mesh)
    assert sh["w"].placements == (Shard(1), Shard(0))
    assert sh["b"].placements == (Shard(0), Replicate())
    assert sh["b"].spec == P("data")
    assert sharding.placements(P(None, None), mesh) == (Replicate(),
                                                        Replicate())


def test_activation_context_noop_when_unset():
    set_activation_spec(None)
    x = torch.ones((2, 4, 8))
    assert constrain_activations(x) is x
    assert not context.sequence_parallel(4)


def test_activation_spec_context_manager_scopes_and_restores():
    mesh = make_host_mesh()
    set_activation_spec(P("data", None, None), mesh)
    with activation_spec(DEFAULT_TRAIN_SPEC, mesh):
        # pruned against the install mesh's axes ('pod' dropped)
        assert get_activation_spec() == P("data", "model", None)
    assert get_activation_spec() == P("data", None, None)   # restored
    context.reset()
    assert get_activation_spec() is None


def test_activation_spec_installed_without_mesh_prunes_lazily():
    """``set_activation_spec(spec)`` with no mesh stores the raw spec; it
    prunes at apply time against the mesh actually active, so a spec
    naming 'pod' never breaks a podless mesh."""
    set_activation_spec(DEFAULT_TRAIN_SPEC)   # no mesh: raw spec stored
    assert get_activation_spec() == DEFAULT_TRAIN_SPEC
    mesh = make_host_mesh()                   # podless
    x = torch.ones((2, 4, 8))
    with context.use_mesh(mesh):
        assert get_activation_spec() == P("data", "model", None)
        out = constrain_activations(x)
        # a one-rank 'model' axis shards nothing
        assert not context.sequence_parallel(4)
    assert out.shape == x.shape
    assert float(out.sum()) == float(x.sum())


def test_activation_context_fixture_installs():
    # paired with the test below: relies on in-file definition order to
    # verify this file's reset fixture isolates the tests
    set_activation_spec(DEFAULT_TRAIN_SPEC)
    assert get_activation_spec() is not None


def test_activation_context_fixture_isolates():
    assert get_activation_spec() is None


def test_make_host_mesh_tp_factors_and_errors():
    mesh = make_host_mesh()
    assert mesh.mesh_dim_names == ("data", "model")
    assert (mesh.size(0), mesh.size(1)) == (1, 1)
    assert make_host_mesh(tp=1).size(1) == 1
    with pytest.raises(ValueError):
        make_host_mesh(tp=2)   # 2 never divides 1
    with pytest.raises(ValueError):
        make_host_mesh(tp=0)
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")


_FOUR = textwrap.dedent("""
    import json, os, torch
    from torch.distributed.tensor import DTensor, Shard, Replicate
    from repro_torch.distributed import local, sharding
    from repro_torch.distributed.sharding import P
    from repro_torch.launch.mesh import make_host_mesh, describe
    meshes = {tp: make_host_mesh(tp=tp) for tp in (1, 2, 4)}
    out = {tp: [describe(m), sharding.tp_size(m)] for tp, m in meshes.items()}
    errs = []
    for bad in (3, 0, 8):
        try:
            make_host_mesh(tp=bad)
        except ValueError as e:
            errs.append(str(e))
    m = meshes[2]
    # uneven shards (DTensor's chunk rule) round-trip through the layout
    t = torch.arange(7 * 5 * 3, dtype=torch.float32).reshape(7, 5, 3)
    ok = []
    for spec in (P("data", "model", None), P(("data", "model"), None, None),
                 P(None, ("data", "model"), None), P(None, None, "model")):
        d = local.distribute({"t": t}, {"t": spec}, m)["t"]
        ok.append(isinstance(d, DTensor)
                  and tuple(d.shape) == tuple(t.shape)
                  and torch.equal(local.full_tensor(d), t)
                  and torch.equal(local.gather_full(
                      local.local_shard(t, spec, m), t.shape, spec, m), t))
    try:   # DTensor nests shards in mesh-dim order only
        sharding.placements(P(None, ("model", "data")), m)
    except ValueError as e:
        errs.append(str(e))
    print(json.dumps({"meshes": out, "errs": errs, "ok": ok,
                      "coord": list(m.get_coordinate())}), flush=True)
    torch.distributed.destroy_process_group()
    os._exit(0)   # skip the teardown, where a gloo thread can abort
""")


def test_four_ranks_factor_into_meshes_and_rebuild_uneven_shards(tmp_path):
    procs = run_ranks(["-c", _FOUR], 4, tmp_path, timeout=100,
                      env=ONE_THREAD)
    for r, p in enumerate(procs):
        assert p.returncode == 0, p.stderr[-3000:]
        got = rank_json(p)
        assert got["meshes"] == {"1": ["data=4xmodel=1", 1],
                                 "2": ["data=2xmodel=2", 2],
                                 "4": ["data=1xmodel=4", 4]}
        assert len(got["errs"]) == 4
        assert all("divide" in e for e in got["errs"][:3])
        assert "mesh's order" in got["errs"][3]
        assert got["ok"] == [True] * 4
        assert got["coord"] == [r // 2, r % 2]
