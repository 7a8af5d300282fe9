"""The port's sharding lint and analysis CLI against the reference's
(``repro_torch.analysis.sharding_lint``, ``python -m
repro_torch.analysis``), and the shape-cell registry and shape-only init
they rest on:

  * the shape-cell registry equals ``repro.configs``', pair for pair;
  * ``models.abstract`` (fake tensors) gives ``jax.eval_shape``'s shapes
    and dtypes for ``init``, ``init_cache`` and ``init_paged_cache`` of
    every arch at tp 1, 4 and 16, and allocates nothing;
  * ``lint_config`` finds what the reference's finds (severity, rule and
    site) for every arch on four meshes, and every seeded defect of
    ``tests/test_analysis_sharding.py`` fires in both lints alike;
  * on a fake 16x16 ``DeviceMesh`` (a subprocess: the group is
    process-wide) every clean spec turns into placements, and a spec out
    of the mesh's axis order is reported, not raised;
  * the CLI's verdicts equal the reference CLI's, and ``--rules`` lists
    every rule of the port's four analyzers.
"""
import functools
import io
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as ref_configs
from repro.analysis import sharding_lint as ref_lint
from repro.models import family_module as ref_family
from repro_torch import configs
from repro_torch.analysis import sharding_lint
from repro_torch.distributed.sharding import P
from repro_torch.models import abstract

ROOT = Path(__file__).resolve().parents[1]
MESHES = [None, {"data": 2, "model": 4}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16}]
SLOTS, MAX_SEQ = 4, 64


def test_shape_cell_registry_equals_the_reference():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert configs.all_cells() == ref_configs.all_cells()
    assert configs.runnable_cells() == ref_configs.runnable_cells()
    assert len(configs.runnable_cells()) == 31
    skips = [c for c in configs.all_cells()
             if configs.cell_skip_reason(*c) is not None]
    assert len(skips) == 9
    for arch, shape in configs.all_cells():
        assert configs.cell_skip_reason(arch, shape) == \
            ref_configs.cell_skip_reason(arch, shape)


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), tuple(x.shape), jnp.dtype(x.dtype).name)
            for p, x in flat]


def _port_leaves(tree):
    return [(p, tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in sharding_lint.flatten_with_path(tree)]


@functools.cache
def _ref_trees(arch: str, tp: int):
    cfg = ref_configs.get_config(arch)
    mod = ref_family(cfg)
    params = jax.eval_shape(functools.partial(mod.init, cfg, tp=tp),
                            jax.random.PRNGKey(0))
    if cfg.embed_inputs:
        return params, None, None
    cache = jax.eval_shape(functools.partial(mod.init_cache, cfg, SLOTS,
                                             MAX_SEQ, tp))
    paged = jax.eval_shape(functools.partial(
        mod.init_paged_cache, cfg, SLOTS, SLOTS * MAX_SEQ, MAX_SEQ, tp))
    return params, cache, paged


def _with_scratch_row(leaves, pool_axes):
    """The reference's paged leaves as the port lays them out: each pool
    leaf has one scratch row past the rows the page table maps (dim 1;
    ``layers.init_paged_kv_pool``)."""
    marks = [m for _, m in sharding_lint.flatten_with_path(pool_axes)]
    return [(p, (s[0], s[1] + 1, *s[2:]) if m == "pool" else s, d)
            for (p, s, d), m in zip(leaves, marks)]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_abstract_init_matches_eval_shape(arch):
    from repro_torch.models import family_module

    cfg = configs.get_config(arch)
    for tp in (1, 4, 16):
        want = _ref_trees(arch, tp)
        got = sharding_lint.abstract_trees(cfg, tp, SLOTS, MAX_SEQ)
        for w, g, what in zip(want, got, ("params", "cache", "paged")):
            if w is None:
                assert g is None, f"{arch} has no {what}"
                continue
            w = _ref_leaves(w)
            if what == "paged":
                w = _with_scratch_row(
                    w, family_module(cfg).paged_slot_axes(cfg))
            assert _port_leaves(g) == w, f"{arch} tp {tp} {what}"
            assert all(isinstance(t, torch._subclasses.FakeTensor)
                       for _, t in sharding_lint.flatten_with_path(g))


def test_abstract_allocates_nothing():
    from repro_torch.models import family_module

    cfg = configs.get_config("deepseek-67b")
    params = abstract(family_module(cfg).init, cfg, tp=1, device="cpu")
    leaves = [t for _, t in sharding_lint.flatten_with_path(params)]
    assert all(isinstance(t, torch._subclasses.FakeTensor) for t in leaves)
    total = sum(t.numel() * t.element_size() for t in leaves)
    assert total > 100e9, total       # 67 B params in bf16: held by nothing


def _sev_rule_site(findings):
    return sorted((f.severity, f.rule, f.site) for f in findings)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_lint_config_matches_the_reference(arch):
    for mesh in MESHES:
        want = ref_lint.lint_config(ref_configs.get_config(arch), mesh)
        got = sharding_lint.lint_config(configs.get_config(arch), mesh)
        assert _sev_rule_site(got) == _sev_rule_site(want), (arch, mesh)


# the seeded defects of tests/test_analysis_sharding.py:58-125: (spec tree,
# tree of leaf shapes, mesh, lint_tree keywords); the spec entries are
# written once and built as the reference's and the port's specs
BIG, SMALL = (2048, 2048), (64, 64)
SEEDED = {
    "unknown-axis": ({"w": ("tensor",)}, {"w": (8, 8)}, {"data": 2}, {}),
    "indivisible": ({"w": ("model",)}, {"w": (6, 8)}, {"model": 4}, {}),
    "indivisible-off-mesh": ({"w": ("model",)}, {"w": (6, 8)}, None, {}),
    "indivisible-model2": ({"w": ("model",)}, {"w": (6, 8)}, {"model": 2},
                           {}),
    "axis-tuple-product": ({"w": (("pod", "data"), None)}, {"w": (12, 4)},
                           {"pod": 2, "data": 4}, {}),
    "axis-tuple-divides": ({"w": (("pod", "data"), None)}, {"w": (16, 4)},
                           {"pod": 2, "data": 4}, {}),
    "rank-mismatch": ({"w": ("model", None, None)}, {"w": (8,)}, None, {}),
    "duplicate-axis": ({"w": ("data", "data")}, {"w": (8, 8)}, {"data": 2},
                       {}),
    "tree-mismatch": ({"a": ()}, {"a": (4,), "b": (4,)}, None, {}),
    "pool-rows": ({"k": (None, "model", None)}, {"k": (2, 8, 4)},
                  {"model": 4}, {"pool_axes": {"k": "pool"}}),
    "pool-batch": ({"k": (None, None, "data")}, {"k": (2, 8, 4)},
                   {"data": 2}, {"pool_axes": {"k": "pool"}}),
    "replicated-big": ({"w": ()}, {"w": BIG}, {"data": 2},
                       {"warn_replicated": True}),
    "replicated-small": ({"w": ()}, {"w": SMALL}, {"data": 2},
                         {"warn_replicated": True}),
    "replicated-no-mesh": ({"w": ()}, {"w": BIG}, None,
                           {"warn_replicated": True}),
    "replicated-cache": ({"w": ()}, {"w": BIG}, {"data": 2}, {}),
}


@pytest.mark.parametrize("case", sorted(SEEDED))
def test_seeded_defect_fires_alike(case):
    specs, shapes, mesh, kw = SEEDED[case]
    want = ref_lint.lint_tree(
        {k: JP(*v) for k, v in specs.items()},
        {k: jax.ShapeDtypeStruct(v, jnp.float32) for k, v in shapes.items()},
        mesh, site="t", **kw)
    got = sharding_lint.lint_tree(
        {k: P(*v) for k, v in specs.items()},
        {k: torch.empty(v, device="meta") for k, v in shapes.items()},
        mesh, site="t", **kw)
    assert _sev_rule_site(got) == _sev_rule_site(want)
    if case in ("indivisible-off-mesh", "indivisible-model2",
                "axis-tuple-divides", "replicated-small",
                "replicated-no-mesh", "replicated-cache"):
        assert got == []
    else:
        assert got, case


_PLACEMENTS = r"""
import sys
import torch
from repro_torch.analysis.sharding_lint import (R_PLACEMENT, lint_config,
                                                lint_tree)
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import P
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_production_mesh

with fake_world(256):
    mesh = make_production_mesh(device="cpu")
    for arch in ("qwen3-8b", "gemma2-2b", "rwkv6-3b", "zamba2-2.7b",
                 "granite-moe-3b-a800m", "hubert-xlarge"):
        cfg = get_config(arch)
        meshed = lint_config(cfg, mesh=mesh)
        plain = lint_config(cfg, {"data": 16, "model": 16})
        assert [f for f in meshed if f.rule == R_PLACEMENT] == [], arch
        assert meshed == plain, arch
        assert not [f for f in meshed if "/params" in f.site], arch
    # out of the mesh's axis order: reported, not raised
    bad = lint_tree({"w": P(("model", "data"))},
                    {"w": torch.empty(256, device="meta")}, None, site="t",
                    mesh=mesh)
    assert [f.rule for f in bad] == [R_PLACEMENT], bad
    # an indivisible dim: the rule reports it, placements take it
    uneven = lint_tree({"w": P("model")},
                       {"w": torch.empty(17, device="meta")}, None,
                       site="t", mesh=mesh)
    assert [f.rule for f in uneven] == ["sharding/indivisible-dim"], uneven
print("OK")
"""


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "JAX_PLATFORMS": "cpu"}


def test_placements_on_a_fake_16x16_mesh():
    res = subprocess.run([sys.executable, "-c", _PLACEMENTS], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")


def _verdicts(out: str) -> list[str]:
    return [ln for ln in out.splitlines()
            if ln.startswith(("sharding ", "golden "))]


def test_cli_verdicts_equal_the_reference_cli(tmp_path):
    procs = {
        pkg: subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.analysis", "--json",
             str(tmp_path / f"{pkg}.json")], cwd=ROOT, env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg in ("repro", "repro_torch")}
    outs = {}
    try:
        for pkg, proc in procs.items():
            out, err = proc.communicate(timeout=400)
            assert proc.returncode == 0, (pkg, err[-3000:])
            outs[pkg] = out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    want, got = _verdicts(outs["repro"]), _verdicts(outs["repro_torch"])
    assert len(got) == 2 * len(configs.ARCH_IDS) + 1
    assert got == want
    assert (tmp_path / "repro_torch.json").exists()


def test_rules_lists_every_port_rule():
    from repro_torch.analysis import RULES
    from repro_torch.analysis.__main__ import main

    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(["--rules"]) == 0
    listed = {ln.split(":", 1)[0] for ln in buf.getvalue().splitlines()}
    assert listed == set(RULES)
    families = {r.split("/")[0] for r in listed}
    assert families == {"sharding", "legality", "kv", "trace"}
    from repro_torch.analysis import trace_audit
    assert set(trace_audit.REFERENCE_RULES.values()) <= listed
    assert sharding_lint.R_PLACEMENT in listed
