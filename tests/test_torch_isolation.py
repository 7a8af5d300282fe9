"""The port (``repro_torch``, its ``bench`` scripts included),
``chip_smoke.py`` and the port's examples (``examples/*_torch.py``) stand
alone: they import neither JAX nor anything of the reference package
``repro``, nor the reference's ``benchmarks``, nor ``ml_dtypes`` (the
card's machine has none).

Checked twice: dynamically, by importing every port module and every port
example in a fresh interpreter where ``jax`` is blocked and a meta-path
hook refuses ``repro``/``repro.*`` and ``benchmarks``/``benchmarks.*``;
and statically, by scanning every import statement of the port's files, of
``chip_smoke.py`` and of the examples.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"
QUICKSTART = ROOT / "examples" / "quickstart_torch.py"
TRAIN_EXAMPLE = ROOT / "examples" / "train_lm_torch.py"
SERVE_EXAMPLE = ROOT / "examples" / "serve_lm_torch.py"
CONVNET_EXAMPLE = ROOT / "examples" / "codesign_convnet_torch.py"
EXAMPLES = [QUICKSTART, TRAIN_EXAMPLE, SERVE_EXAMPLE, CONVNET_EXAMPLE]
REFUSED = ("jax", "jaxlib", "repro", "ml_dtypes", "benchmarks")


def _port_modules() -> list[str]:
    mods = []
    for f in sorted(PORT.rglob("*.py")):
        rel = f.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


_PROBE = r"""
import importlib, importlib.abc, importlib.util, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["ml_dtypes"] = None    # nor `import ml_dtypes`

class RefuseReference(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("repro", "benchmarks"):
            raise ImportError(f"repro_torch imported the reference: {name}")
        return None

sys.meta_path.insert(0, RefuseReference())
for mod in sys.argv[1:]:
    if mod.endswith(".py"):        # an example: load the file, run no main
        spec = importlib.util.spec_from_file_location("example", mod)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    else:
        importlib.import_module(mod)
assert not any(m.split(".")[0] in ("repro", "benchmarks")
               for m in sys.modules)
assert "jax" not in sys.modules or sys.modules["jax"] is None
print("imported", len(sys.argv) - 1)
"""


def test_every_port_module_imports_without_jax_or_reference():
    mods = _port_modules()
    assert "repro_torch.kernels.ops" in mods and "repro_torch.core" in mods
    assert {"repro_torch.launch.serve", "repro_torch.models.transformer",
            "repro_torch.kernels.flash_attention",
            "repro_torch.models.rwkv6", "repro_torch.models.zamba2",
            "repro_torch.kernels.rwkv6", "repro_torch.kernels.mamba2",
            "repro_torch.kernels.xla_linear", "repro_torch.core.nsga2",
            "repro_torch.core.random_search", "repro_torch.obs.__main__",
            "repro_torch.launch.paging",
            "repro_torch.analysis.kv_sanitizer", "repro_torch.launch.train",
            "repro_torch.ft.checkpoint", "repro_torch.optim.adamw",
            "repro_torch.optim.compression",
            "repro_torch.data.pipeline", "repro_torch.distributed",
            "repro_torch.distributed.sharding",
            "repro_torch.distributed.context",
            "repro_torch.distributed.local",
            "repro_torch.distributed.pipeline",
            "repro_torch.launch.mesh", "repro_torch.analysis.__main__",
            "repro_torch.analysis.sharding_lint",
            "repro_torch.analysis.trace_audit",
            "repro_torch.launch.dryrun", "repro_torch.launch.op_analysis",
            "repro_torch.launch.roofline", "repro_torch.bench",
            "repro_torch.bench._results", "repro_torch.bench.run",
            "repro_torch.bench.kernel_micro",
            "repro_torch.bench.fig7_intrinsics",
            "repro_torch.bench.fig10_hw_dse",
            "repro_torch.bench.fig11_sw_dse",
            "repro_torch.bench.table3_codesign",
            "repro_torch.bench.ablation_qlearning",
            "repro_torch.bench.bench_batched_eval",
            "repro_torch.bench.bench_acquisition",
            "repro_torch.bench.bench_sw_dse",
            "repro_torch.bench.bench_calibration",
            "repro_torch.bench.bench_serve",
            "repro_torch.bench.bench_obs",
            "repro_torch.bench.bench_serve_tp"} <= set(mods)
    assert all(f.exists() for f in EXAMPLES)
    mods += [str(f) for f in EXAMPLES]
    res = subprocess.run([sys.executable, "-c", _PROBE, *mods],
                         cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert f"imported {len(mods)}" in res.stdout


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_no_file_of_the_port_or_the_smoke_names_jax_or_reference():
    files = sorted(PORT.rglob("*.py")) + [SMOKE, *EXAMPLES]
    assert all(f.exists() for f in files)
    assert PORT / "bench" / "run.py" in files
    bad = [(str(f.relative_to(ROOT)), n) for f in files for n in _imports(f)
           if n.split(".")[0] in REFUSED]
    assert bad == []
