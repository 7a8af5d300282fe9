"""The port (``repro_torch``), ``chip_smoke.py``,
``examples/quickstart_torch.py`` and ``examples/train_lm_torch.py`` stand
alone: they import neither JAX nor anything of the reference package
``repro``, nor ``ml_dtypes`` (the card's machine has none).

Checked twice: dynamically, by importing every port module in a fresh
interpreter where ``jax`` is blocked and a meta-path hook refuses
``repro``/``repro.*``; and statically, by scanning every import statement
of the port's files, of ``chip_smoke.py`` and of the quickstart.
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
import importlib, importlib.abc, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["ml_dtypes"] = None    # nor `import ml_dtypes`

class RefuseReference(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "repro" or name.startswith("repro."):
            raise ImportError(f"repro_torch imported the reference: {name}")
        return None

sys.meta_path.insert(0, RefuseReference())
for mod in sys.argv[1:]:
    importlib.import_module(mod)
assert not any(m == "repro" or m.startswith("repro.") for m in sys.modules)
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
            "repro_torch.launch.mesh"} <= set(mods)
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
    files = sorted(PORT.rglob("*.py")) + [SMOKE, QUICKSTART, TRAIN_EXAMPLE]
    assert all(f.exists() for f in files)
    bad = [(str(f.relative_to(ROOT)), n) for f in files for n in _imports(f)
           if n.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")]
    assert bad == []
