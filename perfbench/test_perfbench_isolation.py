"""What the benchmark runs imports neither JAX nor the JAX package, reads
nothing of the old harnesses, and its reference imports nothing of the
program."""
import ast
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set[str]:
    """Top-level names (before the first dot) of every import in a file;
    a relative import is the benchmark's own."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.add(node.module.split(".")[0])
    return names


def _run_files():
    return [p for p in HERE.rglob("*.py") if not p.name.startswith("test_")
            and p.name != "conftest.py"]


def test_nothing_run_imports_jax_or_the_jax_package():
    assert len(_run_files()) > 10
    for path in _run_files():
        bad = _imports(path) & FORBIDDEN
        assert not bad, f"{path.relative_to(HERE)} imports {bad}"


def test_whole_top_level_names(tmp_path):
    # the port's name begins with the JAX package's: compare whole names
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.models\nfrom repro_torch import kernels\n"
                 "import jaxtyping\n")
    assert _imports(f) == {"repro_torch", "jaxtyping"}
    assert not _imports(f) & FORBIDDEN
    f.write_text("from repro.core import codesign\n")
    assert _imports(f) & FORBIDDEN == {"repro"}


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        assert "repro_torch" not in _imports(path), path.name
        assert not _imports(path) & FORBIDDEN, path.name


def test_nothing_reads_the_old_harnesses():
    for path in _run_files():
        text = path.read_text()
        for old in ("benchmarks/", "repro_torch/bench", "repro_torch.bench",
                    "roofline.model_flops", "launch.roofline"):
            assert old not in text, f"{path.name} names {old}"


def test_forbidden_modules_compares_whole_names():
    from perfbench import harness

    assert harness.forbidden_modules(["repro_torch", "repro_torch.models",
                                      "jaxtyping", "torch"]) == []
    assert harness.forbidden_modules(["repro.core", "jax", "flax.linen",
                                      "jaxlib"]) == ["flax", "jax", "jaxlib",
                                                     "repro"]
