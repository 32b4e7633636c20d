"""Nothing under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the program.  Module names are compared
by their top-level name, whole: ``repro_torch`` is not ``repro``."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "repro"}


def imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
            yield node.args[0].value.split(".")[0]


SOURCES = sorted(ROOT.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_package(path):
    assert not set(imports(path)) & NEVER


@pytest.mark.parametrize("path", sorted((ROOT / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(imports(path))


def test_the_check_tells_the_names_apart(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import repro_torch.models\nfrom repro.core import gasnet\n")
    assert list(imports(f)) == ["repro_torch", "repro"]
