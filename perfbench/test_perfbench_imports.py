"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the port.  Top-level names are
compared whole: ``repro_torch`` begins with ``repro`` and is allowed
outside the reference."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
MODULES = sorted(HERE.rglob("*.py"))


def _imports(path: Path) -> set[str]:
    """Top-level names of the absolute imports of ``path``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    names = _imports(path)
    assert "repro_torch" not in names
    # relative imports stay inside the benchmark: the reference, the
    # traffic generator and the weights
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.module in (None, "model", "quant", "traffic",
                                   "weights"), node.module


def test_the_check_names_a_module_by_its_whole_top_level_name():
    from perfbench.rank import FORBIDDEN as RUN_FORBIDDEN

    assert RUN_FORBIDDEN == FORBIDDEN
    assert "repro_torch".split(".")[0] not in RUN_FORBIDDEN


def test_the_scan_sees_each_kind_of_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.core import comm\n"
                 "import repro_torch\nfrom . import sibling\n")
    assert _imports(f) == {"jax", "repro", "repro_torch"}
