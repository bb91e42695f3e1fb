"""No module of the benchmark imports JAX or the JAX package, and the
plain reference and the model files import nothing of the port, directly
or through a module of the benchmark.  Top-level names are compared
whole: ``repro_torch`` begins with ``repro`` and is allowed outside the
reference and the model files."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
MODULES = sorted(HERE.rglob("*.py"))
# what runs where the port is not loaded
PORT_FREE = sorted([*(HERE / "reference").rglob("*.py"),
                    *(HERE / "models").rglob("*.py")])


def _imports(path: Path) -> set[str]:
    """Top-level names of the absolute imports of ``path``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _module_file(dotted: str) -> Path | None:
    """The file of ``perfbench.<...>`` (a module or a package's
    ``__init__``), or ``None``."""
    base = HERE.parent.joinpath(*dotted.split("."))
    for f in (base.with_suffix(".py"), base / "__init__.py"):
        if f.is_file():
            return f
    return None


def _benchmark_imports(path: Path) -> set[Path]:
    """The files of the benchmark's own modules that ``path`` imports:
    relative imports, and absolute ones of ``perfbench``; each imported
    name tried as a submodule first."""
    package = ".".join(path.relative_to(HERE.parent).with_suffix("").parts)
    if path.name != "__init__.py":
        package = package.rpartition(".")[0]
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names
                    if a.name.split(".")[0] == "perfbench"]
            names: list = []
        elif isinstance(node, ast.ImportFrom) and (
                node.level or node.module.split(".")[0] == "perfbench"):
            base = package.split(".")
            base = base[:len(base) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            mods, names = [mod], [a.name for a in node.names]
        else:
            continue
        for mod in mods:
            found = [_module_file(f"{mod}.{n}") for n in names]
            found = [f for f in found if f] or [_module_file(mod)]
            out |= {f for f in found if f}
    return out


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", PORT_FREE, ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    """Neither the file nor any module of the benchmark it reaches
    through its imports names the port; each stays inside ``perfbench``."""
    seen, todo = set(), [path]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        assert "repro_torch" not in _imports(f), f
        reached = _benchmark_imports(f)
        assert all(HERE in r.parents for r in reached), reached
        todo += reached
    assert len(seen) >= 1


def test_the_check_names_a_module_by_its_whole_top_level_name():
    from perfbench.rank import FORBIDDEN as RUN_FORBIDDEN

    assert RUN_FORBIDDEN == FORBIDDEN
    assert "repro_torch".split(".")[0] not in RUN_FORBIDDEN


def test_the_scan_sees_each_kind_of_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.core import comm\n"
                 "import repro_torch\nfrom . import sibling\n")
    assert _imports(f) == {"jax", "repro", "repro_torch"}


def test_the_walk_follows_the_benchmark_s_own_imports():
    """The reference reaches the generator, the weights and the wire's
    round trip; the harness's rank, which a port-free file must not
    reach, names the port."""
    got = _benchmark_imports(HERE / "reference" / "train.py")
    assert got == {HERE / "traffic" / "__init__.py", HERE / "weights.py",
                   HERE / "reference" / "quant.py"}
    assert HERE / "rank.py" in _benchmark_imports(HERE / "harness.py")
    assert "repro_torch" in _imports(HERE / "rank.py")
