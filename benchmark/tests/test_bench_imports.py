"""No module of the benchmark imports JAX or the JAX package, by whole
top-level name (the port's name begins with the JAX package's), and the
reference imports nothing of the program either."""

import ast

from conftest import ROOT

BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "pigeon_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def _modules(where):
    return [p for p in where.rglob("*.py") if "__pycache__" not in p.parts]


def test_no_jax_anywhere_in_the_benchmark():
    for path in _modules(BENCH):
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, (path, bad)


def test_the_port_is_not_mistaken_for_the_jax_package():
    # "pigeon_tpu_torch" begins with "pigeon_tpu": compared whole, it is
    # allowed where the program is driven
    names = set(_imports(BENCH / "program.py"))
    assert "pigeon_tpu_torch" in names and "pigeon_tpu" not in names


def test_reference_imports_nothing_of_the_program():
    for path in _modules(BENCH / "reference"):
        names = set(_imports(path))
        assert not names & (FORBIDDEN | {"pigeon_tpu_torch"}), path
        assert names <= {"__future__", "dataclasses", "math", "typing",
                         "numpy", "torch", "benchmark"}, (path, names)
        if "benchmark" in names:
            tree = ast.parse(path.read_text())
            for node in ast.walk(tree):
                if isinstance(node, ast.ImportFrom) and node.module \
                        and node.module.startswith("benchmark"):
                    assert node.module.startswith("benchmark.reference"), \
                        (path, node.module)
