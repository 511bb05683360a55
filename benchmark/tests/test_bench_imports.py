"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), nor the repository's tools; the plain reference imports nothing
of the program."""

import ast

import pytest

from bench_support import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "vipnerf_tpu", "tools"}


def imported_tops(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".", 1)[0]


SOURCES = sorted(p for p in BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax_and_no_tools(path):
    assert not set(imported_tops(path)) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES if p.parent.name == "reference"],
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not {t for t in imported_tops(path) if t.startswith("vipnerf")}
    assert set(imported_tops(path)) <= {"contextlib", "typing", "numpy", "torch", "reference", "math"}


def test_the_prefix_is_compared_whole():
    assert "vipnerf_tpu_torch".split(".", 1)[0] not in FORBIDDEN
