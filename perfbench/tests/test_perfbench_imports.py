"""The import rule: the reference imports nothing of the JAX package nor
of the program, and no file of the benchmark imports the JAX package;
top-level names compared whole."""

import ast

import pytest

from perfbench import harness
from perfbench.tests.tiny import BENCH

JAX = {"jax", "jaxlib", "flax", "fast_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_neither_jax_nor_the_program(path):
    assert not set(_imports(path)) & (JAX | {"fast_tpu_torch"})


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax(path):
    assert not set(_imports(path)) & JAX


def test_forbidden_modules_by_whole_top_level_name():
    mods = ["fast_tpu_torch", "fast_tpu_torch.engine", "fast_tpu.engine",
            "jax", "jaxlib.xla", "flax", "jaxtyping", "numpy"]
    assert harness.forbidden_modules(mods) == [
        "fast_tpu.engine", "flax", "jax", "jaxlib.xla"]
