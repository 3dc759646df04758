"""No file of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program. Names are compared whole, by
their top-level part: ``repro_torch`` is not ``repro``."""
import ast

import pytest

import pb_common
from pb_common import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
FILES = sorted(p for p in BENCH.rglob("*.py") if "out" not in p.relative_to(BENCH).parts)


def top_level_imports(source: str) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
            names.add(node.args[0].value.split(".", 1)[0])
    return names


def forbidden_for(path) -> set[str]:
    rel = path.relative_to(BENCH).parts
    return FORBIDDEN | ({"repro_torch", "harness", "entries"} if rel[0] == "reference" else set())


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(BENCH)) for p in FILES])
def test_file_imports_nothing_forbidden(path):
    found = top_level_imports(path.read_text()) & forbidden_for(path)
    assert not found, f"{path} imports {found}"


def test_the_comparison_is_by_whole_names():
    assert top_level_imports("import repro_torch.kernels\nfrom repro_torch import ops") == \
        {"repro_torch"}
    assert not top_level_imports("import repro_torch") & FORBIDDEN
    assert top_level_imports("from repro.core import x") & FORBIDDEN == {"repro"}
    assert top_level_imports("import jax.numpy as jnp") & FORBIDDEN == {"jax"}
    assert top_level_imports("import importlib\nimportlib.import_module('benchmarks.run')") \
        & FORBIDDEN == {"benchmarks"}


def test_every_directory_is_scanned():
    kinds = {p.relative_to(BENCH).parts[0] for p in FILES}
    assert {"reference", "entries", "metrics", "matrices", "harness", "tests"} <= kinds
