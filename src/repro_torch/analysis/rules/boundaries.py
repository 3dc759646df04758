"""CB1xx — the port's boundaries, in place of the reference's compat-only rules.

The reference funnels every JAX-version-drifting spelling through
``compat.py`` (CB101-104). The port has no JAX; its boundaries are these:

  * CB111: ``ctypes`` and ``_build.library()`` — the kernel library's raw
    entry points — appear only in ``kernels/_build.py`` (which builds and
    loads the library) and the kernel wrappers ``kernels/cb_*.py`` (each
    checks its tensors, launches under ``_build.launch_on`` and counts the
    launch). Anything else goes through a wrapper, so every launch is
    checked and counted.
  * CB112: no ``jax`` / ``jaxlib`` / ``flax`` / ``optax`` import and no
    import of the reference package ``repro``: the port is a second
    package, not a wrapper of the first (the rule form of
    ``tests/test_torch_core.py::test_port_imports_neither_jax_nor_repro``).
"""
from __future__ import annotations

import ast
import re
from typing import Iterator

from repro_torch.analysis.context import FileContext, dotted_name
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import rule

_KERNEL_BOUNDARY = re.compile(r"(^|/)kernels/(_build|cb_[a-z0-9_]+)\.py$")
_BANNED_ROOTS = ("jax", "jaxlib", "flax", "optax", "repro")


def _at(ctx: FileContext, node: ast.AST, code: str, message: str,
        hint: str) -> Finding:
    return Finding(path=ctx.path, line=node.lineno, col=node.col_offset + 1,
                   code=code, message=message, hint=hint)


@rule("CB111", "kernel-library-boundary",
      "ctypes and _build.library() only in kernels/_build.py and the kernel wrappers")
def check_kernel_boundary(ctx: FileContext) -> Iterator[Finding]:
    if _KERNEL_BOUNDARY.search(ctx.path):
        return
    hint = "call the kernel's wrapper (kernels/cb_*.py) or kernels.ops"
    for node in ctx.walk():
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] == "ctypes":
                    yield _at(ctx, node, "CB111",
                              "imports ctypes outside the kernel wrappers", hint)
        elif isinstance(node, ast.ImportFrom):
            if node.module and node.module.split(".")[0] == "ctypes":
                yield _at(ctx, node, "CB111",
                          "imports from ctypes outside the kernel wrappers", hint)
            elif any(a.name == "library" for a in node.names) and \
                    (node.module or "").rsplit(".", 1)[-1] == "_build":
                yield _at(ctx, node, "CB111",
                          "imports _build.library outside the kernel wrappers", hint)
        elif isinstance(node, ast.Call):
            callee = dotted_name(node.func) or ""
            if callee == "_build.library" or callee.endswith("._build.library"):
                yield _at(ctx, node, "CB111",
                          "calls _build.library() outside the kernel wrappers", hint)


@rule("CB112", "port-imports-reference",
      "the port imports neither JAX nor the reference package repro")
def check_port_imports(ctx: FileContext) -> Iterator[Finding]:
    hint = "re-write what the port needs in repro_torch; only tests import both"
    for node in ctx.walk():
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots = [node.module.split(".")[0]]
        else:
            continue
        for root in roots:
            if root in _BANNED_ROOTS:
                yield _at(ctx, node, "CB112", f"imports {root}", hint)
