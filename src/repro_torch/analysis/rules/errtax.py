"""CB4xx — error taxonomy (the reference's structured failure model).

Library code raises ``repro_torch.errors`` types (the reference's
reason codes and builtin bases) so every failure carries a
stable machine-matchable ``.code``; a bare ``ValueError("prose")``
reintroduces the untyped failures the fault-injection axis exists to
prevent. The taxonomy types subclass the historical builtins, so
switching a raise site never breaks an existing ``except ValueError``.

``errors.py`` itself is exempt (it defines the hierarchy).
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.context import FileContext
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import rule

_BARE_BUILTINS = ("ValueError", "RuntimeError")


@rule("CB401", "bare-builtin-raise",
      "library raises carry a reason code via repro_torch.errors types")
def check_bare_raise(ctx: FileContext) -> Iterator[Finding]:
    if ctx.path.rsplit("/", 1)[-1] == "errors.py":
        return
    for node in ctx.walk():
        if not isinstance(node, ast.Raise) or node.exc is None:
            continue
        exc = node.exc
        name = None
        if isinstance(exc, ast.Call) and isinstance(exc.func, ast.Name):
            name = exc.func.id
        elif isinstance(exc, ast.Name):
            name = exc.id
        if name in _BARE_BUILTINS:
            yield Finding(
                path=ctx.path, line=node.lineno, col=node.col_offset + 1,
                code="CB401",
                message=f"raises bare builtin {name}",
                hint="raise a repro_torch.errors type (InvalidArgError, "
                     "IngestError, ...) so the failure carries a .code",
            )
