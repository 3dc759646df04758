"""CB5xx — obs metric naming convention, as in the reference.

Registry instruments are named ``repro.<subsystem>.<metric>``; the port
keeps the reference's names (``repro_torch.obs``), so one snapshot reader
serves both packages, and off-convention names fragment the snapshot. Checked at every literal instrument
creation site: ``obs.counter("...")`` / ``registry().gauge("...")`` /
``reg.histogram("...")`` and the ``metric=`` of ``MirroredCounter``.
f-strings are validated on their static prefix, which must at least pin
the subsystem (``f"repro.serving.{name}"`` passes, ``f"{ns}.x"`` does
not).
"""
from __future__ import annotations

import ast
import re
from typing import Iterator

from repro_torch.analysis.context import FileContext, dotted_name
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import rule

_NAME_RE = re.compile(r"^repro(\.[a-z0-9_]+){2,}$")
_PREFIX_RE = re.compile(r"^repro\.[a-z0-9_]+\.")
_FACTORIES = ("counter", "gauge", "histogram")
_HINT = "name instruments repro.<subsystem>.<metric>, the reference's names"


def _at(ctx: FileContext, node: ast.AST, message: str) -> Finding:
    return Finding(path=ctx.path, line=node.lineno, col=node.col_offset + 1,
                   code="CB501", message=message, hint=_HINT)


def _check_name_node(ctx: FileContext, node: ast.AST) -> Finding | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        if not _NAME_RE.match(node.value):
            return _at(ctx, node,
                       f"instrument name {node.value!r} is off the "
                       "repro.<subsystem>.<metric> convention")
    elif isinstance(node, ast.JoinedStr):
        prefix = ""
        for part in node.values:
            if isinstance(part, ast.Constant):
                prefix += str(part.value)
            else:
                break
        if not _PREFIX_RE.match(prefix):
            return _at(ctx, node,
                       f"f-string instrument name must pin "
                       f"'repro.<subsystem>.' statically (prefix "
                       f"{prefix!r})")
    return None


@rule("CB501", "metric-name",
      "registry instrument names follow repro.<subsystem>.<metric>")
def check_metric_names(ctx: FileContext) -> Iterator[Finding]:
    for node in ctx.walk():
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _FACTORIES and node.args:
            found = _check_name_node(ctx, node.args[0])
            if found is not None:
                yield found
        callee = dotted_name(node.func)
        if callee and callee.rsplit(".", 1)[-1] == "MirroredCounter":
            for kw in node.keywords:
                if kw.arg == "metric" and kw.value is not None:
                    found = _check_name_node(ctx, kw.value)
                    if found is not None:
                        yield found
