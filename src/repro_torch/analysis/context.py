"""Per-file analysis context: parsed AST plus the launch-path scopes.

``FileContext`` is what every rule checker receives. It owns the parse
(one ``ast.parse`` per file) and computes the map the host-sync rule
(CB211) needs:

  * :meth:`launch_scopes` — the function bodies that run each time the
    port launches work on the card: every function of ``kernels/ops.py``,
    of the kernel wrappers ``kernels/cb_*.py``, of ``sparse/linear.py`` and
    of ``solvers/_loop.py``; under ``models/`` each family's ``forward`` /
    ``decode_step`` and the layers they apply (``*_apply``, ``*_step``);
    the engine's ``_tick`` under ``serving/``; ``build_train_step`` and
    ``run_training`` under ``training/``; and, within a file, every
    function those call by name. This is the port's counterpart of the
    reference's trace scopes (``_*_jit`` entries and kernel bodies): a host
    sync there stalls the enqueue and breaks CUDA-graph capture.

Also home to the small AST helpers (``dotted_name``, ``root_name``) rules
use to match attribute chains without each reimplementing the descent.
"""
from __future__ import annotations

import ast
import dataclasses
import functools
import re
from typing import Iterator

from repro_torch.analysis.suppress import Suppression, parse_suppressions

# ---------------------------------------------------------------------------
# AST helpers
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for a pure Name/Attribute chain, else ``None``."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def root_name(node: ast.AST) -> str | None:
    """Base ``Name`` id of an attribute/call/subscript chain."""
    while True:
        if isinstance(node, ast.Attribute):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Name):
            return node.id
        else:
            return None


def is_tensor_annotation(node: ast.AST | None) -> bool:
    """``torch.Tensor`` / ``Tensor``, alone or in an ``X | None`` union."""
    if node is None:
        return False
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        return is_tensor_annotation(node.left) or is_tensor_annotation(node.right)
    return dotted_name(node) in ("torch.Tensor", "Tensor")


# ---------------------------------------------------------------------------
# launch-path scopes
# ---------------------------------------------------------------------------

# files whose every function is on a launch path (matched on the path's end)
_LAUNCH_FILES = re.compile(
    r"(^|/)(kernels/ops\.py|kernels/cb_[a-z0-9_]+\.py|sparse/linear\.py|solvers/_loop\.py)$")
# (directory, function-name pattern) of the launch-path roots elsewhere
_LAUNCH_ROOTS = (
    ("models/", re.compile(r"^(forward|decode_step|\w+_apply|\w+_step)$")),
    ("serving/", re.compile(r"^_tick$")),
    ("training/", re.compile(r"^(build_train_step|run_training)$")),
)

FunctionNode = ast.FunctionDef | ast.AsyncFunctionDef


@dataclasses.dataclass(frozen=True)
class LaunchScope:
    """One function whose body runs on a launch path."""

    node: FunctionNode
    tensors: frozenset[str]   # names annotated torch.Tensor in it

    def walk(self) -> Iterator[ast.AST]:
        """Every node in the body, nested functions included."""
        for stmt in self.node.body:
            yield from ast.walk(stmt)


def _tensor_names(fn: FunctionNode) -> frozenset[str]:
    """Parameters (of ``fn`` and the functions nested in it) and annotated
    assignments typed ``torch.Tensor``."""
    names = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            a = node.args
            names.update(p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)
                         if is_tensor_annotation(p.annotation))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name) \
                and is_tensor_annotation(node.annotation):
            names.add(node.target.id)
    return frozenset(names)


# ---------------------------------------------------------------------------
# FileContext
# ---------------------------------------------------------------------------


class FileContext:
    """Everything a rule needs to lint one file."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path          # repo-relative, POSIX separators
        self.source = source
        self.tree = tree
        self.suppressions: tuple[Suppression, ...] = parse_suppressions(source)

    # -- generic traversal ------------------------------------------------

    def walk(self) -> Iterator[ast.AST]:
        return ast.walk(self.tree)

    def functions(self) -> Iterator[FunctionNode]:
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node

    # -- launch-path classification ---------------------------------------

    @functools.cached_property
    def launch_scopes(self) -> tuple[LaunchScope, ...]:
        """The outermost functions on a launch path (nested ones ride along)."""
        fns = list(self.functions())
        if _LAUNCH_FILES.search(self.path):
            chosen = set(fns)
        else:
            chosen = set()
            for where, names in _LAUNCH_ROOTS:
                if where in self.path:
                    chosen.update(f for f in fns if names.match(f.name))
            # within the file, what a launch-path function calls by name
            by_name: dict[str, list[FunctionNode]] = {}
            for f in fns:
                by_name.setdefault(f.name, []).append(f)
            todo = list(chosen)
            while todo:
                for node in ast.walk(todo.pop()):
                    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                        for f in by_name.get(node.func.id, ()):
                            if f not in chosen:
                                chosen.add(f)
                                todo.append(f)
        nested = {inner for f in chosen for inner in ast.walk(f)
                  if inner is not f and inner in chosen}
        return tuple(LaunchScope(node=f, tensors=_tensor_names(f))
                     for f in sorted(chosen - nested, key=lambda f: (f.lineno, f.col_offset)))
