"""CB2xx — no host sync on a launch path, in place of the reference's
trace-safety rules (CB201-203: there is no tracing here).

Each call the port makes on a launch path (``FileContext.launch_scopes``)
only enqueues work on the card; a read of a device value makes the host
wait for the device there, stalls the enqueue of what follows, and makes
the path impossible to capture in a CUDA graph. CB211 flags:

  * ``.item()``, ``.tolist()`` and ``.cpu()``, and ``.to()`` of the CPU
    (``.to("cpu")``, ``.to(device="cpu")``, ``.to(torch.device("cpu"))``);
  * ``torch.cuda.synchronize(...)``;
  * ``float()`` / ``int()`` / ``bool()`` of a tensor: of a name annotated
    ``torch.Tensor`` in the function (a parameter or an annotated
    assignment), of an expression on such a name other than its metadata
    (``.shape``, ``.numel()``, ...), or of what a ``torch.*`` call returns
    other than a host value (``torch.is_*``, ``torch.finfo``, ...);
  * the truth value of a tensor, which is ``bool()`` spelled implicitly: a
    tensor (or a comparison of one, ``is`` / ``in`` aside) as the test of
    ``if``, ``while``, ``assert``, a conditional expression or a
    comprehension's ``if``, as an operand of ``and`` / ``or``, or under
    ``not``.

A read that is meant — the solver loop's stop flag every few iterations,
the engine tick's argmax, the train loop's log-step metrics — carries a
line pragma naming CB211, so that each one stays visible.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.context import FileContext, dotted_name
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import rule

_READS = ("item", "tolist", "cpu")
_CASTS = ("float", "int", "bool")
# torch.* calls that answer on the host (torch.is_tensor, torch.is_grad_enabled, ...)
_PREDICATES = ("is_", "are_", "has_")
# torch.* calls that make host objects, not tensors
_HOST_CALLS = frozenset({"finfo", "iinfo", "Size", "device", "dtype", "Generator",
                         "get_default_dtype", "promote_types", "result_type"})
# comparisons that test identity or membership, not a tensor's value
_IDENTITY = (ast.Is, ast.IsNot, ast.In, ast.NotIn)
# tensor attributes and methods that are host metadata, not device values
_METADATA = frozenset({
    "shape", "ndim", "dim", "numel", "size", "element_size", "dtype", "device",
    "is_cuda", "stride", "nbytes", "itemsize", "data_ptr", "is_contiguous",
})
_HINT = ("keep the value on the device; if the read is meant, mark the line "
         "with a CB211 pragma")


def _at(ctx: FileContext, node: ast.AST, message: str) -> Finding:
    return Finding(path=ctx.path, line=node.lineno, col=node.col_offset + 1,
                   code="CB211", message=message, hint=_HINT)


def _touches_metadata(node: ast.AST) -> bool:
    while isinstance(node, (ast.Attribute, ast.Call, ast.Subscript)):
        if isinstance(node, ast.Attribute) and node.attr in _METADATA:
            return True
        node = node.func if isinstance(node, ast.Call) else node.value
    return False


def _is_tensor_expr(node: ast.AST, tensors: frozenset[str]) -> bool:
    """Whether ``node`` is a tensor's value: a chain of attributes, calls and
    subscripts that reaches no metadata and starts from a name annotated
    ``torch.Tensor`` or passes through a ``torch.*`` call that makes one."""
    if _touches_metadata(node):
        return False
    while True:
        if isinstance(node, ast.Call):
            callee = dotted_name(node.func) or ""
            if callee.startswith("torch.") and not callee.startswith("torch.cuda."):
                last = callee.rsplit(".", 1)[-1]
                return not (last.startswith(_PREDICATES) or last in _HOST_CALLS)
            node = node.func
        elif isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
        else:
            return isinstance(node, ast.Name) and node.id in tensors


def _is_tensor_truth(node: ast.AST, tensors: frozenset[str]) -> bool:
    """Whether testing ``node``'s truth reads a tensor's value. ``and`` /
    ``or`` / ``not`` are skipped here: their operands are tested apart."""
    if isinstance(node, ast.Compare):
        if all(isinstance(op, _IDENTITY) for op in node.ops):
            return False
        return any(_is_tensor_expr(o, tensors) for o in (node.left, *node.comparators))
    return _is_tensor_expr(node, tensors)


def _truth_tests(node: ast.AST) -> tuple[ast.AST, ...]:
    """The expressions whose truth ``node`` tests."""
    if isinstance(node, (ast.If, ast.While, ast.Assert, ast.IfExp)):
        return (node.test,)
    if isinstance(node, ast.comprehension):
        return tuple(node.ifs)
    if isinstance(node, ast.BoolOp):
        return tuple(node.values)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
        return (node.operand,)
    return ()


def _is_cpu(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] == "cpu"
    return (isinstance(node, ast.Call) and dotted_name(node.func) == "torch.device"
            and len(node.args) >= 1 and _is_cpu(node.args[0]))


def _to_cpu(node: ast.Call) -> bool:
    """``x.to("cpu")``, ``x.to(device="cpu")``, ``x.to(torch.device("cpu"))``."""
    if not (isinstance(node.func, ast.Attribute) and node.func.attr == "to"):
        return False
    return (bool(node.args) and _is_cpu(node.args[0])) or \
        any(k.arg == "device" and _is_cpu(k.value) for k in node.keywords)


@rule("CB211", "launch-host-sync",
      "no device-to-host read (.item, .tolist, .cpu, .to('cpu'), float/int/bool "
      "or the truth value of a tensor, synchronize) on a launch path")
def check_launch_host_sync(ctx: FileContext) -> Iterator[Finding]:
    for scope in ctx.launch_scopes:
        where = f"launch path {scope.node.name!r}"
        for node in scope.walk():
            for test in _truth_tests(node):
                if _is_tensor_truth(test, scope.tensors):
                    yield _at(ctx, test, f"truth value of a tensor inside {where}")
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr in _READS and not node.args:
                yield _at(ctx, node, f".{func.attr}() inside {where}")
            elif _to_cpu(node):
                yield _at(ctx, node, f".to() of the CPU inside {where}")
            elif dotted_name(func) == "torch.cuda.synchronize":
                yield _at(ctx, node, f"torch.cuda.synchronize() inside {where}")
            elif isinstance(func, ast.Name) and func.id in _CASTS and \
                    len(node.args) == 1 and _is_tensor_expr(node.args[0], scope.tensors):
                yield _at(ctx, node, f"{func.id}() of a tensor inside {where}")
