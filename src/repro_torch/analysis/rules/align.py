"""CB3xx — kernel lane/sublane alignment, as in the reference.

``core/streams.py`` is the single home of the layout rule the port keeps
bit for bit (``src/repro_torch/core/streams.py``): ``LANE`` (= 128),
``SUBLANE`` (= 8), ``spmm_block_n`` (bn % 128 == 0), and
``group_size_for``. A magic ``128`` / ``8`` at a kernel call site
re-hardcodes the rule — it keeps working right up until someone changes
the one true constant (re-deriving them for Hopper is a measured step of
its own).

  * CB301: literal ``128``/``8`` as a ``block_n`` default or keyword
    argument anywhere in the tree.
  * CB302: literal ``128``/``8`` as the right operand of ``%`` or
    ``//`` inside ``kernels/`` — alignment arithmetic must spell
    ``LANE``/``SUBLANE``.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.context import FileContext
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import rule

_LANE_LITERALS = (128, 8)
_HINT = ("use core.streams.LANE / SUBLANE (or spmm_block_n / "
         "group_size_for) instead of the literal")


def _at(ctx: FileContext, node: ast.AST, code: str,
        message: str) -> Finding:
    return Finding(path=ctx.path, line=node.lineno, col=node.col_offset + 1,
                   code=code, message=message, hint=_HINT)


def _is_lane_literal(node: ast.AST) -> bool:
    return (isinstance(node, ast.Constant) and type(node.value) is int
            and node.value in _LANE_LITERALS)


@rule("CB301", "magic-block-n",
      "block_n is the SpMM lane width; only streams.LANE may spell it")
def check_block_n_literal(ctx: FileContext) -> Iterator[Finding]:
    for node in ctx.walk():
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            pos = [*a.posonlyargs, *a.args]
            pairs = list(zip(pos[len(pos) - len(a.defaults):], a.defaults))
            pairs += [(p, d) for p, d in zip(a.kwonlyargs, a.kw_defaults)
                      if d is not None]
            for p, default in pairs:
                if p.arg == "block_n" and _is_lane_literal(default):
                    yield _at(ctx, default, "CB301",
                              f"magic literal {default.value} as block_n "
                              f"default in {node.name}")
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg == "block_n" and _is_lane_literal(kw.value):
                    yield _at(ctx, kw.value, "CB301",
                              f"magic literal {kw.value.value} passed as "
                              "block_n=")


@rule("CB302", "kernel-magic-literal",
      "alignment arithmetic in kernels/ must use LANE/SUBLANE")
def check_kernel_modulo_literal(ctx: FileContext) -> Iterator[Finding]:
    if "kernels/" not in ctx.path:
        return
    for node in ctx.walk():
        if isinstance(node, ast.BinOp) and \
                isinstance(node.op, (ast.Mod, ast.FloorDiv)) and \
                _is_lane_literal(node.right) and \
                not isinstance(node.left, ast.Constant):
            op = "%" if isinstance(node.op, ast.Mod) else "//"
            yield _at(ctx, node, "CB302",
                      f"alignment arithmetic `{op} {node.right.value}` "
                      "with a magic literal")
