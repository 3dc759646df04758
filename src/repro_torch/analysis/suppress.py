"""Inline suppressions: ``# cblint: disable=CB211[,CB301]``.

A suppression comment silences the named codes *on its own line* (the
pragma rides the offending statement, pylint-style). Suppressions are
themselves linted: a pragma naming an unknown code, or one that silences
nothing on that line, is a ``CB001 useless-suppression`` finding — so
stale pragmas can't rot in place after the code they excused is fixed.

``CB001`` itself cannot be inline-disabled (that would make rot
self-excusing); remove the dead pragma instead.
"""
from __future__ import annotations

import dataclasses
import io
import re
import tokenize

# Tolerate flexible spacing; the canonical spelling in docs is
#   "cblint: disable=CB211,CB301" behind a comment hash.
_PRAGMA_RE = re.compile(
    r"#\s*cblint:\s*disable\s*=\s*(?P<codes>[A-Za-z0-9_,\s]+)"
)


@dataclasses.dataclass(frozen=True)
class Suppression:
    """One pragma occurrence: the line it governs and the codes named."""

    line: int
    codes: tuple[str, ...]
    col: int


def parse_suppressions(source: str) -> tuple[Suppression, ...]:
    """Scan ``source`` for pragmas, one :class:`Suppression` per comment.

    Only real COMMENT tokens are considered (``tokenize``, not a text
    scan), so documentation that *mentions* the pragma syntax inside a
    docstring never registers as a suppression.
    """
    out = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _PRAGMA_RE.search(tok.string)
            if not m:
                continue
            codes = tuple(
                c.strip() for c in m.group("codes").split(",") if c.strip()
            )
            out.append(Suppression(line=tok.start[0], codes=codes,
                                   col=tok.start[1] + m.start() + 1))
    except (tokenize.TokenError, SyntaxError):
        # The engine reports unparseable files as CB002; no pragmas.
        return ()
    return tuple(out)
