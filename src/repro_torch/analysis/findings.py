"""Finding: one lint diagnostic, stable and deterministically ordered.

A finding is a plain value object — ``(code, path, line, col, message,
hint)`` — so two analyzer runs over the same tree produce byte-identical
JSON (``tests/test_torch_lint.py`` asserts this). ``path`` is always
POSIX-style and repo-relative; line/col are 1-based like every compiler
diagnostic the shell understands (``file:line:col``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One diagnostic emitted by a rule.

    Ordering is ``(path, line, col, code, message)`` via field order, so
    ``sorted(findings)`` is the canonical report order.
    """

    path: str
    line: int
    col: int
    code: str
    message: str
    hint: str = ""

    def format(self) -> str:
        """Human one-liner: ``path:line:col: CBxxx message  [fix: ...]``."""
        text = f"{self.path}:{self.line}:{self.col}: {self.code} {self.message}"
        if self.hint:
            text += f"  [fix: {self.hint}]"
        return text

    def to_dict(self) -> dict:
        return {
            "code": self.code,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "hint": self.hint,
        }

    def baseline_key(self) -> tuple[str, str, str]:
        """Identity used for baseline matching.

        Deliberately excludes line/col so a baselined (grandfathered)
        finding survives unrelated edits above it in the file.
        """
        return (self.code, self.path, self.message)
