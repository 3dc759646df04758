"""Analyzer engine: files -> rules -> suppressions -> baseline -> report.

One pass per file: parse (a syntax error is itself a ``CB002`` finding,
never a crash), run every registered checker, apply inline suppressions
(``# cblint: disable=CBxxx``), manufacture ``CB001 useless-suppression``
findings for pragmas that silence nothing, subtract the checked-in
baseline, and return a :class:`LintResult` whose JSON rendering is
byte-deterministic (sorted findings, sorted keys, no timestamps — two
runs over the same tree must produce identical bytes).
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os

from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis import registry
from repro_torch.analysis.context import FileContext
from repro_torch.analysis.findings import Finding

SCHEMA = "cblint/v1"

# Engine-emitted codes: never inline-suppressible (a pragma excusing the
# pragma-rot detector would make rot self-excusing, and a parse error
# has no trustworthy line table to suppress against).
_UNSUPPRESSABLE = frozenset(registry.ENGINE_CODES)


@dataclasses.dataclass
class LintResult:
    """Outcome of one analyzer run."""

    findings: list[Finding]          # after suppression + baseline
    files: int
    suppressed: int                  # pragma-silenced finding count
    baseline_used: list[dict]        # baseline entries that matched

    @property
    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.code] = out.get(f.code, 0) + 1
        return dict(sorted(out.items()))

    def to_json(self) -> str:
        payload = {
            "schema": SCHEMA,
            "files": self.files,
            "counts": self.counts,
            "suppressed": self.suppressed,
            "baseline_used": self.baseline_used,
            "findings": [f.to_dict() for f in sorted(self.findings)],
        }
        return json.dumps(payload, indent=1, sort_keys=True)


def iter_python_files(paths: list[str]) -> list[str]:
    """Expand files/directories into a sorted, deduplicated .py list."""
    out: set[str] = set()
    for path in paths:
        if os.path.isdir(path):
            for dirpath, dirnames, filenames in os.walk(path):
                dirnames.sort()
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__",)]
                for name in sorted(filenames):
                    if name.endswith(".py"):
                        out.add(os.path.join(dirpath, name))
        elif path.endswith(".py"):
            out.add(path)
    return sorted(out)


def _rel(path: str, root: str) -> str:
    rel = os.path.relpath(path, root)
    return rel.replace(os.sep, "/")


def lint_file(path: str, root: str) -> tuple[list[Finding], int]:
    """All raw findings for one file plus the pragma-silenced count."""
    rel = _rel(path, root)
    with open(path, "rb") as f:
        try:
            source = f.read().decode("utf-8")
        except UnicodeDecodeError as e:
            return [Finding(path=rel, line=1, col=1, code="CB002",
                            message=f"file is not valid UTF-8: {e.reason}",
                            hint="")], 0
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError as e:
        return [Finding(path=rel, line=int(e.lineno or 1),
                        col=int(e.offset or 1), code="CB002",
                        message=f"syntax error: {e.msg}",
                        hint="")], 0

    ctx = FileContext(rel, source, tree)
    raw: list[Finding] = []
    for rule in registry.all_rules():
        raw.extend(rule.checker(ctx))

    # line -> codes silenced there
    silenced: dict[int, set[str]] = {}
    for s in ctx.suppressions:
        silenced.setdefault(s.line, set()).update(s.codes)

    kept: list[Finding] = []
    fired: dict[int, set[str]] = {}
    n_suppressed = 0
    for f in raw:
        fired.setdefault(f.line, set()).add(f.code)
        if f.code not in _UNSUPPRESSABLE and \
                f.code in silenced.get(f.line, ()):
            n_suppressed += 1
        else:
            kept.append(f)

    known = registry.known_codes()
    for s in ctx.suppressions:
        for code in s.codes:
            if code not in known:
                kept.append(Finding(
                    path=rel, line=s.line, col=s.col, code="CB001",
                    message=f"suppression names unknown rule {code!r}",
                    hint="fix the code or delete the pragma"))
            elif code in _UNSUPPRESSABLE:
                kept.append(Finding(
                    path=rel, line=s.line, col=s.col, code="CB001",
                    message=f"{code} cannot be inline-suppressed",
                    hint="delete the pragma"))
            elif code not in fired.get(s.line, ()):
                kept.append(Finding(
                    path=rel, line=s.line, col=s.col, code="CB001",
                    message=f"useless suppression of {code} "
                            "(nothing fires on this line)",
                    hint="delete the stale pragma"))
    return kept, n_suppressed


def lint_paths(
    paths: list[str],
    *,
    root: str | None = None,
    baseline_path: str | None = None,
) -> LintResult:
    """Lint ``paths`` (files or directories) and return the result.

    ``root`` anchors the repo-relative paths in findings (defaults to
    the current directory). ``baseline_path`` points at a
    ``cblint-baseline/v1`` JSON file; missing means empty.
    ``record_lint_health`` publishes a result onto the obs registry.
    """
    root = root or os.getcwd()
    files = iter_python_files(paths)
    findings: list[Finding] = []
    suppressed = 0
    for path in files:
        got, n = lint_file(path, root)
        findings.extend(got)
        suppressed += n

    entries = baseline_mod.load_baseline(baseline_path) \
        if baseline_path else []
    fresh, used = baseline_mod.subtract_baseline(findings, entries)
    return LintResult(findings=sorted(fresh), files=len(files),
                      suppressed=suppressed, baseline_used=used)


def record_lint_health(result: LintResult) -> None:
    """Publish per-rule counts onto the obs registry as
    ``repro.analysis.findings`` gauges (the reference's names), so obs
    snapshots carry lint health.

    Gauges, not counters: a lint run reports the *current* state of the
    tree, and re-running must not accumulate. The ``rule="total"``
    series is always set (0 when clean) so snapshots prove the pass ran.
    """
    from repro_torch import obs

    gauge = obs.gauge("repro.analysis.findings")
    gauge.set(len(result.findings), rule="total")
    for code, n in result.counts.items():
        gauge.set(n, rule=code)
    obs.gauge("repro.analysis.files").set(result.files)
