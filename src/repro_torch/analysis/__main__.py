"""cblint CLI for the port — run the repo-invariant static analysis.

    python -m repro_torch.analysis [PATH ...]      # default: src/repro_torch
    python -m repro_torch.analysis --json          # machine-readable report
    python -m repro_torch.analysis --changed       # only git-modified files
    python -m repro_torch.analysis --update-baseline   # grandfather current hits

Exit status: 0 clean, 1 findings, 2 bad invocation. Human output is one
``path:line:col: CBxxx message  [fix: hint]`` line per finding; the
``--json`` report is byte-deterministic (sorted findings, no
timestamps). Paths in findings are relative to the repository root (the
directory above ``src/``). Rule catalog: ``repro_torch.analysis``'s
docstring.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

from repro_torch import analysis

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def _changed_files(paths: list[str]) -> list[str]:
    """git-modified + untracked .py files under ``paths``."""
    def git(*args: str) -> list[str]:
        out = subprocess.run(
            ["git", *args], cwd=_REPO_ROOT, check=True,
            capture_output=True, text=True,
        ).stdout
        return [line for line in out.splitlines() if line.strip()]

    candidates = set(git("diff", "--name-only", "HEAD"))
    candidates.update(git("ls-files", "--others", "--exclude-standard"))
    roots = [os.path.normpath(os.path.abspath(p)) for p in paths]
    chosen = []
    for rel in sorted(candidates):
        if not rel.endswith(".py"):
            continue
        full = os.path.normpath(os.path.join(_REPO_ROOT, rel))
        if any(full == r or full.startswith(r + os.sep) for r in roots):
            if os.path.exists(full):
                chosen.append(full)
    return chosen


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to lint (default: src/repro_torch)")
    ap.add_argument("--json", action="store_true",
                    help="emit the deterministic JSON report")
    ap.add_argument("--changed", action="store_true",
                    help="lint only git-modified/untracked files under "
                         "the given paths")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to excuse every current "
                         "finding, then exit 0")
    args = ap.parse_args(argv)

    paths = args.paths or [os.path.join(_REPO_ROOT, "src", "repro_torch")]
    if args.changed:
        paths = _changed_files(paths)
        if not paths:
            if not args.json:
                print("cblint: no changed python files")
            return 0

    if args.update_baseline:
        result = analysis.lint_paths(paths, root=_REPO_ROOT,
                                     baseline_path=None)
        analysis.save_baseline(analysis.DEFAULT_BASELINE, result.findings)
        print(f"cblint: baselined {len(result.findings)} finding(s) "
              f"-> {os.path.relpath(analysis.DEFAULT_BASELINE, _REPO_ROOT)}")
        return 0

    result = analysis.lint_paths(paths, root=_REPO_ROOT,
                                 baseline_path=analysis.DEFAULT_BASELINE)

    if args.json:
        print(result.to_json())
    else:
        for finding in result.findings:
            print(finding.format())
        tail = (f"cblint: {len(result.findings)} finding(s) in "
                f"{result.files} file(s)")
        if result.suppressed:
            tail += f", {result.suppressed} suppressed"
        if result.baseline_used:
            tail += f", {sum(e['count'] for e in result.baseline_used)} " \
                    "baselined"
        print(tail)
    return 1 if result.findings else 0


if __name__ == "__main__":
    sys.exit(main())
