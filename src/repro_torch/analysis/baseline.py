"""Checked-in baseline: grandfathered findings the gate tolerates.

The baseline is a JSON file (``src/repro_torch/analysis/baseline.json``)
listing findings that predate a rule and are excused *by name* rather
than fixed. Matching is by ``(code, path, message)`` with multiset
semantics — one baseline entry excuses exactly one live finding — and
deliberately ignores line numbers so unrelated edits above a
grandfathered site don't un-excuse it.

Policy: the baseline for ``src/repro_torch`` is **empty** — every real
violation was fixed rather than grandfathered — and the gate in
``tests/test_torch_lint.py`` keeps it that way. The mechanism stays because a
future rule may land with violations too risky to fix in the same PR.
"""
from __future__ import annotations

import collections
import json
import os

from repro_torch import errors
from repro_torch.analysis.findings import Finding

SCHEMA = "cblint-baseline/v1"


def load_baseline(path: str) -> list[dict]:
    """Entries from ``path``; a missing file is an empty baseline."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) or data.get("schema") != SCHEMA:
        raise errors.SchemaError(
            f"{path}: expected {SCHEMA!r} baseline, got "
            f"{data.get('schema') if isinstance(data, dict) else type(data)}"
        )
    entries = data.get("findings", [])
    for e in entries:
        if not {"code", "path", "message"} <= set(e):
            raise errors.ArtifactError(
                f"{path}: baseline entry missing code/path/message: {e}"
            )
    return entries


def save_baseline(path: str, findings: list[Finding]) -> None:
    """Write ``findings`` as the new baseline (sorted, stable bytes)."""
    payload = {
        "schema": SCHEMA,
        "findings": [f.to_dict() for f in sorted(findings)],
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")


def subtract_baseline(
    findings: list[Finding], entries: list[dict]
) -> tuple[list[Finding], list[dict]]:
    """Split findings into (new, excused-entry list actually used).

    Returns the findings NOT covered by the baseline, plus the subset of
    entries that matched (callers can report stale entries as hygiene).
    """
    budget = collections.Counter(
        (e["code"], e["path"], e["message"]) for e in entries
    )
    fresh: list[Finding] = []
    used: collections.Counter = collections.Counter()
    for f in sorted(findings):
        key = f.baseline_key()
        if budget[key] > 0:
            budget[key] -= 1
            used[key] += 1
        else:
            fresh.append(f)
    used_entries = [
        {"code": c, "path": p, "message": m, "count": n}
        for (c, p, m), n in sorted(used.items())
    ]
    return fresh, used_entries
