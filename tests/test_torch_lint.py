"""cblint for the port: gate + framework tests (marker: ``lint``).

The port of ``tests/test_lint.py``, over ``repro_torch.analysis``:

  * **repo gate** — the analyzer over ``src/repro_torch`` against the
    checked-in (empty) baseline reports nothing; the deliberate host reads
    on launch paths carry CB211 pragmas, each counted as suppressed.
  * **rule fixtures** — one positive + one negative file per rule under
    ``tests/fixtures/lint_torch/``: the positive fires its code, the
    negative is entirely clean, and the CLI (``python -m
    repro_torch.analysis``) exits 1 on every positive.
  * **framework** — suppression semantics (incl. CB001 rot detection),
    baseline multiset matching, byte-identical ``--json`` determinism, and
    the obs lint-health gauges.
  * **the kept rules** — on the reference's own fixtures
    (``tests/fixtures/lint/``) the port's engine finds what
    ``repro.analysis`` finds for CB001, CB002, CB301, CB302, CB401, CB501.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from repro import analysis as ref_analysis
from repro_torch import analysis, errors, obs
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.suppress import parse_suppressions

pytestmark = pytest.mark.lint

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO_ROOT, "tests", "fixtures", "lint_torch")
REF_FIXTURES = os.path.join(REPO_ROOT, "tests", "fixtures", "lint")
SRC_PORT = os.path.join(REPO_ROOT, "src", "repro_torch")
CLI = [sys.executable, "-m", "repro_torch.analysis"]
ENV = dict(os.environ, PYTHONPATH=os.pathsep.join(
    [os.path.join(REPO_ROOT, "src"), os.environ.get("PYTHONPATH", "")]))

# code -> fixture stem (CB302 and CB211 are scoped by path: kernels/, models/)
RULE_FIXTURES = {
    "CB001": "cb001",
    "CB002": "cb002",
    "CB111": "cb111",
    "CB112": "cb112",
    "CB211": "models/cb211",
    "CB301": "cb301",
    "CB302": "kernels/cb302",
    "CB401": "cb401",
    "CB501": "cb501",
}
# negatives beyond the one a rule: a kernel wrapper may load the library; truth
# tests and .to() calls that read no tensor's value on a launch path
EXTRA_NEGATIVES = ("kernels/cb_111_wrapper_neg", "models/cb211_truth_neg",
                   "models/cb211_to_cpu_neg")
# the rules the port keeps from the reference, with their reference fixtures
KEPT = {"CB001": "cb001", "CB002": "cb002", "CB301": "cb301",
        "CB302": "kernels/cb302", "CB401": "cb401", "CB501": "cb501"}
# the port's deliberate host reads on launch paths (each a CB211 pragma)
DELIBERATE_READS = {
    "src/repro_torch/kernels/cb_colagg.py",     # compact_panels: E, once per encoding
    "src/repro_torch/kernels/cb_combine.py",    # plan_combine: the host sort, at plan time
    "src/repro_torch/models/sharding.py",       # _staged: gloo takes CUDA tensors via the host
    "src/repro_torch/serving/engine.py",        # _tick: the argmax, read back once a tick
    "src/repro_torch/solvers/_loop.py",         # while_loop: the stop flag, counted
    "src/repro_torch/sparse/linear.py",         # cb_linear_init: the host prunes the weight
    "src/repro_torch/training/train_loop.py",   # run_training: the step, then log steps
}


def _fixture(stem: str, kind: str) -> str:
    return os.path.join(FIXTURES, f"{stem}_{kind}.py")


def _lint(paths, **kwargs):
    return analysis.lint_paths(paths, root=REPO_ROOT, **kwargs)


def _cli(*args: str) -> subprocess.CompletedProcess:
    return subprocess.run([*CLI, *args], capture_output=True, text=True, cwd=REPO_ROOT,
                          env=ENV)


# ---------------------------------------------------------------------------
# repo gate
# ---------------------------------------------------------------------------


def test_port_is_lint_clean():
    """Every port invariant holds across src/repro_torch (empty baseline)."""
    result = _lint([SRC_PORT], baseline_path=analysis.DEFAULT_BASELINE)
    report = "\n".join(f.format() for f in result.findings)
    assert not result.findings, f"cblint findings in src/repro_torch:\n{report}"


def test_deliberate_reads_are_the_pragmas():
    """Each CB211 pragma in the port silences a read that fires, and they sit
    where the deliberate reads are (eight lines in seven files)."""
    pragmas = {}
    for path in analysis.iter_python_files([SRC_PORT]):
        with open(path) as f:
            n = sum("CB211" in s.codes for s in parse_suppressions(f.read()))
        if n:
            pragmas[os.path.relpath(path, REPO_ROOT).replace(os.sep, "/")] = n
    assert set(pragmas) == DELIBERATE_READS
    assert _lint([SRC_PORT]).suppressed == sum(pragmas.values()) == 8


def test_checked_in_baseline_is_empty():
    entries = analysis.load_baseline(analysis.DEFAULT_BASELINE)
    assert entries == []


def test_every_rule_has_a_fixture():
    assert set(RULE_FIXTURES) == set(analysis.known_codes())


def test_the_jax_only_rules_are_replaced():
    codes = analysis.known_codes()
    assert not codes & {"CB101", "CB102", "CB103", "CB104", "CB201", "CB202", "CB203"}
    assert {"CB111", "CB112", "CB211"} <= codes


def test_analysis_is_stdlib_only():
    """Importing the linter pulls in neither torch nor the reference."""
    code = ("import sys, repro_torch.analysis as a; a.all_rules(); "
            "print(sorted(m for m in ('torch', 'numpy', 'repro', 'jax') if m in sys.modules))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=ENV, cwd=REPO_ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# per-rule fixtures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("code", sorted(RULE_FIXTURES))
def test_rule_fires_on_positive(code):
    result = _lint([_fixture(RULE_FIXTURES[code], "pos")])
    codes = {f.code for f in result.findings}
    assert code in codes, f"{code} did not fire; got {sorted(codes)}"


@pytest.mark.parametrize("stem", [f"{s}_neg" for s in sorted(RULE_FIXTURES.values())]
                         + list(EXTRA_NEGATIVES))
def test_rule_quiet_on_negative(stem):
    result = _lint([os.path.join(FIXTURES, f"{stem}.py")])
    report = "\n".join(f.format() for f in result.findings)
    assert not result.findings, f"negative fixture not clean:\n{report}"


def test_cb211_finds_each_kind_of_read():
    """Every form the rule names, on its line: casts of a tensor (a helper
    the launch path calls, an annotated local), synchronize, .item(),
    .tolist(), .cpu()."""
    result = _lint([_fixture("models/cb211", "pos")])
    got = sorted((f.line, f.message.split(" inside ")[0]) for f in result.findings)
    assert got == [(6, "float() of a tensor"), (12, "bool() of a tensor"),
                   (14, "int() of a tensor"), (15, "torch.cuda.synchronize()"),
                   (16, ".cpu()"), (16, ".item()"), (16, ".tolist()"),
                   (22, "bool() of a tensor")]


@pytest.mark.parametrize("stem,lines", [
    # if torch.any, while t, assert (chain through a torch call), ternary on a
    # comparison, both operands of `and`, not torch.equal, a comprehension's if
    ("models/cb211_truth", [6, 8, 10, 11, 12, 12, 13, 15]),
    ("models/cb211_to_cpu", [7, 8, 9]),          # positional, device=, torch.device
])
def test_cb211_finds_truth_tests_and_copies_to_the_host(stem, lines):
    """The reads that ``bool()`` and ``.cpu()`` spell implicitly: a tensor's
    truth in a test, and ``.to()`` of the CPU."""
    result = _lint([_fixture(stem, "pos")])
    assert sorted(f.line for f in result.findings) == lines
    assert {f.code for f in result.findings} == {"CB211"}


def test_cb211_is_scoped_to_launch_paths(tmp_path):
    """The same read fires in a launch-path file and not in a host module."""
    body = "import torch\n\n\ndef plan(x: torch.Tensor):\n    return x.cpu()\n"
    for rel, fires in (("kernels/ops.py", True), ("sparse/linear.py", True),
                       ("solvers/_loop.py", True), ("autotune/search.py", False),
                       ("models/sharding.py", False)):
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(body)
        codes = [f.code for f in analysis.lint_paths([str(path)], root=str(tmp_path)).findings]
        assert codes == (["CB211"] if fires else []), rel


@pytest.mark.parametrize("code", sorted(RULE_FIXTURES))
def test_cli_fails_on_injected_violation(code):
    proc = _cli(_fixture(RULE_FIXTURES[code], "pos"))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert code in proc.stdout


def test_cli_clean_exit_and_json():
    proc = _cli("--json", _fixture("cb401", "neg"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["schema"] == analysis.SCHEMA
    assert payload["findings"] == []
    assert payload["files"] == 1


def test_cli_default_is_the_port_and_bad_flags_exit_2():
    proc = _cli()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout and "8 suppressed" in proc.stdout
    assert _cli("--no-such-flag").returncode == 2


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------


def test_suppression_silences_named_code(tmp_path):
    path = tmp_path / "mod.py"
    path.write_text(
        "def f(x):\n"
        "    raise ValueError(x)  # cblint: disable=CB401\n"
    )
    result = analysis.lint_paths([str(path)], root=str(tmp_path))
    assert not result.findings
    assert result.suppressed == 1


def test_suppression_is_line_scoped(tmp_path):
    path = tmp_path / "mod.py"
    path.write_text(
        "def f(x):\n"
        "    # cblint: disable=CB401\n"
        "    raise ValueError(x)\n"
    )
    result = analysis.lint_paths([str(path)], root=str(tmp_path))
    codes = sorted(f.code for f in result.findings)
    # the raise still fires AND the off-line pragma is rot
    assert codes == ["CB001", "CB401"]


def test_suppression_reason_after_the_code(tmp_path):
    """``-- reason`` after the code names no second rule."""
    path = tmp_path / "models" / "m.py"
    path.parent.mkdir()
    path.write_text(
        "import torch\n\n\n"
        "def forward(x: torch.Tensor):\n"
        "    return x.item()  # cblint: disable=CB211 -- read on purpose\n"
    )
    result = analysis.lint_paths([str(path)], root=str(tmp_path))
    assert not result.findings and result.suppressed == 1


def test_cb001_not_inline_suppressible(tmp_path):
    path = tmp_path / "mod.py"
    path.write_text("x = 1  # cblint: disable=CB001\n")
    result = analysis.lint_paths([str(path)], root=str(tmp_path))
    assert [f.code for f in result.findings] == ["CB001"]
    assert "cannot be inline-suppressed" in result.findings[0].message


def test_docstring_mention_is_not_a_pragma(tmp_path):
    path = tmp_path / "mod.py"
    path.write_text('"""Docs showing `# cblint: disable=CB999`."""\nx = 1\n')
    result = analysis.lint_paths([str(path)], root=str(tmp_path))
    assert not result.findings


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------


def test_baseline_multiset_roundtrip(tmp_path):
    f1 = Finding(path="a.py", line=3, col=1, code="CB401", message="m")
    f2 = Finding(path="a.py", line=9, col=1, code="CB401", message="m")
    f3 = Finding(path="a.py", line=4, col=1, code="CB301", message="n")
    bl = tmp_path / "baseline.json"
    analysis.save_baseline(str(bl), [f1, f3])
    entries = analysis.load_baseline(str(bl))
    # one entry excuses exactly one of the two identical-message findings
    fresh, used = analysis.subtract_baseline([f1, f2, f3], entries)
    assert [f.line for f in fresh] == [9]
    assert sum(e["count"] for e in used) == 2
    # line drift does not un-excuse a baselined finding
    drifted = Finding(path="a.py", line=30, col=1, code="CB401", message="m")
    fresh, _ = analysis.subtract_baseline([drifted, f3], entries)
    assert fresh == []


def test_baseline_schema_rejected(tmp_path):
    bl = tmp_path / "baseline.json"
    bl.write_text('{"schema": "wrong/v0", "findings": []}')
    with pytest.raises(errors.SchemaError):
        analysis.load_baseline(str(bl))


def test_cli_update_baseline_then_clean(tmp_path, monkeypatch, capsys):
    """``--update-baseline`` rewrites the checked-in baseline, which the next
    run subtracts: here in process, with the baseline's path pointed at a
    temporary file."""
    bl = tmp_path / "baseline.json"
    monkeypatch.setattr(analysis, "DEFAULT_BASELINE", str(bl))
    pos = _fixture("cb112", "pos")
    assert cli_main(["--update-baseline", pos]) == 0
    assert "baselined 5 finding(s)" in capsys.readouterr().out
    assert cli_main([pos]) == 0
    assert "5 baselined" in capsys.readouterr().out
    assert analysis.lint_paths([pos], root=REPO_ROOT, baseline_path=str(bl)).findings == []


# ---------------------------------------------------------------------------
# determinism + obs
# ---------------------------------------------------------------------------


def test_json_report_is_byte_deterministic():
    a = _lint([SRC_PORT]).to_json()
    b = _lint([SRC_PORT]).to_json()
    assert a == b
    payload = json.loads(a)
    records = payload["findings"]
    keys = [(r["path"], r["line"], r["col"], r["code"]) for r in records]
    assert keys == sorted(keys)


def test_fixture_findings_sorted_and_deterministic():
    a = _lint([FIXTURES]).to_json()
    b = _lint([FIXTURES]).to_json()
    assert a == b
    counts = json.loads(a)["counts"]
    assert all(n > 0 for n in counts.values())
    assert set(counts) == set(RULE_FIXTURES)


def test_obs_lint_health_gauges():
    obs.reset()
    analysis.record_lint_health(_lint([_fixture("cb401", "pos")]))
    snap = obs.snapshot()
    series = snap["repro.analysis.findings"]["series"]
    by_rule = {s["labels"]["rule"]: s["value"] for s in series}
    assert by_rule["CB401"] == 2
    assert by_rule["total"] == 2
    assert snap["repro.analysis.files"]["series"][0]["value"] == 1
    obs.reset()


# ---------------------------------------------------------------------------
# the kept rules against the reference's engine, on the reference's fixtures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["pos", "neg"])
@pytest.mark.parametrize("code", sorted(KEPT))
def test_kept_rules_find_what_the_reference_finds(code, kind):
    path = os.path.join(REF_FIXTURES, f"{KEPT[code]}_{kind}.py")

    def found(engine):
        result = engine.lint_paths([path], root=REPO_ROOT)
        return [(f.path, f.line, f.col, f.code, f.message)
                for f in result.findings if f.code in KEPT]

    assert found(analysis) == found(ref_analysis)
    assert (code in {c for *_, c, _ in found(analysis)}) == (kind == "pos")
