"""The port's tools (``scripts/explain_torch.py``, ``scripts/obs_report_torch.py``)
against the JAX repo's (``scripts/explain.py``, ``scripts/obs_report.py``), on
the CPU.

- ``repro_torch.obs._flat_streams``: the CSR, BSR and TileSpMV access streams
  bit-equal to ``benchmarks/formats.py``'s, and ``to_csr`` too, over
  ``matrices.corpus("small")``;
- ``explain_torch.main``: the report equal to ``explain.main``'s in
  ``features``, ``decision``, ``plan`` and ``locality``; its ``roofline``
  differs only in ``machine_balance`` (the H100's 67e12 / 3.35e12) and what
  follows from it;
- ``obs_report_torch.main``: a valid Chrome trace, the same spans, and the
  headline counters of ``obs_report.main`` after mapping ``impl="pallas"`` to
  ``"cuda"`` (as ``tests/test_torch_obs.py`` does). The reference's
  ``ops.spmv`` and plan-accounting series count its one trace of the solver
  loop, the port's every call, so those are held per call.

The reference tools are loaded from their files under private names: the JAX
tests import them by bare name from ``scripts/``.
"""
import collections
import importlib.util
import json
import pathlib
import types

import jax
import numpy as np
import pytest

from benchmarks import formats as jformats
from repro import obs as jobs
from repro_torch import obs as tobs
from repro_torch.data import matrices
from repro_torch.obs import _flat_streams
from torch_port import shared_snapshot, shared_spans

REPO = pathlib.Path(__file__).resolve().parents[1]
CORPUS = {spec.name: (r, c, v, shape) for spec, r, c, v, shape in matrices.corpus("small")}


def _script(name: str, as_name: str):
    spec = importlib.util.spec_from_file_location(as_name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return types.SimpleNamespace(ref_explain=_script("explain", "_ref_explain"),
                                 explain=_script("explain_torch", "_explain_torch"),
                                 ref_obs=_script("obs_report", "_ref_obs_report"),
                                 obs=_script("obs_report_torch", "_obs_report_torch"))


# ---------------------------------------------------------------------------
# the flat baselines' access streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CORPUS))
def test_flat_streams_are_the_benchmarks_bit_for_bit(name):
    r, c, v, shape = CORPUS[name]
    for a, b in zip(_flat_streams.to_csr(r, c, v, shape), jformats.to_csr(r, c, v, shape)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for fmt in ("csr", "bsr", "tile"):
        for vbytes in (4, 8):
            got, end = getattr(_flat_streams, f"access_stream_{fmt}")(r, c, v, shape,
                                                                      vbytes=vbytes)
            want, want_end = getattr(jformats, f"access_stream_{fmt}")(r, c, v, shape,
                                                                       vbytes=vbytes)
            want = np.asarray(want)
            assert end == want_end, (fmt, vbytes)
            assert got.dtype == want.dtype and np.array_equal(got, want), (fmt, vbytes)


def test_flat_streams_stay_private():
    """``repro_torch.obs`` exports nothing of the module, and does not import it."""
    public = {k: v for k, v in vars(tobs).items() if not k.startswith("_")}
    assert not [k for k, v in public.items()
                if getattr(v, "__module__", None) == _flat_streams.__name__]
    init = REPO / "src" / "repro_torch" / "obs" / "__init__.py"
    assert "_flat_streams" not in init.read_text()


# ---------------------------------------------------------------------------
# explain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("matrix", [None, "banded_256x256", "block_clustered_1024x1024"])
def test_explain_report_is_the_references_on_the_h100s_rates(tools, matrix, tmp_path, capsys):
    argv = ["--top-k", "3"] + ([] if matrix is None else ["--matrix", matrix])
    want = tools.ref_explain.main(argv)
    got = tools.explain.main(argv + ["--device", "cpu", "--json", str(tmp_path / "r.json")])
    assert json.loads((tmp_path / "r.json").read_text()) == json.loads(json.dumps(got))
    for key in ("schema", "matrix", "family", "shape", "nnz", "features", "decision", "plan",
                "locality"):
        assert got[key] == want[key], key
    assert {"cb", "csr", "bsr", "tile"} <= set(got["locality"])
    roof, ref = got["roofline"], want["roofline"]
    balance = 67e12 / 3.35e12
    assert roof["machine_balance"] == balance != ref["machine_balance"]
    for key in ("flops", "bytes_moved", "arith_intensity"):
        assert roof[key] == ref[key], key
    assert roof["bound"] == ("memory" if ref["arith_intensity"] < balance else "compute")
    assert roof["attainable_fraction_of_peak"] == min(1.0, ref["arith_intensity"] / balance)
    text = capsys.readouterr().out
    assert "cost-model ranking" in text and "machine balance 20.0" in text


# ---------------------------------------------------------------------------
# obs_report
# ---------------------------------------------------------------------------

def _series(snap: dict, name: str) -> dict:
    """{labels: value}, without the ``engine`` label: a per-process count of the
    engines built so far, which other tests in the same process move."""
    entry = snap.get(name) or {"series": []}
    return {tuple(sorted((k, v) for k, v in s["labels"].items() if k != "engine")): s["value"]
            for s in entry["series"]}


def _pallas_as_cuda(snap: dict) -> dict:
    return json.loads(json.dumps(snap).replace('"impl": "pallas"', '"impl": "cuda"'))


PER_RUN = ("repro.solvers.robust.attempts", "repro.solvers.robust.outcome",
           "repro.serving.ticks", "repro.serving.completed")
PER_CALL = ("repro.ops.spmv.launches", "repro.ops.spmv.steps", "repro.ops.spmv.padded_elems",
            "repro.autotune.exec.padded_elems", "repro.autotune.exec.steps")


def test_obs_report_matches_the_reference(tools, tmp_path, capsys):
    for o in (jobs, tobs):
        o.reset()
    # the reference counts its launches while JAX traces: an earlier run of the same
    # workload in this process (tests/test_obs.py's) would leave it nothing to trace
    jax.clear_caches()
    want = tools.ref_obs.main(["--out", str(tmp_path / "ref.trace.json")])
    got = tools.obs.main(["--out", str(tmp_path / "port.trace.json"), "--device", "cpu"])
    text = capsys.readouterr().out

    trace = json.loads((tmp_path / "port.trace.json").read_text())
    assert trace == got["trace"] and got["trace_path"] == str(tmp_path / "port.trace.json")
    for ev in trace["traceEvents"]:
        assert ev["ph"] == "X"
        assert isinstance(ev["ts"], (int, float)) and isinstance(ev["dur"], (int, float))
    names = collections.Counter(shared_spans(ev["name"] for ev in trace["traceEvents"]))
    assert names == collections.Counter(ev["name"] for ev in want["trace"]["traceEvents"])
    assert {"robust_solve", "serving.tick"} <= set(names)
    assert sorted((r["name"], r["count"]) for r in got["summary"]
                  if shared_spans([r["name"]])) == \
        sorted((r["name"], r["count"]) for r in want["summary"])

    snap, ref = shared_snapshot(got["snapshot"]), shared_snapshot(_pallas_as_cuda(want["snapshot"]))
    for name in PER_RUN:
        assert _series(snap, name) == _series(ref, name), name
    calls, ref_calls = _series(snap, "repro.ops.spmv.calls"), _series(ref, "repro.ops.spmv.calls")
    assert set(calls) == set(ref_calls) == {(("impl", "cuda"),)}
    n, n_ref = calls[(("impl", "cuda"),)], ref_calls[(("impl", "cuda"),)]
    for name in PER_CALL:
        mine, theirs = _series(snap, name), _series(ref, name)
        assert mine and set(mine) == set(theirs), name
        assert all(mine[k] * n_ref == theirs[k] * n for k in mine), name
    assert "repro.solvers.traces" in ref and "repro.solvers.traces" not in snap
    assert got["locality"] == want["locality"]
    assert got["solve"]["converged"] and got["solve"]["solver"] == "cg"
    assert got["operator"].plan.mode == "heuristic"      # plan="auto" on the CPU
    assert "plan accounting" in text and "modeled locality" in text
