"""BENCHMARK.json against the benchmark's contract, and every name it uses
found under portbench/."""
import json
import re

import pytest

from pb_common import BENCH, ROOT

B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "portbench/run.py"]
    assert B["paths"] == ["portbench"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs():
    assert 1 <= len(B["configs"]) <= 24
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert (BENCH / "matrices" / f"{cfg['matrix']}.py").exists()
        assert any(w["config"] == c["name"] for w in B["workloads"])


def test_workloads():
    names = [w["name"] for w in B["workloads"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "entries" / f"{traffic['entry']}.py").exists()
        assert (BENCH / "limits" / f"{w['name']}.json").exists()


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    cells = {w["name"] for w in B["workloads"]}
    e2e = {m["name"]: m for m in B["end_to_end"]}
    for m in B[kind]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        if kind == "end_to_end":
            assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
            assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
            assert m["moves"] in e2e and "\n" not in m["layer"]
            # the harness reads a per-layer metric in the cells its workloads list
            reporting = set(e2e[m["moves"]].get("workloads", cells))
            assert m["workloads"] and set(m["workloads"]) <= reporting
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in B["workloads"]:
        e2e = [m for m in B["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", []) for m in B["per_layer"])


def test_check_time_fits():
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (B["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
