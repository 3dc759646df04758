"""Find everything a cell needs by name: its configuration, traffic mix,
limits, matrix generator, entry and metric readers."""
from __future__ import annotations

import importlib.util
import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]      # portbench/
ROOT = BENCH.parent                                       # the checkout
OUT = BENCH / "out"                                       # git-ignored outputs


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def by_name(items: list, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r}; known: {[i['name'] for i in items]}")


def module(kind: str, name: str):
    """The file ``portbench/<kind>/<name>.py``, imported under a private name."""
    path = BENCH / kind / f"{name}.py"
    key = f"_portbench_{kind}_{name.replace('.', '_').replace('-', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"{path} not found")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of BENCHMARK.json with everything found for it."""

    def __init__(self, bench: dict, name: str, config_override: dict | None = None):
        self.bench = bench
        self.workload = by_name(bench["workloads"], name, "workload")
        self.name = name
        cfg_entry = by_name(bench["configs"], self.workload["config"], "config")
        self.config = load_json(ROOT / cfg_entry["file"])
        if config_override:
            self.config = {**self.config, **config_override}
        self.traffic = load_json(BENCH / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(BENCH / "limits" / f"{name}.json")
        self.entry = module("entries", self.traffic["entry"])
        self.matrix_gen = module("matrices", self.config["matrix"])

    def end_to_end(self) -> list[dict]:
        """The end-to-end metrics of this cell: those without ``workloads`` are every cell's."""
        return [m for m in self.bench["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list[dict]:
        """The per-layer metrics whose ``workloads`` list this cell."""
        return [m for m in self.bench["per_layer"] if self.name in m["workloads"]]
