"""A cell resolved from ``BENCHMARK.json``: its configuration, traffic mix,
cell file, metrics and the readers of its per-layer metrics, each found
by name under the benchmark's folder beside ``BENCHMARK.json``."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

HARNESS = "perfbench"


@dataclasses.dataclass
class Cell:
    root: str                 # the directory that holds BENCHMARK.json
    name: str
    chips: int
    config_name: str
    config_file: str          # absolute
    traffic_name: str
    traffic: dict             # traffic/<name>.json
    params: dict              # workloads/<cell>.json
    end_to_end: List[dict]    # BENCHMARK.json entries reported by this cell
    per_layer: List[dict]

    def harness_path(self, *parts: str) -> str:
        return os.path.join(self.root, HARNESS, *parts)

    def module(self, kind: str, name: str) -> ModuleType:
        """``<harness>/<kind>/<name>.py``, loaded by its path."""
        return load_module(self.harness_path(kind, name + ".py"),
                           f"{HARNESS}_{kind}_{name}".replace(".", "_")
                           .replace("-", "_"))


def load_module(path: str, name: str) -> ModuleType:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no module at {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(bench_path: str, cell_name: str) -> Cell:
    root = os.path.dirname(os.path.abspath(bench_path))
    bench = _json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no cell {cell_name!r} in {bench_path}; cells: "
                       f"{', '.join(cells)}")
    w = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = configs[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _reports(m, cell_name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell_name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(
        root=root, name=cell_name, chips=int(w["chips"]),
        config_name=config["name"],
        config_file=os.path.join(root, config["file"]),
        traffic_name=w["traffic"],
        traffic=_json(os.path.join(root, HARNESS, "traffic",
                                   w["traffic"] + ".json")),
        params=_json(os.path.join(root, HARNESS, "workloads",
                                  cell_name + ".json")),
        end_to_end=e2e, per_layer=per_layer)


def readers(cell: Cell) -> Dict[str, ModuleType]:
    """The reader module of each per-layer metric of the cell."""
    return {m["name"]: cell.module("metrics", m["name"])
            for m in cell.per_layer}
