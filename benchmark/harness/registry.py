"""Finds each piece of a cell by its name.

  configs/<file named in BENCHMARK.json>   a deployment: its mesh (a kind of
                                           meshes/), its physics (a module
                                           of physics/), loads, material
  mixes/<traffic>.json                     a traffic mix: data naming one
                                           entry of entries/
  limits/<workload>.json                   the limit of each number compared
  meshes/<kind>.py                         a mesh generator
  physics/<physics>.py                     a problem's loads, Dirichlet set,
                                           plain reference and port call
  entries/<entry>.py                       one of the port's entry points:
                                           a unit of work and its number
  numbers/<number>.py                      a compared number and its control
  metrics/<metric>.py                      one reader per metric

Adding a cell, configuration, mix, mesh kind, physics, entry, number or
metric is new files and new entries in BENCHMARK.json; nothing here
changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]       # benchmark/
KINDS = ("meshes", "physics", "entries", "numbers", "metrics")
_loaded: dict = {}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def module(kind: str, name: str):
    """The module benchmark/<kind>/<name>.py, loaded once."""
    if kind not in KINDS:
        raise ValueError(f"kind={kind!r}: one of {KINDS}")
    key = (kind, name)
    if key not in _loaded:
        path = HERE / kind / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no {kind} module {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(
            f"benchmark_{kind}_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[key] = mod
    return _loaded[key]


class Cell:
    """One entry of BENCHMARK.json's workloads, with its files read."""

    def __init__(self, bench: dict, name: str, root: Path):
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        cfg = [c for c in bench["configs"]
               if c["name"] == self.workload["config"]][0]
        self.config = load_json(root / cfg["file"])
        traffic = self.workload["traffic"]
        self.mix = load_json(HERE / "mixes" / f"{traffic}.json")
        self.limits = load_json(HERE / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
