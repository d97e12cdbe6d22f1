"""A cell, found by its name: ``BENCHMARK.json`` at the checkout's root,
``portbench/workloads/<cell>.json`` (its configuration's name, its
driver, its traffic parameters and the limits of its comparison),
``portbench/configs/<config>.json`` (the model's sizes),
``portbench/drivers/<driver>.py`` and, for each per-layer metric,
``portbench/metrics/<metric>.py``. Adding a cell, a configuration or a
metric adds files and edits none."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def checked(name: str, what: str) -> str:
    if not NAME.match(name or ""):
        raise ValueError(f"bad {what} name {name!r}")
    return name


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict                 # the cell's entry in BENCHMARK.json
    workload: dict              # portbench/workloads/<cell>.json
    config: dict                # portbench/configs/<config>.json
    end_to_end: List[dict]      # metrics this cell reports, trace 0
    per_layer: List[dict]       # metrics this cell reports, trace 1
    base: Path = BENCH          # the folder the files are found in

    @property
    def model(self) -> dict:
        return self.config["model"]

    def driver(self):
        d = checked(self.workload["driver"], "driver")
        return _module(self.base / "drivers" / f"{d}.py",
                       f"portbench_driver_{d}")

    def reader(self, metric: str):
        return _module(self.base / "metrics" / f"{checked(metric, 'metric')}.py",
                       f"portbench_metric_{metric}")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, manifest: Optional[dict] = None,
         overrides: Optional[Dict[str, dict]] = None,
         base: Path = BENCH) -> Cell:
    """The cell ``name``. ``overrides`` ({"model": {...}, "data": {...},
    "workload": {...}}) replaces entries, for runs at small sizes in
    tests; ``base`` is the benchmark's folder (``manifest`` defaults to
    the BENCHMARK.json beside it)."""
    checked(name, "cell")
    bench = (manifest if manifest is not None
             else _json(base.parent / "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    workload = _json(base / "workloads" / f"{name}.json")
    config = _json(base / "configs"
                   / f"{checked(entry['config'], 'config')}.json")
    if overrides:
        config = {**config, "model": {**config["model"],
                                      **overrides.get("model", {})},
                  "data": {**config["data"], **overrides.get("data", {})}}
        workload = {**workload, **overrides.get("workload", {})}
    return Cell(name, entry, workload, config,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)], base)
