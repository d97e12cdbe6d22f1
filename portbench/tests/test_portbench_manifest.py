"""BENCHMARK.json keeps to the contract's characters and shapes, every
cell, configuration, driver and metric it names resolves to its file,
and a new cell, configuration and metric are found by name with no
existing file edited."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from portbench.harness import cell as cellmod

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(MANIFEST)) <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert isinstance(MANIFEST["run_seconds"], int)


def test_command_and_paths():
    cmd, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(cmd) <= 32 and all(TEXT.match(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in paths)
            assert (ROOT / w).is_file()


def test_names_units_and_keys():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        names.append(("config", c["name"]))
    assert len(MANIFEST["workloads"]) <= 24
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        names.append(("cell", w["name"]))
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
        names.append(("metric", m["name"]))
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"]) and m["moves"] in e2e
        names.append(("metric", m["name"]))
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for kind in ("config", "cell", "metric"):
        got = [n for k, n in names if k == kind]
        assert len(got) == len(set(got)), kind


def test_every_cell_reports_what_its_metrics_move():
    cells = [w["name"] for w in MANIFEST["workloads"]]
    for name in cells:
        c = cellmod.load(name)
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert c.per_layer, name
        for m in c.per_layer:
            assert m["moves"] in reported, (name, m["name"])
    for m in MANIFEST["per_layer"]:
        for name in m.get("workloads", cells):
            assert name in cells


@pytest.mark.parametrize("name", [w["name"] for w in MANIFEST["workloads"]])
def test_each_cell_resolves_to_its_files(name):
    c = cellmod.load(name)
    assert c.config["name"] == c.entry["config"]
    assert callable(c.driver().run)
    for m in c.per_layer:
        assert callable(c.reader(m["name"]).read)
        assert c.reader(m["name"]).read(None) is None
    assert c.workload["limits"], "a cell without limits can never be correct"


def _digest(folder: Path):
    return {p.relative_to(folder).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest() for p in folder.rglob("*")
        if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(BENCH, base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(base)
    manifest = json.loads(json.dumps(MANIFEST))
    (base / "configs" / "tiny.json").write_text(json.dumps(
        {**json.loads((base / "configs" / "vqa2.json").read_text()),
         "name": "tiny"}))
    (base / "workloads" / "tiny.train.json").write_text(
        (base / "workloads" / "vqa2.train.json").read_text())
    (base / "metrics" / "tiny.steps.py").write_text(
        "def read(rec):\n    return None if not rec else rec['steps']\n")
    manifest["configs"].append({"name": "tiny", "source": "x",
                                "file": "portbench/configs/tiny.json",
                                "reduced": [], "why": "a test"})
    manifest["workloads"].append({"name": "tiny.train", "config": "tiny",
                                  "traffic": "train", "chips": 1,
                                  "why": "a test"})
    manifest["per_layer"].append({
        "name": "tiny.steps", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "loader", "moves": "setup_s",
        "workloads": ["tiny.train"]})
    c = cellmod.load("tiny.train", manifest, base=base)
    assert c.config["name"] == "tiny"
    assert [m["name"] for m in c.per_layer] == ["tiny.steps"]
    assert c.reader("tiny.steps").read({"steps": 7}) == 7
    assert c.driver().__file__ == str(base / "drivers" / "train.py")
    after = _digest(base)
    assert {k: v for k, v in after.items() if k in before} == before
