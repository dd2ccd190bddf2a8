"""BENCHMARK.json and the files it names."""

import json
import re

from benchmark import core
from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_keys_and_names(spec):
    assert set(spec) == TOP
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]] \
        + [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(m["name"] for m in spec["end_to_end"] + spec["per_layer"])) \
        == len(spec["end_to_end"]) + len(spec["per_layer"])
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in spec["end_to_end"] + spec["per_layer"])
    assert "setup_s" in {m["name"] for m in spec["end_to_end"]}
    assert all(0 < m["bound"] <= 0.25 for m in spec["end_to_end"])
    assert len(json.dumps(spec)) < 64 * 1024


def test_configs_and_traffic_files_exist(spec):
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}
    for c in spec["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith(tuple(spec["paths"]))
        cfg = json.loads(path.read_text())
        assert (ROOT / cfg["reference"]).is_file()
    for w in spec["workloads"]:
        cell, cfg, traffic = core.cell_files(spec, w["name"])
        assert (ROOT / "benchmark" / "drivers" / f"{traffic['driver']}.py").is_file()
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert set(traffic["limits"]) <= {"lp_gap", "mismatch", "score_drop"}


def test_every_metric_has_a_reader(spec):
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(core.reader(m["name"]))


def test_per_layer_metrics_move_what_their_cells_report(spec):
    for w in spec["workloads"]:
        got = core.cell_metrics(spec, w["name"])
        e2e = {m["name"] for m in got["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2 and got["per_layer"]
        assert all(m["moves"] in e2e for m in got["per_layer"])


def test_run_seconds_fit_a_full_check(spec):
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (spec["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200
