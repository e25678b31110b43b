"""``BENCHMARK.json`` keeps its format: its keys, names and
units, bounds, one file a configuration, and metric readers that declare
what the file says of them."""

import json
import re

import pytest

from bench.harness import catalog, load_reader
from conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = [m["name"] for m in METRICS]
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        got = [x["name"] for x in group]
        assert len(got) == len(set(got))
        assert all(NAME.match(n) for n in got), got
    assert len(names) == len(set(names))
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)


def test_end_to_end():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_configs_and_cells():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert all(k in data for k in c["reduced"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 for w in SPEC["workloads"])
    for text in [w["why"] for w in SPEC["workloads"]] + \
            [c["why"] for c in SPEC["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text
    assert set(catalog()) == {w["name"] for w in SPEC["workloads"]}


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_reader_declares_what_the_file_says(metric):
    r = load_reader(ROOT, metric["name"])
    assert r.UNIT == metric["unit"] and r.SOURCE == metric["source"]
    if metric in SPEC["per_layer"]:
        assert r.LAYER == metric["layer"] and r.MOVES == metric["moves"]
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        if metric["name"].endswith("_roofline"):
            assert metric["unit"] == "%"


def test_every_cell_reports_enough():
    for w in SPEC["workloads"]:
        e2e = [m for m in SPEC["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        per = [m for m in SPEC["per_layer"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert per
