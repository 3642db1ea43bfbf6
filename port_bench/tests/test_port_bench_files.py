"""``BENCHMARK.json`` and the files it names read as the harness reads them: names and units
of the allowed characters, every cell's metrics readable, every per-layer metric's ``moves``
reported where it is, every configuration used, every file where its name puts it."""

import json
import re
from pathlib import Path

import pytest

from port_bench import harness
from port_bench.reference import layout

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_units_and_text(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] \
                and "\t" not in entry[key]


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_configuration_files(entry):
    path = ROOT / entry["file"]
    assert path.parent == ROOT / "port_bench" / "configs"
    config = json.loads(path.read_text())
    assert config["name"] == entry["name"] and config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"] == []
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    # the shapes a run draws are those the reference reads
    assert layout.count(layout.mmdit_entries(config["model"])) > 2e9


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_files(entry):
    cell = json.loads(harness.cell_file(entry["name"]).read_text())
    for key in ("name", "config", "traffic", "chips", "why"):
        assert cell[key] == entry[key]
    assert entry["chips"] == 1
    assert (ROOT / "port_bench" / "traffic" / f"{cell['traffic']}.py").exists()
    assert cell["check"]["limits"]
    assert cell["params"]["text_scale"] > 0  # the two CFG rows of a request differ
    for trace in (False, True):
        names = harness.metric_names(BENCH, entry["name"], trace)
        assert names
        for n in names:
            assert (ROOT / "port_bench" / "metrics" / f"{n}.py").exists(), n
    assert "setup_s" in harness.metric_names(BENCH, entry["name"], False)


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_is_reported_where_it_is(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS
        assert metric["name"] in harness.metric_names(BENCH, cell, True)
        assert metric["moves"] in harness.metric_names(BENCH, cell, False)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / "port_bench").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        assert re.match(r"^[A-Za-z0-9_.-]+$", p.name), p
