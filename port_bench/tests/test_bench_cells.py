"""BENCHMARK.json against its rules (keys, names, bounds, sources), every cell's files found by name, and a
cell added from files alone."""

import json
import re
import shutil

import pytest

from conftest import ROOT
from port_bench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_names_and_bounds():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in BENCH["configs"] + BENCH["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names)) and len(CELLS) == len(set(CELLS))
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) == 0
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_per_layer_metrics_name_cells_that_report_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                     "program_counter", "host_clock")
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in e2e[m["moves"]].get("workloads", CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    cell = harness.load_cell(ROOT, name)
    assert cell.mix["kind"] in harness.RUNS
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.load_reader(ROOT, m["name"]))


def test_every_configuration_is_used_and_lies_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert used == {c["name"] for c in BENCH["configs"]} and len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("port_bench/") and (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]


def test_a_cell_added_from_files_alone(tmp_path):
    """A new mix, a new metric reader and a new workloads entry: the harness
    finds all three without an edit to a file it has."""
    shutil.copytree(ROOT / "port_bench" / "configs", tmp_path / "port_bench" / "configs")
    shutil.copytree(ROOT / "port_bench" / "traffic", tmp_path / "port_bench" / "traffic")
    shutil.copytree(ROOT / "port_bench" / "metrics", tmp_path / "port_bench" / "metrics")
    mix = json.loads((ROOT / "port_bench" / "traffic" / "shipped_serve.json").read_text())
    mix["render"]["occ_refresh_every"] = 8
    (tmp_path / "port_bench" / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (tmp_path / "port_bench" / "metrics" / "dummy_metric.py").write_text(
        "def read(run):\n    return len(run.frames)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "head_torso.dummy", "config": "dfa_head_torso",
                               "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "head_torso.shipped_serve" in m["workloads"]:
            m["workloads"].append("head_torso.dummy")
    bench["per_layer"].append({"name": "dummy_metric", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "serving loop",
                               "moves": "fps", "workloads": ["head_torso.dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell(tmp_path, "head_torso.dummy")
    assert cell.mix["render"]["occ_refresh_every"] == 8
    assert [m["name"] for m in cell.per_layer] == ["dummy_metric"]
    assert {m["name"] for m in cell.end_to_end} >= {"fps", "setup_s"}
    read = harness.load_reader(tmp_path, "dummy_metric")
    assert read(type("Run", (), {"frames": [1, 2, 3]})) == 3
