"""BENCHMARK.json against its rules (keys, names, bounds, sources), every cell's files found by
name, a cell and a configuration with its own run kind and serving path added from files alone, and
names that do not resolve stopping before set-up."""

import hashlib
import json
import re
import shutil
import time

import pytest

from conftest import ROOT, SMALL
from port_bench import harness, serve

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
    assert callable(harness.load_kind(cell).run)
    if cell.mix["kind"] == "serve":
        path = serve.resolve_path(cell)
        assert callable(path.prepare) and callable(path.reference_frames)
        assert issubclass(path.Program, serve.Program)
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


def tree_digest(root):
    """A digest of the files under root, caches left out."""
    h = hashlib.sha256()
    for f in sorted(root.rglob("*")):
        if f.is_file() and not {"__pycache__", ".pytest_cache"} & set(f.parts):
            h.update(str(f.relative_to(root)).encode() + b"\0" + f.read_bytes())
    return h.hexdigest()


# A serving path of the test's own: the configuration's dense frame mirrored
# left to right, judged against the mirrored no-skip frame, so that only its
# own reference finds it correct.
MIRRORED = '''"""Serving path ``mirrored``: the dense frame mirrored left to right."""

import torch

from port_bench import serve
from port_bench.serve import prepare  # noqa: F401

KERNELS = {"mirror_kernel": serve.Kernel(lambda fields: 1.0, lambda fields, tiles, blocks: 1.0)}


class Program(serve.Program):
    kind = "mirrored"

    def dispatch(self, c):
        return torch.flip(super().dispatch(c), [1])

    def work(self):
        return [("mirror_kernel", "both", 1, 1)]


def reference_frames(st, frames, prec="fp32"):
    return [(torch.flip(img, [1]), torch.flip(u, [1]))
            for img, u in serve.no_skip_frames(st, frames, prec)]
'''

# A run kind of the test's own: a serving run whose line names the path it took.
NOTED = '''"""Run kind ``serve_noted``: the serving run, its line naming its path."""

from port_bench import harness, serve


def run(cell, seed, seconds, traced, device, t_proc, size=None, program=None):
    line = harness.load_named(cell.root, "kinds", "serve").run(cell, seed, seconds, traced, device,
                                                               t_proc, size, program)
    line["path"] = serve.path_name(cell.model, cell.mix)
    return line
'''


@pytest.fixture
def added(tmp_path):
    """A copy of the benchmark with a configuration, a mix of a new kind on a
    new path, the kind and the path, each a new file, and a workloads entry."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__", ".pytest_cache"))
    pb = tmp_path / "port_bench"
    model = json.loads((pb / "configs" / "dfa_head_torso.json").read_text())
    model["name"] = "dfa_head_torso_mirrored"
    (pb / "configs" / "dfa_head_torso_mirrored.json").write_text(json.dumps(model))
    shipped = json.loads((pb / "traffic" / "shipped_serve.json").read_text())
    mix = dict(shipped, kind="serve_noted", path="mirrored", render={"occ_sigma_thresh": 0.0})
    (pb / "traffic" / "mirrored_serve.json").write_text(json.dumps(mix))
    (pb / "kinds" / "serve_noted.py").write_text(NOTED)
    (pb / "paths" / "mirrored.py").write_text(MIRRORED)
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(BENCH["configs"][0], name="dfa_head_torso_mirrored",
                                 file="port_bench/configs/dfa_head_torso_mirrored.json"))
    bench["workloads"].append({"name": "head_torso.mirrored", "config": "dfa_head_torso_mirrored",
                               "traffic": "mirrored_serve", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "head_torso.shipped_serve" in m.get("workloads", []):
            m["workloads"].append("head_torso.mirrored")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def test_a_configuration_kind_and_path_added_from_files_alone(added):
    """The new kind and path resolve under the copy's root; a run at the small
    size is correct by the new path's own reference, and a fault planted in
    its program is not; the repository's benchmark files are untouched."""
    before = tree_digest(ROOT / "port_bench")
    cell = harness.load_cell(added, "head_torso.mirrored")
    assert cell.model["name"] == "dfa_head_torso_mirrored"
    kind, path = harness.load_kind(cell), serve.resolve_path(cell)
    assert kind.__file__ == str(added / "port_bench" / "kinds" / "serve_noted.py")
    assert path.__file__ == str(added / "port_bench" / "paths" / "mirrored.py")
    assert serve.work_flops("mirror_kernel", "both", 2) == 2 * 256 * 8

    r = harness.run(cell, 2 ** 31 + 31, 1.0, False, "cpu", time.perf_counter(), size=SMALL)
    assert r["path"] == "mirrored" and r["correct"], r["checks"]
    assert set(r["metrics"]) == {"fps", "frame_ms_p95", "setup_s"}

    class Unmirrored(path.Program):
        """A fault: the frame left unmirrored, as the dense path serves it."""

        def dispatch(self, c):
            return serve.Program.dispatch(self, c)

    r = harness.run(cell, 2 ** 31 + 31, 1.0, False, "cpu", time.perf_counter(), size=SMALL,
                    program=Unmirrored)
    assert not r["correct"], r["checks"]
    assert r["checks"]["err_p50"]["value"] > r["checks"]["err_p50"]["limit"], r["checks"]
    assert tree_digest(ROOT / "port_bench") == before


@pytest.mark.parametrize("case", ["unknown_kind", "unknown_path", "hierarchical_off_pairs"])
def test_a_name_that_does_not_resolve_stops_before_set_up(case, monkeypatch):
    """An unknown kind or path, and a hierarchical configuration off the pair
    path with no ``path``, stop before any weights are made, naming what was
    looked for."""
    name = "head_hier.pair_serve" if case == "hierarchical_off_pairs" else \
        "head_torso.shipped_serve"
    cell = harness.load_cell(ROOT, name)
    if case == "unknown_kind":
        cell.mix = dict(cell.mix, kind="no_such_kind")
        want = str(ROOT / "port_bench" / "kinds" / "no_such_kind.py")
    elif case == "unknown_path":
        cell.mix = dict(cell.mix, path="no_such_path")
        want = str(ROOT / "port_bench" / "paths" / "no_such_path.py")
    else:
        cell.mix = dict(cell.mix, render={"occ_pair_compaction": False})
        want = "no serving path; name one with `path`"

    def no_set_up(*args, **kwargs):
        raise AssertionError("set-up ran")

    monkeypatch.setattr(serve, "prepare", no_set_up)
    monkeypatch.setattr(serve, "make_weights", no_set_up)
    with pytest.raises(SystemExit) as stop:
        harness.run(cell, 1, 1.0, False, "cpu", time.perf_counter(), size=SMALL)
    assert want in str(stop.value), stop.value
