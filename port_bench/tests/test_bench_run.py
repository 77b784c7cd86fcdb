"""Whole runs on the CPU at a small size: the result line a run prints, the
control (the reference in float8 products put in the program's place) and
the fault a serving cell can have each coming out as not correct, the
refusal without a card, and a run that loads neither JAX nor the JAX
package. The two mixes that wait outside BENCHMARK.json (the live path and
training, see PERF.md) still run, and the training faults read as the
check needs them to. On the card (marked ``card``): the control at the
cells' own size."""

import json
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT, SMALL, SMALL_HIER
from port_bench import control, harness, serve, train

SERVING = ["head_torso.shipped_serve", "head_hier.pair_serve"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def waiting_cell(name, config, mix, e2e):
    """A cell of a mix that BENCHMARK.json does not list yet."""
    model = json.loads((ROOT / "port_bench" / "configs" / f"{config}.json").read_text())
    mix = json.loads((ROOT / "port_bench" / "traffic" / f"{mix}.json").read_text())
    return harness.Cell(name, 1, model, mix, [{"name": n, "unit": "1"} for n in e2e], [])


LIVE = ("head_torso.live", "dfa_head_torso", "live", ["fps", "frame_ms_p95", "setup_s"])
TRAIN = ("head_torso.train", "dfa_head_torso", "train", ["train_rays_per_s", "setup_s"])


def small(name):
    return SMALL_HIER if name == "head_hier.pair_serve" else SMALL


def cell(name):
    return harness.load_cell(ROOT, name)


def check_line(r, e2e):
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert set(r["metrics"]) == e2e
    assert r["attempted"] > 0 and r["failed"] == 0
    json.loads(json.dumps(r))
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("name", SERVING)
def test_serving_run_is_correct_and_prints_the_result_keys(name):
    r = harness.run(cell(name), 2 ** 31 + 7, 1.0, False, "cpu", time.perf_counter(),
                          size=small(name))
    check_line(r, {"fps", "frame_ms_p95", "setup_s"})
    assert r["correct"], r["checks"]


def test_the_live_mix_runs():
    r = harness.run(waiting_cell(*LIVE), 2 ** 31 + 7, 1.0, False, "cpu",
                          time.perf_counter(), size=SMALL)
    check_line(r, set(LIVE[3]))


@pytest.mark.parametrize("name", SERVING)
def test_control_reads_far_above_the_program(name):
    """The plain reference in float8 e4m3 products in the program's place
    reads at least three times the program's numbers at the small size; the
    card test holds both against the cell's limits at its own size."""
    r = control.readings(cell(name), 2 ** 31 + 11, 1.0, torch.device("cpu"), small(name))
    for k in ("err_p50", "tile_excess"):
        assert r["control"][k] >= 3 * r["program"][k], r


class AlteredAnswer(serve.Program):
    """A fault: each frame is altered where it is produced."""

    def dispatch(self, c):
        img = super().dispatch(c)
        return img + 0.01 * (torch.arange(img.shape[-1]) == 1).to(img.dtype)


def test_an_altered_answer_is_not_correct():
    name = "head_torso.shipped_serve"
    r = harness.run(cell(name), 2 ** 31 + 13, 1.0, False, "cpu", time.perf_counter(),
                          size=SMALL, program=AlteredAnswer)
    assert not r["correct"] and r["checks"]["err_p50"]["value"] > r["checks"]["err_p50"]["limit"]


class LostTile(serve.Program):
    """A local fault of the tile classes: after each refresh, the tile of
    the two-field class with the most flagged slabs loses its flags, so its
    pixels show the far plane alone until the next refresh."""

    def dispatch(self, c):
        img = super().dispatch(c)
        if self.refreshed():
            occ = self.render.cache["occs"][0]
            occ[int(occ.sum(dim=1).argmax())].zero_()
        return img


class LostPairs(serve.Program):
    """A local fault of the pair lists: after each refresh, the fine pairs
    of the union tile with the most of them are masked out of the composite
    until the next."""

    def dispatch(self, c):
        img = super().dispatch(c)
        if self.refreshed():
            mask = self.render.cache["list_mask"]
            mask[int(mask.sum(dim=1).argmax())].zero_()
        return img


@pytest.mark.parametrize("name,fault", [("head_torso.shipped_serve", LostTile),
                                        ("head_hier.pair_serve", LostPairs)])
def test_a_fault_on_one_tile_is_not_correct(name, fault):
    """One tile of 9 (48x48 frames) wrong in the frames after a refresh: the
    median error does not see it, the worst tile's excess does."""
    size = dict(small(name), frame={"H": 48, "W": 48})
    r = harness.run(cell(name), 2 ** 31 + 29, 1.0, False, "cpu", time.perf_counter(),
                          size=size, program=fault)
    checks = r["checks"]
    assert not r["correct"], checks
    assert checks["tile_excess"]["value"] > checks["tile_excess"]["limit"], checks
    assert checks["err_p50"]["value"] <= checks["err_p50"]["limit"], checks


def test_the_training_mix_runs():
    r = harness.run(waiting_cell(*TRAIN), 2 ** 31 + 17, 1.0, False, "cpu",
                          time.perf_counter(), size=SMALL)
    check_line(r, set(TRAIN[3]))


class Unchanged(train.TrainProgram):
    """A fault: a step that returns its state unchanged."""

    def run(self, batch):
        return {"loss": torch.zeros(())}


class HalfBatch(train.TrainProgram):
    """A fault: half of the batch left out, the mean taken over the rest."""

    def run(self, batch):
        half = batch["coords"].shape[0] // 2
        return super().run(dict(batch, coords=batch["coords"][:half],
                                z_vals=batch["z_vals"][:half]))


def test_training_faults_read_far_above_a_sound_step():
    """On the program's float32 path, which follows the reference, a state
    left unchanged reads 1 on the parameters' change and half the batch
    reads ten times the sound step's loss gap or more."""
    c = waiting_cell(*TRAIN)
    c.model["render"] = dict(c.model["render"], compute_dtype="float32")
    runs = {f.__name__: harness.run(c, 2 ** 31 + 19, 0.5, False, "cpu",
                                          time.perf_counter(), size=SMALL, program=f)["readings"]
            for f in (train.TrainProgram, Unchanged, HalfBatch)}
    assert runs["Unchanged"]["delta3_gap"] == pytest.approx(1.0)
    assert runs["HalfBatch"]["loss_gap"] >= 10 * runs["TrainProgram"]["loss_gap"], runs


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "head_torso.shipped_serve", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "sys.path.insert(0, %r)\n"
            "import torch; torch.set_num_threads(2)\n"
            "from conftest import SMALL\n"
            "from pathlib import Path\n"
            "from port_bench import harness\n"
            "c = harness.load_cell(Path(%r), 'head_torso.shipped_serve')\n"
            "harness.run(c, 3, 0.5, False, 'cpu', time.perf_counter(), size=SMALL)\n"
            "print(harness.forbidden_modules())\n") % (str(ROOT), str(ROOT / "port_bench" /
                                                                  "tests"), str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and out.stdout.strip().splitlines()[-1] == "[]", out.stderr[-2000:]


@pytest.mark.card
@pytest.mark.parametrize("name", SERVING)
def test_control_at_the_cells_own_size(card, name):
    c = cell(name)
    limits = c.mix["check"]["limits"]
    r = control.readings(c, 2 ** 31 + 23, 3.0, card)
    assert all(r["program"][k] <= v for k, v in limits.items()), r
    assert any(r["control"][k] > v for k, v in limits.items()), r
