"""Checkpoints across the two packages, and the port's training loop, on
the CPU.

The reference state has its optimizer moments filled from a numpy seed (a
state in mid-training, without compiling a step). A checkpoint of either
package loads into the other: the reference's into the port equals
state_from_jax of the same tree, bit for bit; the port's into the
reference equals state_to_jax of the port's state, bit for bit, leaf dtypes
included. train_loop runs 20 steps of a small model in a temporary run
directory, renders a held-out frame (prediction | target, a binary PPM:
the card has no imageio) and resumes from its checkpoint."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from dfanerf_tpu.config import ExperimentConfig as JExperimentConfig
from dfanerf_tpu.config import TrainConfig as JTrainConfig
from dfanerf_tpu.models import DecoderConfig as JDecoderConfig
from dfanerf_tpu.train import init_train_state as j_init_train_state
from dfanerf_tpu.train.checkpoint import load_checkpoint as j_load_checkpoint
from dfanerf_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from dfanerf_torch.compat.from_jax import state_from_jax, state_to_jax
from dfanerf_torch.config import ExperimentConfig, RenderConfig, SignalConfig, TrainConfig
from dfanerf_torch.data.synthetic import make_synthetic_dataset
from dfanerf_torch.models import DecoderConfig
from dfanerf_torch.train.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from dfanerf_torch.train.loop import train_loop
from dfanerf_torch.train.state import init_train_state

DEC = dict(hidden_size=64, n_blocks=4, skips=(2,), z_dim=32)
JCFG = JExperimentConfig(decoder=JDecoderConfig(**DEC), train=JTrainConfig(z_dim=32))
TCFG = ExperimentConfig(decoder=DecoderConfig(**DEC), train=TrainConfig(z_dim=32))


def _leaves(tree):
    return {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees_equal(a, b):
    a, b = _leaves(a), _leaves(b)
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.fixture(scope="module")
def jstate():
    """A reference state with moments, counters and step set."""
    state = jax.tree.map(np.asarray, j_init_train_state(jax.random.PRNGKey(0), JCFG))
    rng = np.random.RandomState(0)
    for i, o in enumerate(state["opt"].values()):
        o["m"] = jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32), o["m"])
        o["v"] = jax.tree.map(lambda x: rng.rand(*x.shape).astype(np.float32), o["v"])
        o["t"] = np.asarray(7 + i, np.int32)
    state["step"] = np.asarray(9, np.int32)
    return state


def test_reference_checkpoint_loads_into_port(jstate, tmp_path):
    path = str(tmp_path / "000009.npz")
    j_save_checkpoint(path, jstate)
    template = init_train_state(TCFG, seed=3, device="cpu")
    got = load_checkpoint(path, template)
    want = state_from_jax(jstate, TCFG, device="cpu")
    _assert_trees_equal(state_to_jax(got), state_to_jax(want))
    assert got["step"] == 9 and got["opt"]["expnet"]["t"] == int(jstate["opt"]["expnet"]["t"]) > 0
    # the template is left as it was
    assert template["step"] == 0 and template["opt"]["decoder"]["t"] == 0


def test_port_checkpoint_loads_into_reference(jstate, tmp_path):
    state = state_from_jax(jstate, TCFG, device="cpu")
    with torch.no_grad():
        state["params"].decoder.fc_in.bias.add_(1.0)
    state["step"] = 11
    path = str(tmp_path / "000011.npz")
    save_checkpoint(path, state)
    template = j_init_train_state(jax.random.PRNGKey(5), JCFG)
    got = jax.tree.map(np.asarray, j_load_checkpoint(path, template))
    _assert_trees_equal(got, state_to_jax(state))
    with np.load(path) as f:
        assert f["params/decoder/blocks/0/w"].shape == (64, 64)
        assert f["params/decoder/fc_in/w"].shape == (156, 64)  # [in, out]
        assert f["opt/audattnet/t"].dtype == np.int32 and "opt/decoder/m/fc_in/b" in f.files


def test_missing_keys_keep_template_values(jstate, tmp_path):
    state = state_from_jax(jstate, TCFG, device="cpu")
    path = str(tmp_path / "partial")
    save_checkpoint(path, state)  # np.savez appends .npz
    with np.load(path + ".npz") as f:
        kept = {k: f[k] for k in f.files if not k.startswith(("opt/", "z_app"))}
    np.savez(path + ".npz", **kept, extra_key=np.zeros(3))
    template = init_train_state(TCFG, seed=3, device="cpu")
    got = load_checkpoint(path, template)
    tree, tmpl, full = state_to_jax(got), state_to_jax(template), state_to_jax(state)
    _assert_trees_equal(tree["opt"], tmpl["opt"])
    np.testing.assert_array_equal(tree["z_app"], tmpl["z_app"])
    _assert_trees_equal(tree["params"], full["params"])
    np.testing.assert_array_equal(tree["z_shape"], full["z_shape"])


def test_latest_checkpoint(tmp_path):
    assert latest_checkpoint(str(tmp_path)) is None
    for name in ("000010.npz", "000200.npz", "000030.npz", "notes.npz"):
        (tmp_path / name).write_bytes(b"")
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "000200.npz")


def test_train_loop_logs_checkpoints_and_resumes(tmp_path):
    ds = make_synthetic_dataset(n_frames=6, H=16, W=16, n_samples_gt=8, device="cpu")
    cfg = ExperimentConfig(decoder=DecoderConfig(**DEC), render=RenderConfig(n_samples=8),
                           train=TrainConfig(n_rand=64, z_dim=32, i_print=5, i_weights=10,
                                             i_test_person=20),
                           signal=SignalConfig(nosmo_iters=4, noexp_iters=6))
    run = str(tmp_path / "run")
    seen = []
    state = train_loop(cfg, ds, n_iters=20, run_dir=run, device="cpu",
                       on_metrics=lambda step, m: seen.append(step))
    assert state["step"] == 20 and seen == [1, 5, 10, 15, 20]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    train_lines = [m for m in lines if "loss" in m]
    assert [m["step"] for m in train_lines] == seen
    assert all(np.isfinite(m["loss"]) and m["grad_norm"] > 0 for m in train_lines)
    # the held-out render at step 20 (the unfused renderer: use_fused_kernel
    # is off by default), prediction | target side by side
    (val,) = [m for m in lines if "val_psnr" in m]
    assert val["step"] == 20 and val["n_val"] == 1 and np.isfinite(val["val_psnr"])
    assert os.listdir(os.path.join(run, "test_20")) == ["test_000.ppm"]
    with open(os.path.join(run, "test_20", "test_000.ppm"), "rb") as f:
        magic, w, h, maxval, pix = f.read().split(maxsplit=4)
    assert (magic, int(w), int(h), maxval) == (b"P6", 32, 16, b"255")
    side = np.frombuffer(pix, np.uint8).reshape(16, 32, 3)
    np.testing.assert_array_equal(side[:, 16:], ds.imgs_com[ds.i_val[0]])
    assert sorted(os.listdir(run)) == ["000010.npz", "000020.npz", "config.json",
                                       "metrics.jsonl", "test_20"]
    assert ExperimentConfig.from_json(os.path.join(run, "config.json")) == cfg
    saved = load_checkpoint(os.path.join(run, "000020.npz"), state)
    _assert_trees_equal(state_to_jax(saved), state_to_jax(state))
    # a second call resumes from step 20 and goes on to 25
    state2 = train_loop(cfg, ds, n_iters=25, run_dir=run, val_render=False, device="cpu")
    assert state2["step"] == 25 and state2["opt"]["expnet"]["t"] == 19
    with open(os.path.join(run, "metrics.jsonl")) as f:
        assert [json.loads(x)["step"] for x in f][-2:] == [21, 25]
