"""The port's train step against the reference package's jitted
make_train_step on the CPU, step for step.

Both start from the same state (JAX init, converted with its optimizer
moments) on the same synthetic scene (24x24, 8 frames), with a decoder of 4
blocks, 64 wide, z_dim 32, 128 rays of 16 jittered samples. The port's
step_on_batch is fed the reference's own draws for each step's key: the
frame index, the pixel scores (turned into pixels by the port's
pixel_coords_from_scores, which must pick the reference's pixels) and the
jittered depths. nosmo_iters=2, noexp_iters=3 and distortion_from=1 (both
stacks) make every stage gate flip inside the 5 steps.

Bars, from docs/PARITY.md:27 (the bar of tests/test_train_parity.py):
- float32: loss, loss_head, loss_com and grad_norm within rtol 1e-4 at
  every step (measured at most 4.6e-7). After 5 steps every parameter is
  within Adam's sign-noise bound 2 * lr * steps = 5e-3 (measured 6.9e-4),
  and 94.1% of them within 1e-5 (bar 90%): the audio net's gradients are
  ~2.5e-8, at Adam's eps of 1e-8, so its normalized steps follow the last
  bits of the gradient. Each group's moments agree to a relative norm of
  1.1e-2 (bar 3e-2; the attention nets' are the loosest). A state carried
  across from the reference after 3 steps and stepped twice more in each
  package: losses within rtol 1e-4, every parameter within 1e-5.
- bfloat16 (3 steps): bf16 densities land on 0 exactly, where the
  composite blend's gradient 1e-6 / (sigma + 1e-6)^2 is largest and
  density_act's max passes half the gradient, as jnp.maximum does: step 0's
  grad_norm is ~2e3 here, against 0.14 in float32, in both packages. The
  backward's bf16 roundings come in another order than XLA's fused ones.
  Measured: losses within rtol 5.6e-5, grad_norm 1.9e-3 (step 0's, the
  ~2e3 one, to 1.9e-7), parameters 2.0e-3 apart after 3 steps. Bars:
  losses rtol 1e-3, grad_norm rtol 5e-3, parameters within the sign-noise
  bound 2 * lr * 3 = 3e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfanerf_tpu.config import ExperimentConfig as JExperimentConfig
from dfanerf_tpu.config import RenderConfig as JRenderConfig
from dfanerf_tpu.config import SignalConfig as JSignalConfig
from dfanerf_tpu.config import TrainConfig as JTrainConfig
from dfanerf_tpu.core.sampling import stratified_z_vals as j_stratified_z_vals
from dfanerf_tpu.data import make_synthetic_dataset
from dfanerf_tpu.models import DecoderConfig as JDecoderConfig
from dfanerf_tpu.train import dataset_to_device as j_dataset_to_device
from dfanerf_tpu.train import init_train_state as j_init_train_state
from dfanerf_tpu.train import make_train_step as j_make_train_step
from dfanerf_tpu.train.step import sample_pixel_coords as j_sample_pixel_coords
from dfanerf_torch.compat.from_jax import state_from_jax, state_to_jax
from dfanerf_torch.config import ExperimentConfig, RenderConfig, SignalConfig, TrainConfig
from dfanerf_torch.data.dataset import FrameDataset
from dfanerf_torch.models import DecoderConfig
from dfanerf_torch.train.step import dataset_to_device, make_train_step, pixel_coords_from_scores

DEC = dict(hidden_size=64, n_blocks=4, skips=(2,), z_dim=32)
TRAIN = dict(n_rand=128, z_dim=32, distortion_lambda=1e-2, distortion_stacks="both",
             distortion_from=1, perturb=True)
SIGNAL = dict(nosmo_iters=2, noexp_iters=3)
H = W = 24
N_STEPS = 5
METRICS = ("loss", "loss_head", "loss_com", "grad_norm")


def _configs(dtype):
    render = dict(n_samples=16, compute_dtype=dtype)
    return (JExperimentConfig(decoder=JDecoderConfig(**DEC), render=JRenderConfig(**render),
                              train=JTrainConfig(**TRAIN), signal=JSignalConfig(**SIGNAL)),
            ExperimentConfig(decoder=DecoderConfig(**DEC), render=RenderConfig(**render),
                             train=TrainConfig(**TRAIN), signal=SignalConfig(**SIGNAL)))


@pytest.fixture(scope="module")
def scene():
    ds = make_synthetic_dataset(n_frames=8, H=H, W=W, n_samples_gt=16)
    tds = FrameDataset(**{f.name: getattr(ds, f.name) for f in dataclasses.fields(ds)})
    keys = list(jax.random.split(jax.random.PRNGKey(1), N_STEPS))
    return ds, tds, keys


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _reference_batch(ds, key, n_rand, n_samples):
    """The draws of the reference step for ``key`` (train/step.py:382-391),
    as the port's batch; the pixels through the port's transform."""
    k_img, k_pix, k_z, _ = jax.random.split(key, 4)
    img_i = int(ds.i_train[int(jax.random.randint(k_img, (), 0, len(ds.i_train)))])
    u = torch.from_numpy(np.array(jax.random.uniform(k_pix, (H * W,))))
    coords = pixel_coords_from_scores(u, H, W, n_rand, 0.0, None)
    ref = np.asarray(j_sample_pixel_coords(k_pix, H, W, n_rand, 0.0, jnp.zeros(4, jnp.int32)))
    np.testing.assert_array_equal(coords.numpy(), ref)
    z = np.asarray(j_stratified_z_vals(ds.near, ds.far, n_rand, n_samples, key=k_z))
    return {"img_i": img_i, "coords": coords, "z_vals": torch.from_numpy(z)}


def _reference_run(scene, dtype, n_steps):
    """(jax states before each step and after the last, metrics per step)."""
    ds, _, keys = scene
    jcfg, _ = _configs(dtype)
    state = j_init_train_state(jax.random.PRNGKey(0), jcfg)
    data = j_dataset_to_device(ds)
    step = j_make_train_step(jcfg, ds)
    states, metrics = [_np(state)], []
    for key in keys[:n_steps]:
        state, m = step(state, data, key)
        states.append(_np(state))
        metrics.append(_np(m))
    return states, metrics


@pytest.fixture(scope="module")
def fp32_run(scene):
    return _reference_run(scene, "float32", N_STEPS)


def _port_steps(scene, dtype, jstate, first, n):
    """n port steps from the converted reference state, on the reference's
    draws of steps first..first+n-1; (state, metrics per step)."""
    ds, tds, keys = scene
    _, tcfg = _configs(dtype)
    state = state_from_jax(jstate, tcfg, device="cpu")
    data = dataset_to_device(tds, "cpu")
    step = make_train_step(tcfg, tds, device="cpu")
    out = []
    for key in keys[first:first + n]:
        batch = _reference_batch(ds, key, TRAIN["n_rand"], 16)
        state, m = step.step_on_batch(state, data, batch)
        assert m["img_i"] == batch["img_i"]
        out.append(m)
    return state, out


def _check_metrics(got, ref, rtol):
    for i, (g, r) in enumerate(zip(got, ref)):
        assert int(r["img_i"]) == g["img_i"]
        np.testing.assert_allclose(float(g["lr"]), float(r["lr"]), rtol=1e-6)
        for k in METRICS:
            np.testing.assert_allclose(float(g[k]), float(r[k]), rtol=rtol, err_msg=f"{k} {i}")


def _param_diffs(jtree, state):
    got = jax.tree_util.tree_leaves(state_to_jax(state)["params"])
    ref = jax.tree_util.tree_leaves(jtree["params"])
    assert len(got) == len(ref)
    return np.concatenate([np.abs(g - r).ravel() for g, r in zip(got, ref)])


def test_five_steps_match_reference_fp32(scene, fp32_run):
    states, ref = fp32_run
    state, got = _port_steps(scene, "float32", states[0], 0, N_STEPS)
    _check_metrics(got, ref, 1e-4)
    d = _param_diffs(states[-1], state)
    assert d.max() <= 2 * 5e-4 * N_STEPS
    assert (d <= 1e-5).mean() > 0.9, (d <= 1e-5).mean()
    # the staged counters and moments advanced as the reference's did
    final = state_to_jax(state)
    for name, o in states[-1]["opt"].items():
        assert int(final["opt"][name]["t"]) == int(o["t"]), name
        for k in ("m", "v"):
            for a, b in zip(jax.tree_util.tree_leaves(final["opt"][name][k]),
                            jax.tree_util.tree_leaves(o[k])):
                rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
                assert rel < 3e-2, (name, k, rel)
    assert [int(final["opt"][n]["t"]) for n in ("decoder", "expnet", "audattnet")] == [5, 2, 3]
    assert state["step"] == N_STEPS


def test_resume_from_reference_state_matches(scene, fp32_run):
    """A reference state in mid-training (3 steps: moments and counters set)
    carried across, then 2 more steps in each package."""
    states, ref = fp32_run
    assert int(states[3]["opt"]["decoder"]["t"]) == 3
    state, got = _port_steps(scene, "float32", states[3], 3, 2)
    _check_metrics(got, ref[3:], 1e-4)
    assert _param_diffs(states[-1], state).max() <= 1e-5


def test_three_steps_match_reference_bf16(scene):
    states, ref = _reference_run(scene, "bfloat16", 3)
    state, got = _port_steps(scene, "bfloat16", states[0], 0, 3)
    for i, (g, r) in enumerate(zip(got, ref)):
        for k in ("loss", "loss_head", "loss_com"):
            np.testing.assert_allclose(float(g[k]), float(r[k]), rtol=1e-3, err_msg=f"{k} {i}")
        np.testing.assert_allclose(float(g["grad_norm"]), float(r["grad_norm"]), rtol=5e-3)
    assert _param_diffs(states[-1], state).max() <= 2 * 5e-4 * 3
