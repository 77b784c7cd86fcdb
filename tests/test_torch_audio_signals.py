"""The DeepSpeech signal path of the port on the CPU against the reference
package's: the state with AudioNet (audio_net="deepspeech") carried across
in both directions, encode_signal on both branches, and float32 train steps
of a narrow DeepSpeech configuration (a decoder of 4 blocks, 64 wide,
[N, 16, 29] windows as the synthetic scene's auds). The weights are the
port's seeded init, carried to the reference with state_to_jax.

Tolerances, with what they measured here:
- the state's round trip is bit-exact (a transpose);
- encode_signal within 1e-5 (measured 1.0e-7 per frame, 3.0e-8 smoothed);
- the train step: loss and grad_norm within rtol 1e-4, the float32 bar of
  tests/test_torch_train_step.py (measured 0 to 2.5e-7).
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
from dfanerf_tpu.train import make_train_step as j_make_train_step
from dfanerf_tpu.train.signals import encode_signal as j_encode_signal
from dfanerf_torch.compat.from_jax import state_from_jax, state_to_jax
from dfanerf_torch.config import ExperimentConfig, RenderConfig, SignalConfig, TrainConfig
from dfanerf_torch.data.dataset import FrameDataset
from dfanerf_torch.models import AudioNet, DecoderConfig
from dfanerf_torch.train.signals import encode_signal
from dfanerf_torch.train.state import init_train_state
from dfanerf_torch.train.step import dataset_to_device, make_train_step, pixel_coords_from_scores

DEC = dict(hidden_size=64, n_blocks=4, skips=(2,), z_dim=32)
TRAIN = dict(n_rand=128, z_dim=32, perturb=True)
SIGNAL = dict(audio_net="deepspeech", nosmo_iters=1, win_size=16)
H = W = 24


def _configs():
    render = dict(n_samples=16, compute_dtype="float32")
    return (JExperimentConfig(decoder=JDecoderConfig(**DEC), render=JRenderConfig(**render),
                              train=JTrainConfig(**TRAIN), signal=JSignalConfig(**SIGNAL)),
            ExperimentConfig(decoder=DecoderConfig(**DEC), render=RenderConfig(**render),
                             train=TrainConfig(**TRAIN), signal=SignalConfig(**SIGNAL)))


@pytest.fixture(scope="module")
def ds_scene():
    """The synthetic scene with DeepSpeech-shaped windows as its auds, and
    the port's seeded state of the narrow DeepSpeech configuration in the
    reference's layout."""
    ds = make_synthetic_dataset(n_frames=8, H=H, W=W, n_samples_gt=16)
    ds = dataclasses.replace(ds, auds=np.random.RandomState(0).randn(8, 16, 29).astype(np.float32))
    tds = FrameDataset(**{f.name: getattr(ds, f.name) for f in dataclasses.fields(ds)})
    _, tcfg = _configs()
    return ds, tds, state_to_jax(init_train_state(tcfg, seed=0, device="cpu"))


def test_state_round_trip_with_audionet(ds_scene):
    _, _, jstate = ds_scene
    _, tcfg = _configs()
    state = state_from_jax(jstate, tcfg, device="cpu")
    assert isinstance(state["params"].audnet, AudioNet)
    assert state["params"].audnet.fc2.out_features == 64  # dim_signal - 32
    back = state_to_jax(state)
    leaves = jax.tree_util.tree_leaves
    assert len(leaves(back)) == len(leaves(jstate))
    for a, b in zip(leaves(back), leaves(jstate)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_smoothing", [False, True])
def test_encode_signal_deepspeech_matches(ds_scene, use_smoothing):
    ds, tds, jstate = ds_scene
    _, tcfg = _configs()
    state = state_from_jax(jstate, tcfg, device="cpu")
    auds, exps = torch.from_numpy(tds.auds), torch.from_numpy(tds.exps)
    for i in (0, 3, 7):  # the window runs off both ends of the 6 valid frames
        with torch.no_grad():
            got = encode_signal(state["params"], auds, exps, i, 6, 4, use_smoothing,
                                "deepspeech", 16).numpy()
        ref = np.asarray(_j_encode_signal(jstate["params"], jnp.asarray(ds.auds),
                                         jnp.asarray(ds.exps), jnp.int32(i), jnp.int32(6), 4,
                                         jnp.asarray(use_smoothing), "deepspeech", 16))
        assert got.shape == ref.shape == (96,)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


_j_encode_signal = jax.jit(j_encode_signal, static_argnums=(5, 7, 8))


def _reference_batch(ds, key, n_rand, n_samples):
    """The draws of the reference step for ``key``, as the port's batch."""
    k_img, k_pix, k_z, _ = jax.random.split(key, 4)
    img_i = int(ds.i_train[int(jax.random.randint(k_img, (), 0, len(ds.i_train)))])
    u = torch.from_numpy(np.array(jax.random.uniform(k_pix, (H * W,))))
    coords = pixel_coords_from_scores(u, H, W, n_rand, 0.0, None)
    z = np.array(j_stratified_z_vals(ds.near, ds.far, n_rand, n_samples, key=k_z))
    return {"img_i": img_i, "coords": coords, "z_vals": torch.from_numpy(z)}


def test_train_step_deepspeech_matches(ds_scene):
    """Two float32 steps from the same state: the first on the per-frame
    signal, the second smoothed (nosmo_iters 1)."""
    ds, tds, jstate = ds_scene
    jcfg, tcfg = _configs()
    jstep = j_make_train_step(jcfg, ds)
    jdata = j_dataset_to_device(ds)
    state = state_from_jax(jstate, tcfg, device="cpu")
    step = make_train_step(tcfg, tds, device="cpu")
    data = dataset_to_device(tds, "cpu")
    js = jstate
    for key in jax.random.split(jax.random.PRNGKey(1), 2):
        js, ref = jstep(js, jdata, key)
        state, got = step.step_on_batch(state, data, _reference_batch(ds, key, 128, 16))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4, err_msg=k)
    assert state["step"] == 2
