"""The port's audio networks on the CPU against the reference package's,
with the same weights in both: the wav2exp AudioEncoder
(pipeline/audio/wav2exp.py), the DeepSpeech net (pipeline/audio/
deepspeech.py), AudioNet and ExpressionEncHalf (models/encoders.py).

Tolerances, with what they measured here:
- AudioEncoder within atol 2e-4 / rtol 1e-3, the bar of
  tests/test_pipeline_audio.py:111 (measured 1.5e-7 on mel windows and on
  wav2exp_features, outputs up to 0.5), BatchNorm statistics made
  non-trivial;
- DeepSpeech at n_hidden 64 (the LSTM's biases made non-zero, so the gate
  order and the forget bias count): logits and deepspeech_features_from_wav
  within rtol 1e-4 / atol 1e-4 (measured 2.4e-7, and 3.3e-7 resampled from
  22,050 Hz; logits up to 0.85);
- AudioNet and ExpressionEncHalf within 1e-5 (measured 2.2e-8 and 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfanerf_tpu.models.encoders import (
    apply_audionet_ds, apply_expression_enc_half, init_audionet_ds, init_expression_enc_half,
)
from dfanerf_tpu.pipeline.audio import deepspeech as JD
from dfanerf_tpu.pipeline.audio import wav2exp as JW
from dfanerf_torch.compat.from_jax import audio_encoder_state_dict, params_to_state_dict
from dfanerf_torch.models import AudioNet, ExpressionEncHalf
from dfanerf_torch.pipeline.audio import deepspeech as TD
from dfanerf_torch.pipeline.audio import wav2exp as TW

_j_encode = jax.jit(JW.apply_audio_encoder)


def _wav(seconds, sr=16000, scale=0.1, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    return ((np.sin(2 * np.pi * 220 * t) + 0.5 * rng.randn(len(t))) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def encoder_params():
    """The reference's encoder params, read by the reference's converter
    from a seeded port encoder whose BatchNorm statistics are made
    non-trivial (the reference initialises them to the identity)."""
    enc = TW.init_audio_encoder(5, device="cpu")
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(0.5 + torch.rand(c, generator=g))
                m.bias.copy_(0.2 * torch.rand(c, generator=g) - 0.1)
                m.running_mean.copy_(0.2 * torch.rand(c, generator=g) - 0.1)
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))
    return enc, jax.tree.map(np.asarray, JW.audio_encoder_from_torch(enc.state_dict()))


def test_audio_encoder_matches(encoder_params):
    """The reference's params through the port's converter, against the
    reference's encoder."""
    enc = TW.audio_encoder_from_torch(audio_encoder_state_dict(encoder_params[1]), device="cpu")
    mel = np.random.RandomState(6).randn(4, 80, 16).astype(np.float32)
    with torch.no_grad():
        out = enc(torch.from_numpy(mel)[:, None])
        got = TW.apply_audio_encoder(enc, torch.from_numpy(mel)).numpy()
    assert out.shape == (4, 512, 1, 1)
    ref = np.asarray(_j_encode(encoder_params[1], jnp.asarray(mel)))
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


def test_wav2exp_features_match(encoder_params):
    enc, params = encoder_params
    w = _wav(1.2)
    got = TW.wav2exp_features(enc, w).numpy()
    ref = JW.wav2exp_features(params, jnp.asarray(w))
    assert got.shape == ref.shape == (int((1.2 * 80 + 1 - 16) / 80.0 * 25), 512)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


def test_state_dict_layouts_agree(encoder_params):
    """The port's state dict is the reference's audio_encoder.pth layout:
    the reference's converter reads it (the fixture), and the port's
    converter from the reference's params gives it back exactly."""
    enc, params = encoder_params
    sd = audio_encoder_state_dict(params)
    assert sorted(sd) == sorted(enc.state_dict())
    for k, v in enc.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)


@pytest.fixture(scope="module")
def deepspeech_params():
    """The reference's init at n_hidden 64, with non-zero biases."""
    params = jax.tree.map(np.asarray, jax.jit(JD.init_deepspeech, static_argnums=1)(
        jax.random.PRNGKey(0), 64))
    rng = np.random.RandomState(9)
    return {k: (rng.uniform(-0.5, 0.5, v.shape).astype(np.float32) if k.endswith(("_b", "bias"))
                else v) for k, v in params.items()}


def test_deepspeech_logits_match(deepspeech_params):
    net = TD.deepspeech_from_params(deepspeech_params, device="cpu")
    x = np.random.RandomState(3).randn(40, 494).astype(np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    ref = np.asarray(JD.apply_deepspeech(deepspeech_params, jnp.asarray(x)))
    assert got.shape == ref.shape == (40, 29)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sr", [16000, 22050])
def test_deepspeech_features_match(deepspeech_params, sr):
    net = TD.deepspeech_from_params(deepspeech_params, device="cpu")
    w = _wav(1.0, sr=sr, scale=3000.0, seed=4)
    got = TD.deepspeech_features_from_wav(net, w, sample_rate=sr)
    ref = JD.deepspeech_features_from_wav(deepspeech_params, w, sample_rate=sr)
    assert got.shape == ref.shape == (25, 16, 29)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_deepspeech_npz_layout(deepspeech_params, tmp_path):
    path = tmp_path / "deepspeech.npz"
    np.savez(path, **deepspeech_params)
    net = TD.load_deepspeech_npz(str(path), device="cpu")
    ref = TD.deepspeech_from_params(deepspeech_params, device="cpu")
    for k, v in ref.state_dict().items():
        torch.testing.assert_close(net.state_dict()[k], v, rtol=0, atol=0)


def test_audionet_and_expression_enc_half_match():
    ja = jax.tree.map(np.asarray, jax.jit(init_audionet_ds, static_argnums=1)(
        jax.random.PRNGKey(1), 64))
    je = jax.tree.map(np.asarray, jax.jit(init_expression_enc_half)(jax.random.PRNGKey(2)))
    net, half = AudioNet(dim_aud=64), ExpressionEncHalf()
    net.load_state_dict(params_to_state_dict(ja))
    half.load_state_dict(params_to_state_dict(je))
    x = np.random.RandomState(5).randn(6, 16, 29).astype(np.float32)
    e = np.random.RandomState(6).randn(6, 64).astype(np.float32)
    with torch.no_grad():
        for win in (16, 8):
            np.testing.assert_allclose(
                net(torch.from_numpy(x), win).numpy(),
                np.asarray(jax.jit(apply_audionet_ds, static_argnames="win_size")(
                    ja, jnp.asarray(x), win_size=win)), rtol=0, atol=1e-5)
        np.testing.assert_allclose(half(torch.from_numpy(e)).numpy(),
                                   np.asarray(jax.jit(apply_expression_enc_half)(
                                       je, jnp.asarray(e))),
                                   rtol=0, atol=1e-5)


