"""The port's audio frontends (dfanerf_torch/pipeline/audio/frontend.py) on
the CPU against the reference package's, on seeded wavs: a 220 Hz tone plus
noise, 0.5 to 1.2 s at 16 kHz.

Tolerances, with what they measured here:
- the filterbanks, interpolate_features and sliding_windows are the same
  numpy code: bit-equal;
- melspectrogram (values in [-4, 4]) within 1e-4 (measured 6.0e-6 to
  7.4e-6: the float32 FFTs of pocketfft and XLA round apart, and the dB
  conversion turns a relative 1e-7 into an absolute few 1e-6);
- stft_mag with a window shorter than n_fft: relative 1e-5 of its largest
  value (measured 1.7e-7);
- mfcc of int16-scale samples (values up to ~32) within rtol 1e-4 / atol
  1e-3 (measured 1.7e-5 to 2.3e-5 absolute; 7.6e-6 on silence);
- deepspeech_input_windows within 1e-5 (measured 9.5e-7). It normalises
  with the population std (ddof 0), as jnp's std does; torch's default
  std (ddof 1) misses this bar (5.4e-5 on the same input).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfanerf_tpu.pipeline.audio import frontend as J
from dfanerf_torch.pipeline.audio import frontend as T


def _wav(seconds, sr=16000, scale=1.0, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    return ((0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.randn(len(t))) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("sr,n_fft,n_mels,fmin,fmax,htk", [
    (16000, 800, 80, 55.0, 7600.0, False),   # wav2exp's slaney bank
    (16000, 512, 26, 0.0, 8000.0, True),     # the MFCC's HTK bank
])
def test_mel_filterbank_bit_equal(sr, n_fft, n_mels, fmin, fmax, htk):
    args = (sr, n_fft, n_mels, fmin, fmax)
    kw = dict(htk=htk, norm_slaney=not htk)
    np.testing.assert_array_equal(T.mel_filterbank(*args, **kw), J.mel_filterbank(*args, **kw))


def test_interpolate_and_sliding_windows_bit_equal():
    feats = np.random.RandomState(1).randn(37, 29).astype(np.float32)
    a = T.interpolate_features(feats, 50.0, 25.0, 19)
    np.testing.assert_array_equal(a, J.interpolate_features(feats, 50.0, 25.0, 19))
    for size, stride in ((16, 1), (4, 2)):
        np.testing.assert_array_equal(T.sliding_windows(feats, size, stride),
                                      J.sliding_windows(feats, size, stride))


@pytest.mark.parametrize("seconds", [0.5, 1.2])
def test_melspectrogram_matches(seconds):
    w = _wav(seconds)
    got = T.melspectrogram(torch.from_numpy(w)).numpy()
    ref = np.asarray(J.melspectrogram(jnp.asarray(w)))
    assert got.shape == ref.shape == (int(seconds * 16000) // 200 + 1, 80)
    assert got.min() >= -4.0 and got.max() <= 4.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_stft_window_shorter_than_fft():
    """The zero-padded window (win_length < n_fft) and the frames without
    centring."""
    w = _wav(0.5, seed=2)
    for center in (True, False):
        got = T.stft_mag(torch.from_numpy(w), 800, 200, 600, center=center).numpy()
        ref = np.asarray(J.stft_mag(jnp.asarray(w), 800, 200, 600, center=center))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("seconds", [0.5, 1.0])
def test_mfcc_matches(seconds):
    w = _wav(seconds, scale=3000.0, seed=3)
    got = T.mfcc(torch.from_numpy(w)).numpy()
    ref = np.asarray(J.mfcc(jnp.asarray(w)))
    assert got.shape == ref.shape == (1 + int(np.ceil((len(w) - 400) / 160)), 26)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


def test_mfcc_silence_takes_eps():
    """Zero energy and zero filter outputs are replaced by float32 eps
    before each log, as the reference does."""
    w = np.zeros(8000, np.float32)
    got = T.mfcc(torch.from_numpy(w)).numpy()
    ref = np.asarray(J.mfcc(jnp.asarray(w)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


def test_deepspeech_input_windows_match():
    feats = T.mfcc(torch.from_numpy(_wav(1.0, scale=3000.0, seed=4)))
    got = T.deepspeech_input_windows(feats).numpy()
    ref = np.asarray(J.deepspeech_input_windows(jnp.asarray(feats.numpy())))
    assert got.shape == ref.shape == (50, 19 * 26)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert abs(float(torch.from_numpy(got).std(correction=0)) - 1.0) < 1e-5
