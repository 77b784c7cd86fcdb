"""Audio DSP frontends (port of dfanerf_tpu/pipeline/audio/frontend.py).

Two frontends feed the two audio paths:

1. ``melspectrogram``, the wav2exp frontend: 16 kHz, preemphasis 0.97, a
   centred STFT (n_fft 800, hop 200, periodic hann window of 800), 80
   slaney-normalised mel bands (55 Hz to 7.6 kHz), amplitude to dB with a
   -100 dB floor, reference level 20 dB, symmetric normalisation clipped
   to [-4, 4]. Output [T, 80], time-major.
2. ``mfcc``, the DeepSpeech frontend (python_speech_features' defaults with
   numcep 26): 25 ms rectangular frames at a 10 ms hop, a 512-point power
   spectrum, 26 HTK-mel filters, an orthonormal DCT-II keeping 26
   coefficients, liftering 22, the log energy in place of c0.

Both run on the device of their input (``torch.fft.rfft``); the filterbanks
and the feature-window utilities (``interpolate_features``,
``sliding_windows``) are numpy, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

_EPS32 = float(np.finfo(np.float32).eps)


@dataclasses.dataclass(frozen=True)
class Wav2ExpHParams:
    """The wav2exp frontend's settings (the reference's hparams.py)."""

    num_mels: int = 80
    n_fft: int = 800
    hop_size: int = 200
    win_size: int = 800
    sample_rate: int = 16000
    preemphasis: float = 0.97
    min_level_db: float = -100.0
    ref_level_db: float = 20.0
    fmin: float = 55.0
    fmax: float = 7600.0
    max_abs_value: float = 4.0
    fps: int = 25
    mel_step_size: int = 16


# --- mel filterbanks (slaney and HTK scales) ---------------------------------


def _hz_to_mel(f, htk: bool):
    f = np.asarray(f, np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_sp = 200.0 / 3  # slaney: linear below 1 kHz, log above
    mel = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(f / min_log_hz) / logstep, mel)


def _mel_to_hz(m, htk: bool):
    m = np.asarray(m, np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float,
                   htk: bool = False, norm_slaney: bool = True) -> np.ndarray:
    """[n_mels, n_fft // 2 + 1] triangular filters (librosa's with
    htk=False, norm_slaney=True; python_speech_features' with htk=True,
    norm_slaney=False)."""
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, htk)
    fb = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lower = (fft_freqs - hz_pts[i]) / max(hz_pts[i + 1] - hz_pts[i], 1e-10)
        upper = (hz_pts[i + 2] - fft_freqs) / max(hz_pts[i + 2] - hz_pts[i + 1], 1e-10)
        fb[i] = np.maximum(0, np.minimum(lower, upper))
    if norm_slaney:
        enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
        fb *= enorm[:, None]
    return fb.astype(np.float32)


# --- STFT ---------------------------------------------------------------------


def preemphasize(wav: torch.Tensor, k: float) -> torch.Tensor:
    """y[n] = x[n] - k x[n - 1], y[0] = x[0]."""
    return torch.cat([wav[:1], wav[1:] - k * wav[:-1]])


def stft_mag(wav: torch.Tensor, n_fft: int, hop: int, win_length: int,
             center: bool = True) -> torch.Tensor:
    """Magnitude STFT with librosa's conventions: reflect padding of
    n_fft // 2 when centred (no edge repeat), a periodic hann window,
    zero-padded to n_fft when shorter. Returns [n_fft // 2 + 1, T]."""
    if center:
        wav = F.pad(wav[None, None], (n_fft // 2, n_fft // 2), mode="reflect")[0, 0]
    frames = wav.unfold(0, n_fft, hop)  # [1 + (n - n_fft) // hop, n_fft]
    hann = 0.5 - 0.5 * torch.cos(
        2.0 * math.pi * torch.arange(win_length, dtype=torch.float32, device=wav.device)
        / win_length)
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        hann = F.pad(hann, (pad, n_fft - win_length - pad))
    return torch.fft.rfft(frames * hann, n=n_fft, dim=-1).abs().T


# --- wav2exp mel spectrogram ----------------------------------------------------


def melspectrogram(wav: torch.Tensor, hp: Wav2ExpHParams = Wav2ExpHParams()) -> torch.Tensor:
    """wav [n] float32 in [-1, 1] -> [T, num_mels] normalised mel."""
    fb = torch.from_numpy(
        mel_filterbank(hp.sample_rate, hp.n_fft, hp.num_mels, hp.fmin, hp.fmax)).to(wav.device)
    mag = stft_mag(preemphasize(wav, hp.preemphasis), hp.n_fft, hp.hop_size, hp.win_size)
    mel = fb @ mag
    min_level = torch.exp(torch.tensor(hp.min_level_db / 20.0) * torch.log(torch.tensor(10.0)))
    s = 20.0 * torch.log10(torch.maximum(min_level.to(wav.device), mel)) - hp.ref_level_db
    s = torch.clamp((2 * hp.max_abs_value) * ((s - hp.min_level_db) / (-hp.min_level_db))
                    - hp.max_abs_value, -hp.max_abs_value, hp.max_abs_value)
    return s.T


# --- DeepSpeech MFCC --------------------------------------------------------------


def mfcc(signal: torch.Tensor, samplerate: int = 16000, winlen: float = 0.025,
         winstep: float = 0.01, numcep: int = 26, nfilt: int = 26, nfft: int = 512,
         preemph: float = 0.97, ceplifter: int = 22, append_energy: bool = True) -> torch.Tensor:
    """python_speech_features.mfcc with numcep 26. signal: int16-scale
    samples [n]. Returns [T, numcep] float32."""
    signal = preemphasize(signal.to(torch.float32), preemph)
    frame_len = int(round(winlen * samplerate))
    frame_step = int(round(winstep * samplerate))
    n = signal.shape[0]
    n_frames = 1 + max(0, int(np.ceil((n - frame_len) / frame_step)))
    pad = (n_frames - 1) * frame_step + frame_len - n
    signal = F.pad(signal, (0, max(pad, 0)))
    frames = signal.unfold(0, frame_len, frame_step)  # rectangular window
    pow_spec = torch.fft.rfft(frames, n=nfft, dim=-1).abs() ** 2 / nfft
    energy = pow_spec.sum(dim=-1)
    energy = torch.where(energy == 0, _EPS32, energy)
    fb = torch.from_numpy(mel_filterbank(samplerate, nfft, nfilt, 0.0, samplerate / 2, htk=True,
                                         norm_slaney=False)).to(signal.device)
    feat = pow_spec @ fb.T
    feat = torch.log(torch.where(feat == 0, _EPS32, feat))
    k = torch.arange(nfilt, dtype=torch.float32, device=signal.device)
    dct_m = torch.cos(math.pi * k[:, None] * (2 * k[None, :] + 1) / (2.0 * nfilt))
    scale = torch.full((nfilt,), math.sqrt(2.0 / nfilt), device=signal.device)
    scale[0] = math.sqrt(1.0 / nfilt)
    feat = ((feat @ dct_m.T) * scale)[:, :numcep]
    if ceplifter > 0:
        lift = 1 + (ceplifter / 2.0) * torch.sin(
            math.pi * torch.arange(numcep, dtype=torch.float32, device=signal.device) / ceplifter)
        feat = feat * lift
    if append_energy:
        feat = torch.cat([torch.log(energy)[:, None], feat[:, 1:]], dim=1)
    return feat


def deepspeech_input_windows(features: torch.Tensor, num_context: int = 9) -> torch.Tensor:
    """MFCC [T, C] -> DeepSpeech input [ceil(T / 2), (2 num_context + 1) C]:
    every second frame, zero context padding, overlapping context windows,
    normalised by the global mean and the population std (ddof 0)."""
    feats = features[::2]
    t, c = feats.shape
    feats = F.pad(feats, (0, 0, num_context, num_context))
    win = 2 * num_context + 1
    out = feats.unfold(0, win, 1).transpose(1, 2).reshape(t, win * c)
    return (out - out.mean()) / out.std(correction=0)


def interpolate_features(features: np.ndarray, input_rate: float, output_rate: float,
                         output_len: int) -> np.ndarray:
    """Linear resampling along time, column by column."""
    input_len = features.shape[0]
    in_t = np.arange(input_len) / float(input_rate)
    out_t = np.arange(output_len) / float(output_rate)
    return np.stack([np.interp(out_t, in_t, features[:, i]) for i in range(features.shape[1])],
                    axis=1)


def sliding_windows(features: np.ndarray, window_size: int = 16, stride: int = 1) -> np.ndarray:
    """Zero-pad half a window on both sides and cut overlapping windows: the
    [N, 16, 29] layout of DeepSpeech features."""
    zero = np.zeros((window_size // 2, features.shape[1]), features.dtype)
    padded = np.concatenate([zero, features, zero], axis=0)
    return np.stack([padded[i:i + window_size]
                     for i in range(0, padded.shape[0] - window_size, stride)])
