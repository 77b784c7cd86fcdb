"""The DeepSpeech 0.1.0 feature network (port of
dfanerf_tpu/pipeline/audio/deepspeech.py): per-frame audio features are the
network's 29-way character logits.

    input  [T, 494]  (26 MFCC x 19-frame context windows, every second
                      frame: frontend.deepspeech_input_windows)
    h1..h3 dense n_hidden, relu clipped to 20
    lstm   one unidirectional LSTM layer of n_hidden
    h5     dense n_hidden, relu clipped to 20
    logits dense 29

The weights are an external asset, an npz in the reference's layout (keys
``h1_w h1_b h2_w h2_b h3_w h3_b lstm_kernel lstm_bias h5_w h5_b h6_w h6_b``,
dense weights [in, out]). The LSTM there is TensorFlow's BasicLSTMCell: one
kernel [in + hidden, 4 hidden] over concat([x, h]), gates in the order i,
j, f, o, and forget_bias 1 added to f before its sigmoid.
``deepspeech_state_dict`` carries that into ``nn.LSTM``: the kernel split
into its input and hidden rows, the gates reordered to torch's i, f, g, o,
the forget bias folded into f's bias.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from dfanerf_torch.device import resolve_device
from dfanerf_torch.pipeline.audio.frontend import (
    deepspeech_input_windows, interpolate_features, mfcc, sliding_windows,
)

N_HIDDEN = 2048
N_INPUT = 26 * 19
N_LOGITS = 29
RELU_CLIP = 20.0
FORGET_BIAS = 1.0


class DeepSpeech(nn.Module):
    """[T, 494] context windows -> [T, 29] logits."""

    def __init__(self, n_hidden: int = N_HIDDEN):
        super().__init__()
        self.h1 = nn.Linear(N_INPUT, n_hidden)
        self.h2 = nn.Linear(n_hidden, n_hidden)
        self.h3 = nn.Linear(n_hidden, n_hidden)
        self.lstm = nn.LSTM(n_hidden, n_hidden)
        self.h5 = nn.Linear(n_hidden, n_hidden)
        self.h6 = nn.Linear(n_hidden, N_LOGITS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in (self.h1, self.h2, self.h3):
            h = torch.clamp(layer(h), 0.0, RELU_CLIP)
        h = self.lstm(h[:, None])[0][:, 0]  # batch 1, zero initial state
        h = torch.clamp(self.h5(h), 0.0, RELU_CLIP)
        return self.h6(h)


def deepspeech_state_dict(params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The reference's flat parameters (the npz layout) -> DeepSpeech's
    state dict."""
    p = {k: np.asarray(v, np.float32) for k, v in params.items()}
    sd = {}
    for name in ("h1", "h2", "h3", "h5", "h6"):
        sd[f"{name}.weight"] = torch.tensor(p[f"{name}_w"].T)
        sd[f"{name}.bias"] = torch.tensor(p[f"{name}_b"])
    kernel, bias = p["lstm_kernel"], p["lstm_bias"]
    n = kernel.shape[1] // 4
    i, j, f, o = (np.arange(g * n, (g + 1) * n) for g in range(4))
    perm = np.concatenate([i, f, j, o])  # TF's i, j, f, o -> torch's i, f, g, o
    n_in = kernel.shape[0] - n
    sd["lstm.weight_ih_l0"] = torch.tensor(kernel[:n_in, perm].T)
    sd["lstm.weight_hh_l0"] = torch.tensor(kernel[n_in:, perm].T)
    b = bias[perm].copy()
    b[n:2 * n] += np.float32(FORGET_BIAS)
    sd["lstm.bias_ih_l0"] = torch.tensor(b)
    sd["lstm.bias_hh_l0"] = torch.zeros(4 * n)
    return sd


def deepspeech_from_params(params: Mapping[str, np.ndarray], device=None) -> DeepSpeech:
    """DeepSpeech in eval mode on ``device`` (default CUDA) from the
    reference's flat parameters; the width is the one they hold."""
    dev = resolve_device(device)
    net = DeepSpeech(n_hidden=int(np.shape(params["h1_w"])[1]))
    net.load_state_dict(deepspeech_state_dict(params))
    return net.eval().to(dev)


def load_deepspeech_npz(path: str, device=None) -> DeepSpeech:
    """DeepSpeech from an npz of the reference's layout."""
    with np.load(path) as data:
        return deepspeech_from_params({k: data[k] for k in data.files}, device)


def init_deepspeech(seed: int = 0, n_hidden: int = N_HIDDEN, device=None) -> DeepSpeech:
    """Seeded weights of the reference's init (each dense weight and the
    LSTM kernel N(0, 1 / fan_in), biases 0), drawn from a CPU
    ``torch.Generator`` in the reference's layout, on ``device`` (default
    CUDA)."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)

    def dense(i, o):
        return (torch.randn((i, o), generator=g) / np.sqrt(i)).numpy()

    params = {"h1_w": dense(N_INPUT, n_hidden), "h2_w": dense(n_hidden, n_hidden),
              "h3_w": dense(n_hidden, n_hidden), "lstm_kernel": dense(2 * n_hidden, 4 * n_hidden),
              "h5_w": dense(n_hidden, n_hidden), "h6_w": dense(n_hidden, N_LOGITS)}
    params.update({k.replace("_w", "_b"): np.zeros(v.shape[1], np.float32)
                   for k, v in params.items() if k.endswith("_w")})
    params["lstm_bias"] = np.zeros(4 * n_hidden, np.float32)
    return deepspeech_from_params(params, dev)


@torch.no_grad()
def deepspeech_logits(net: DeepSpeech, wav16k: np.ndarray) -> torch.Tensor:
    """A 16 kHz wav at int16 scale -> the logits [T // 2, 29] at 50 fps,
    on the net's device."""
    dev = next(net.parameters()).device
    feats = mfcc(torch.from_numpy(np.asarray(wav16k, np.float32)).to(dev))
    return net(deepspeech_input_windows(feats))


def deepspeech_features_from_wav(net: DeepSpeech, wav: np.ndarray, sample_rate: int = 16000,
                                 video_fps: float = 25.0, num_frames: Optional[int] = None,
                                 window_size: int = 16) -> np.ndarray:
    """The whole DeepSpeech feature pipeline: resample to 16 kHz (linear),
    MFCC, context windows, logits at 50 fps, linear interpolation to the
    video fps, [N, window_size, 29] sliding windows."""
    if sample_rate != 16000:
        t_out = np.arange(int(len(wav) * 16000 / sample_rate)) / 16000.0
        t_in = np.arange(len(wav)) / float(sample_rate)
        wav = np.interp(t_out, t_in, wav)
    logits = deepspeech_logits(net, wav).cpu().numpy()
    if num_frames is None:
        num_frames = int(round(len(wav) / 16000.0 * video_fps))
    interp = interpolate_features(logits, 50.0, video_fps, num_frames)
    return sliding_windows(interp.astype(np.float32), window_size)
