"""The wav2exp audio encoder (port of dfanerf_tpu/pipeline/audio/wav2exp.py):
a Wav2Lip-style conv stack from each video frame's mel window to a 512-d
feature.

``AudioEncoder`` is NCHW and names its submodules as the reference's
PyTorch module does (``audio_encoder.{i}.conv_block.{0,1}``: Conv2d, then
BatchNorm2d), so the reference's ``audio_encoder.pth`` state dict loads
with ``load_state_dict``. BatchNorm runs in eval mode, off the running
statistics.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from dfanerf_torch.device import resolve_device
from dfanerf_torch.models.layers import init_uniform_
from dfanerf_torch.pipeline.audio.frontend import Wav2ExpHParams, melspectrogram

# (cin, cout, kernel, stride (h, w), padding, residual) per block; input
# [B, 1, 80, 16]
ENCODER_SPEC = (
    (1, 32, 3, (1, 1), 1, False),
    (32, 32, 3, (1, 1), 1, True),
    (32, 32, 3, (1, 1), 1, True),
    (32, 64, 3, (3, 1), 1, False),
    (64, 64, 3, (1, 1), 1, True),
    (64, 64, 3, (1, 1), 1, True),
    (64, 128, 3, (3, 3), 1, False),
    (128, 128, 3, (1, 1), 1, True),
    (128, 128, 3, (1, 1), 1, True),
    (128, 256, 3, (3, 2), 1, False),
    (256, 256, 3, (1, 1), 1, True),
    (256, 512, 3, (1, 1), 0, False),
    (512, 512, 1, (1, 1), 0, False),
)


class ConvBlock(nn.Module):
    """Conv2d, BatchNorm2d, the residual where marked, ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int, stride, padding: int, residual: bool):
        super().__init__()
        self.conv_block = nn.Sequential(nn.Conv2d(cin, cout, kernel, stride, padding),
                                        nn.BatchNorm2d(cout, eps=1e-5))
        self.residual = residual

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv_block(x)
        if self.residual:
            y = y + x
        return torch.relu(y)


class AudioEncoder(nn.Module):
    """[B, 1, 80, 16] mel windows -> [B, 512, 1, 1]."""

    def __init__(self):
        super().__init__()
        self.audio_encoder = nn.Sequential(*(ConvBlock(*spec) for spec in ENCODER_SPEC))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.audio_encoder(x)


def init_audio_encoder(seed: int = 0, device=None) -> AudioEncoder:
    """A seeded encoder in eval mode on ``device`` (default CUDA): each
    conv's weight and bias U(+-1/sqrt(fan_in)) from a CPU
    ``torch.Generator``, BatchNorm at its identity statistics (the
    reference's init, another PRNG)."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    return init_uniform_(AudioEncoder(), g).eval().to(dev)


def apply_audio_encoder(encoder: AudioEncoder, mel: torch.Tensor) -> torch.Tensor:
    """mel windows [B, 80, 16] -> [B, 512]."""
    out = encoder(mel[:, None])
    if out.shape[2:] != (1, 1):
        raise ValueError(f"the encoder's output is {tuple(out.shape)}, not [B, 512, 1, 1]")
    return out.flatten(1)


def audio_encoder_from_torch(sd: Mapping[str, torch.Tensor], device=None) -> AudioEncoder:
    """The encoder of a reference ``audio_encoder.pth`` state dict, in eval
    mode on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    encoder = AudioEncoder()
    encoder.load_state_dict(sd)
    return encoder.eval().to(dev)


@torch.no_grad()
def wav2exp_features(encoder: AudioEncoder, wav, hp: Wav2ExpHParams = Wav2ExpHParams()
                     ) -> torch.Tensor:
    """wav [n] -> [N_frames, 512] on the encoder's device: the mel
    spectrogram, one 16-step window per video frame at ``hp.fps`` (start =
    int(80 frame / fps), the mel's 80 steps a second), one batched encode."""
    dev = next(encoder.parameters()).device
    mel = melspectrogram(torch.as_tensor(np.asarray(wav, np.float32)).to(dev), hp)  # [T, 80]
    t = int(mel.shape[0])
    n_frames = int((t - hp.mel_step_size) / 80.0 * hp.fps)
    starts = (80.0 * np.arange(n_frames) / float(hp.fps)).astype(np.int32)
    idx = torch.from_numpy(starts[:, None] + np.arange(hp.mel_step_size)[None, :]).to(dev)
    return apply_audio_encoder(encoder, mel[idx].transpose(1, 2))  # windows [N, 80, 16]
