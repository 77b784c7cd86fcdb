"""Conditioning-signal encoders (port of dfanerf_tpu/models/encoders.py):
AudioNet_W2L, the DeepSpeech AudioNet, ExpressionEnc, ExpressionEncHalf and
AudioAttNet. They run once per frame; their outputs become per-frame
constants folded into the decoder's biases.
"""

from __future__ import annotations

import torch
from torch import nn

from dfanerf_torch.models.layers import Conv1d, leaky_relu


class AudioNetW2L(nn.Module):
    """512 -> 256 -> 128 -> 64 MLP over wav2exp features, LeakyReLU(0.02)."""

    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(512, 256)
        self.fc2 = nn.Linear(256, 128)
        self.fc3 = nn.Linear(128, 64)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = leaky_relu(self.fc1(x))
        x = leaky_relu(self.fc2(x))
        return self.fc3(x)


class ExpressionEnc(nn.Module):
    """64 -> 32 -> 32 MLP over disentangled expression codes."""

    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(64, 32)
        self.fc2 = nn.Linear(32, 32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(leaky_relu(self.fc1(x)))


class ExpressionEncHalf(nn.Module):
    """64 -> 32 -> 64 MLP, the identity-width variant of ExpressionEnc."""

    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(64, 32)
        self.fc2 = nn.Linear(32, 64)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(leaky_relu(self.fc1(x)))


class AudioNet(nn.Module):
    """The DeepSpeech path's encoder: [N, 16, 29] windows of logits (or one
    window [16, 29]), centre-cropped to ``win_size`` around index 8, through
    four stride-2 conv1d over time (channel-last), then 64 -> 64 -> dim_aud."""

    def __init__(self, dim_aud: int = 76):
        super().__init__()
        self.conv1 = Conv1d(29, 32, 3, stride=2, padding=1)
        self.conv2 = Conv1d(32, 32, 3, stride=2, padding=1)
        self.conv3 = Conv1d(32, 64, 3, stride=2, padding=1)
        self.conv4 = Conv1d(64, 64, 3, stride=2, padding=1)
        self.fc1 = nn.Linear(64, 64)
        self.fc2 = nn.Linear(64, dim_aud)

    def forward(self, x: torch.Tensor, win_size: int = 16) -> torch.Tensor:
        if x.ndim == 2:
            return self.forward(x[None], win_size)[0]
        half = win_size // 2
        x = x[:, 8 - half:8 + half, :]
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            x = leaky_relu(conv(x))
        x = leaky_relu(self.fc1(x[:, 0, :]))
        return self.fc2(x)


class AudioAttNet(nn.Module):
    """Temporal attention over a fixed window: a conv1d stack squashes the
    window's first ``dim_aud`` channels to one logit per frame, a Linear +
    softmax weights the frames, and the raw window features are averaged."""

    def __init__(self, dim_aud: int = 96, seq_len: int = 8):
        super().__init__()
        self.conv1 = Conv1d(dim_aud, 16, 3, padding=1)
        self.conv2 = Conv1d(16, 8, 3, padding=1)
        self.conv3 = Conv1d(8, 4, 3, padding=1)
        self.conv4 = Conv1d(4, 2, 3, padding=1)
        self.conv5 = Conv1d(2, 1, 3, padding=1)
        self.att_fc = nn.Linear(seq_len, seq_len)

    def forward(self, x: torch.Tensor, dim_aud: int) -> torch.Tensor:
        """x [seq_len, D] -> [D]."""
        seq_len = x.shape[0]
        y = x[None, :, :dim_aud]  # [1, seq_len, dim_aud], channel-last
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4, self.conv5):
            y = leaky_relu(conv(y))
        logits = self.att_fc(y.reshape(1, seq_len))
        att = torch.softmax(logits, dim=1).reshape(seq_len, 1)
        return torch.sum(att * x, dim=0)
