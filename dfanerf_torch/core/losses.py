"""Loss and metric helpers (port of dfanerf_tpu/core/losses.py;
run_nerf_helpers.py:11-17, 506-532)."""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)


def to8b(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)


def cal_lap_loss(tensors: Sequence[torch.Tensor], weights: Sequence[float]) -> torch.Tensor:
    """Temporal-Laplacian smoothness loss: the mean squared response of the
    [-0.5, 1, -0.5] kernel along each tensor's last axis, weighted and
    summed."""
    total = 0.0
    for t, w in zip(tensors, weights):
        x = t.reshape(-1, t.shape[-1])
        out = -0.5 * x[:, :-2] + 1.0 * x[:, 1:-1] - 0.5 * x[:, 2:]
        total = total + torch.mean(out ** 2) * w
    return total


def dct_basis(k: int, n: int) -> torch.Tensor:
    """Orthonormal DCT-II basis row k of length n."""
    basis = torch.cos(math.pi * (torch.arange(n) + 0.5) * k / n)
    scale = math.sqrt(1.0 / n) if k == 0 else math.sqrt(2.0 / n)
    return basis * scale


def dct_space(k: int, n: int) -> torch.Tensor:
    """The first k DCT basis rows [k, n]."""
    return torch.stack([dct_basis(i, n) for i in range(k)])


def dct_null_space(k: int, n: int) -> torch.Tensor:
    """DCT rows k..n-1, the high-frequency complement [n - k, n]."""
    return torch.stack([dct_basis(i, n) for i in range(k, n)])
