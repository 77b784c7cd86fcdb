"""NN primitives (port of dfanerf_tpu/models/layers.py).

Linear layers are ``nn.Linear`` (weight [out, in]; the reference package
stores [in, out] — compat/from_jax.py transposes). ``Conv1d`` keeps the
reference's channel-last semantics at its interface: [N, L, C_in] in,
[N, L', C_out] out. Initialization follows torch's default for both (weight
and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in))), drawn from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Conv1d(nn.Conv1d):
    """1-D convolution over channel-last input [N, L, C_in] -> [N, L', C_out]."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.02) -> torch.Tensor:
    """LeakyReLU with the reference's 0.02 slope default."""
    return F.leaky_relu(x, negative_slope)


@torch.no_grad()
def init_uniform_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """torch's default Linear/Conv1d/Conv2d init, U(+-1/sqrt(fan_in)) for
    weight and bias, drawn in module order from ``generator``."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
    return module
