"""GhostNet eye-landmark encoder-decoder (port of
dfanerf_tpu/models/perception/ghostnet_eye.py; the module tree and its
keys are lib/models/eye_encoder_decoder_300w.py's).

The shipped eye_300w_menpo/ghostnet_en_de.yaml configuration: a grayscale
48x32 eye crop -> 6-keypoint heatmaps at 24x16, through GhostModules (a
primary conv plus cheap depthwise 'ghost' features), SE layers with a gate
clamped to [0, 1], and a decoder of 2x bilinear upsamplings (half-pixel
centres, ``jax.image.resize`` 'linear' in the reference) each followed by
a bottleneck.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
from torch import nn

from dfanerf_torch.models.perception.common import (
    ConvBN, StateDict, UpsampleLinear, load_net, put_bn, put_conv, put_convbn, put_linear,
)

# (kernel, hidden, out, use_se, stride): get_eye_net's encoder and decoder sets
ENCODER_SETS = [
    (3, 16, 16, 0, 1),
    (3, 48, 24, 0, 2),
    (3, 72, 24, 0, 1),
    (5, 72, 40, 1, 2),
    (5, 120, 40, 1, 1),
    (3, 240, 80, 0, 2),
]
DECODER_SETS = [  # each preceded by a 2x bilinear upsampling
    (4, 120, 40, 1, 2),
    (4, 72, 40, 1, 2),
    (4, 72, 24, 1, 2),
]
NUM_EYE_JOINTS = 6


def _divisible(v, divisor=4):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class GhostModule(nn.Module):
    def __init__(self, inp: int, oup: int, kernel: int = 1, dw_size: int = 3, relu: bool = True):
        super().__init__()
        self.oup = oup
        init_ch = math.ceil(oup / 2)
        self.primary_conv = ConvBN(inp, init_ch, kernel, 1, kernel // 2, relu=relu)
        self.cheap_operation = ConvBN(init_ch, init_ch, dw_size, 1, dw_size // 2, relu=relu,
                                      groups=init_ch)

    def forward(self, x):
        x1 = self.primary_conv(x)
        return torch.cat([x1, self.cheap_operation(x1)], dim=1)[:, :self.oup]


class SELayer(nn.Module):
    def __init__(self, ch: int, reduction: int = 4):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(ch, ch // reduction), nn.ReLU(),
                                nn.Linear(ch // reduction, ch))

    def forward(self, x):
        y = self.fc(x.mean(dim=(2, 3))).clamp(0.0, 1.0)
        return x * y[:, :, None, None]


class GhostBottleneck(nn.Module):
    def __init__(self, inp: int, hidden: int, oup: int, kernel: int, stride: int, use_se: bool):
        super().__init__()
        self.conv = nn.Sequential(
            GhostModule(inp, hidden, relu=True),
            ConvBN(hidden, hidden, kernel, stride, kernel // 2, relu=False, groups=hidden)
            if stride == 2 else nn.Sequential(),
            SELayer(hidden) if use_se else nn.Sequential(),
            GhostModule(hidden, oup, relu=False))
        self.shortcut = nn.Sequential() if stride == 1 and inp == oup else nn.Sequential(
            ConvBN(inp, inp, 3, stride, 1, relu=True, groups=inp),
            nn.Conv2d(inp, oup, 1, bias=False), nn.BatchNorm2d(oup))

    def forward(self, x):
        return self.conv(x) + self.shortcut(x)



class EyeNet(nn.Module):
    """[N, 1, 32, 48] grayscale eye crops in [0, 1] -> heatmaps [N, 6, 16, 24]."""

    def __init__(self):
        super().__init__()
        layers = [ConvBN(1, 16, 3, 2, 1)]
        inp = 16
        for k, hidden, c, use_se, s in ENCODER_SETS:
            layers.append(GhostBottleneck(inp, _divisible(hidden), _divisible(c), k, s, use_se))
            inp = _divisible(c)
        self.features = nn.Sequential(*layers)
        head = []
        for k, hidden, c, use_se, _ in DECODER_SETS:
            head += [UpsampleLinear(),
                     GhostBottleneck(inp, _divisible(hidden), _divisible(c), k, 1, use_se)]
            inp = _divisible(c)
        self.head = nn.Sequential(*head)
        self.final_layer = nn.Conv2d(inp, NUM_EYE_JOINTS, 1)

    def forward(self, x):
        return self.final_layer(self.head(self.features(x)))


def load_eye_net(spec: str, device=None) -> EyeNet:
    """The eye net's checkpoint or ``random:<seed>``, in eval mode on
    ``device`` (default CUDA)."""
    return load_net(spec, lambda sd: EyeNet(), device)


def put_ghost_bottleneck(sd: StateDict, prefix: str, p: Mapping) -> None:
    """One GhostBottleneck of the reference's tree into ``sd`` at ``prefix``."""
    def ghost(pre, q):
        put_convbn(sd, f"{pre}.primary_conv.0", f"{pre}.primary_conv.1", q["primary"])
        put_convbn(sd, f"{pre}.cheap_operation.0", f"{pre}.cheap_operation.1", q["cheap"])

    ghost(f"{prefix}.conv.0", p["ghost1"])
    if "dw" in p:
        put_convbn(sd, f"{prefix}.conv.1.0", f"{prefix}.conv.1.1", p["dw"])
    if "se" in p:
        put_linear(sd, f"{prefix}.conv.2.fc.0", p["se"]["fc1"])
        put_linear(sd, f"{prefix}.conv.2.fc.2", p["se"]["fc2"])
    ghost(f"{prefix}.conv.3", p["ghost2"])
    if "shortcut" in p:
        put_convbn(sd, f"{prefix}.shortcut.0.0", f"{prefix}.shortcut.0.1", p["shortcut"]["dw"])
        put_conv(sd, f"{prefix}.shortcut.1", p["shortcut"]["pw"]["conv"])
        put_bn(sd, f"{prefix}.shortcut.2", p["shortcut"]["pw"]["bn"])


def eye_net_state_dict_from_jax(params: Mapping) -> StateDict:
    """The reference's parameter tree (numpy leaves) -> this module's state
    dict: the inverse of ``eye_net_from_torch`` (and of the zoo's
    encoder-decoders of the same layout, which add nothing to it)."""
    sd: StateDict = {}
    put_convbn(sd, "features.0.0", "features.0.1", params["stem"])
    for i, p in enumerate(params["features"]):
        put_ghost_bottleneck(sd, f"features.{i + 1}", p)
    for i, p in enumerate(params["head"]):
        put_ghost_bottleneck(sd, f"head.{2 * i + 1}", p)
    put_conv(sd, "final_layer", params["final"])
    return sd
