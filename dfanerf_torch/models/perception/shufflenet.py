"""ShuffleNetV2 (port of dfanerf_tpu/models/perception/shufflenet.py; the
module tree and keys are torchvision's, which lib/models/shufflenetv2.py
keeps as the zoo's lightweight backbone, written out here since neither
machine has torchvision).

A 3x3 / 2 ConvBNReLU stem and a 3x3 / 2 max pool, three stages of [4, 8, 4]
blocks (the first of each stride 2, both branches transformed and
concatenated; the others stride 1, transforming the second channel half
only), each block's output channel-shuffled in 2 groups, a 1x1 conv5, a
global mean and the classifier. ``PRESETS`` holds the x0.5 .. x2.0 widths.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from dfanerf_torch.models.perception.common import StateDict, put_convbn, put_linear

PRESETS = {  # stages_repeats, stages_out_channels
    "x0.5": ((4, 8, 4), (24, 48, 96, 192, 1024)),
    "x1.0": ((4, 8, 4), (24, 116, 232, 464, 1024)),
    "x1.5": ((4, 8, 4), (24, 176, 352, 704, 1024)),
    "x2.0": ((4, 8, 4), (24, 244, 488, 976, 2048)),
}


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    n, c, h, w = x.shape
    return x.view(n, groups, c // groups, h, w).transpose(1, 2).reshape(n, c, h, w)


def _dw(c: int, stride: int) -> list:
    return [nn.Conv2d(c, c, 3, stride, 1, groups=c, bias=False), nn.BatchNorm2d(c)]


def _pw(cin: int, cout: int) -> list:
    return [nn.Conv2d(cin, cout, 1, bias=False), nn.BatchNorm2d(cout), nn.ReLU()]


class ShuffleBlock(nn.Module):
    def __init__(self, inp: int, oup: int, stride: int):
        super().__init__()
        self.stride = stride
        bf = oup // 2
        if stride > 1:
            self.branch1 = nn.Sequential(*_dw(inp, stride), *_pw(inp, bf))
        self.branch2 = nn.Sequential(*_pw(inp if stride > 1 else bf, bf), *_dw(bf, stride),
                                     *_pw(bf, bf))

    def forward(self, x):
        if self.stride == 1:
            x1, x2 = x.chunk(2, dim=1)
            out = torch.cat([x1, self.branch2(x2)], dim=1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], dim=1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(nn.Module):
    """[N, 3, H, W] -> logits [N, num_classes]."""

    def __init__(self, preset: str = "x1.0", num_classes: int = 1000):
        super().__init__()
        repeats, out_ch = PRESETS[preset]
        self.conv1 = nn.Sequential(nn.Conv2d(3, out_ch[0], 3, 2, 1, bias=False),
                                   nn.BatchNorm2d(out_ch[0]), nn.ReLU())
        inp = out_ch[0]
        for si, (rep, oc) in enumerate(zip(repeats, out_ch[1:4])):
            blocks = [ShuffleBlock(inp, oc, 2)] + [ShuffleBlock(oc, oc, 1) for _ in range(rep - 1)]
            setattr(self, f"stage{si + 2}", nn.Sequential(*blocks))
            inp = oc
        self.conv5 = nn.Sequential(nn.Conv2d(inp, out_ch[4], 1, bias=False),
                                   nn.BatchNorm2d(out_ch[4]), nn.ReLU())
        self.fc = nn.Linear(out_ch[4], num_classes)

    def forward(self, x):
        x = F.max_pool2d(self.conv1(x), 3, 2, 1)
        x = self.conv5(self.stage4(self.stage3(self.stage2(x))))
        return self.fc(x.mean(dim=(2, 3)))


def shufflenet_v2_state_dict_from_jax(params: Mapping) -> StateDict:
    """The inverse of the reference's ``shufflenet_v2_from_torch``."""
    sd: StateDict = {}
    put_convbn(sd, "conv1.0", "conv1.1", params["conv1"])
    for si in (2, 3, 4):
        for bi, p in enumerate(params[f"stage{si}"]):
            pre = f"stage{si}.{bi}"
            if "branch1" in p:
                put_convbn(sd, f"{pre}.branch1.0", f"{pre}.branch1.1", p["branch1"]["dw"])
                put_convbn(sd, f"{pre}.branch1.2", f"{pre}.branch1.3", p["branch1"]["pw"])
            for key, (c, b) in (("pw1", (0, 1)), ("dw", (3, 4)), ("pw2", (5, 6))):
                put_convbn(sd, f"{pre}.branch2.{c}", f"{pre}.branch2.{b}", p["branch2"][key])
    put_convbn(sd, "conv5.0", "conv5.1", params["conv5"])
    put_linear(sd, "fc", params["fc"])
    return sd
