"""BiSeNet face parser, 19 classes (port of
dfanerf_tpu/models/perception/bisenet.py; the module tree and its keys are
face_parsing/model.py + resnet.py's, so 79999_iter.pth loads as it is).

- A ResNet-18 context path; in this fork feat8 from layer2 doubles as the
  spatial path (model.py:240-244).
- Attention refinement on feat16 and feat32 with a global-context head,
  nearest upsampling between the scales.
- A feature fusion module merging feat8 with the refined 1/8 context.
- Three output heads upsampled bilinearly with align_corners=True.

Pipeline step 3 takes the main head's argmax.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dfanerf_torch.models.perception.common import (
    ConvBN, StateDict, load_net, put_bn, put_conv, resize_bilinear_align, resize_nearest,
)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.downsample = (ConvBN(cin, cout, 1, stride, relu=False)
                           if cin != cout or stride != 1 else None)

    def forward(self, x):
        r = F.relu(self.bn1(self.conv1(x)))
        r = self.bn2(self.conv2(r))
        sc = x if self.downsample is None else self.downsample(x)
        return F.relu(sc + r)


class Resnet18(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        for li, (cin, cout, stride) in enumerate(
                [(64, 64, 1), (64, 128, 2), (128, 256, 2), (256, 512, 2)], start=1):
            setattr(self, f"layer{li}", nn.Sequential(BasicBlock(cin, cout, stride),
                                                       BasicBlock(cout, cout, 1)))

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        x = self.layer1(x)
        feat8 = self.layer2(x)
        feat16 = self.layer3(feat8)
        return feat8, feat16, self.layer4(feat16)


class AttentionRefinementModule(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = ConvBN(cin, cout, 3, 1, 1, named=True)
        self.conv_atten = nn.Conv2d(cout, cout, 1, bias=False)
        self.bn_atten = nn.BatchNorm2d(cout)

    def forward(self, x):
        feat = self.conv(x)
        atten = feat.mean(dim=(2, 3), keepdim=True)
        return feat * torch.sigmoid(self.bn_atten(self.conv_atten(atten)))


class ContextPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet = Resnet18()
        self.arm16 = AttentionRefinementModule(256, 128)
        self.arm32 = AttentionRefinementModule(512, 128)
        self.conv_head32 = ConvBN(128, 128, 3, 1, 1, named=True)
        self.conv_head16 = ConvBN(128, 128, 3, 1, 1, named=True)
        self.conv_avg = ConvBN(512, 128, 1, 1, 0, named=True)

    def forward(self, x):
        feat8, feat16, feat32 = self.resnet(x)
        avg = self.conv_avg(feat32.mean(dim=(2, 3), keepdim=True))
        feat32_sum = self.arm32(feat32) + resize_nearest(avg, feat32.shape[2:])
        feat32_up = self.conv_head32(resize_nearest(feat32_sum, feat16.shape[2:]))
        feat16_sum = self.arm16(feat16) + feat32_up
        feat16_up = self.conv_head16(resize_nearest(feat16_sum, feat8.shape[2:]))
        return feat8, feat16_up, feat32_up


class FeatureFusionModule(nn.Module):
    def __init__(self, cin: int = 256, cout: int = 256):
        super().__init__()
        self.convblk = ConvBN(cin, cout, 1, 1, 0, named=True)
        self.conv1 = nn.Conv2d(cout, cout // 4, 1, bias=False)
        self.conv2 = nn.Conv2d(cout // 4, cout, 1, bias=False)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        atten = feat.mean(dim=(2, 3), keepdim=True)
        atten = torch.sigmoid(self.conv2(F.relu(self.conv1(atten))))
        return feat * atten + feat


class BiSeNetOutput(nn.Module):
    def __init__(self, cin: int, cmid: int, n_classes: int, bias: bool = False):
        super().__init__()
        self.conv = ConvBN(cin, cmid, 3, 1, 1, named=True)
        self.conv_out = nn.Conv2d(cmid, n_classes, 1, bias=bias)

    def forward(self, x):
        return self.conv_out(self.conv(x))


class BiSeNet(nn.Module):
    """[N, 3, H, W] normalised images -> three [N, n_classes, H, W] logit maps
    (main, aux16, aux32). The shipped heads have no bias; ``out_bias`` gives
    the main head's last conv one, which the reference's converter reads
    where a checkpoint holds it."""

    def __init__(self, n_classes: int = 19, out_bias: bool = False):
        super().__init__()
        self.cp = ContextPath()
        self.ffm = FeatureFusionModule(256, 256)
        self.conv_out = BiSeNetOutput(256, 256, n_classes, out_bias)
        self.conv_out16 = BiSeNetOutput(128, 64, n_classes)
        self.conv_out32 = BiSeNetOutput(128, 64, n_classes)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        hw = x.shape[2:]
        feat8, feat16_up, feat32_up = self.cp(x)
        feat_fuse = self.ffm(feat8, feat16_up)
        return (resize_bilinear_align(self.conv_out(feat_fuse), hw),
                resize_bilinear_align(self.conv_out16(feat16_up), hw),
                resize_bilinear_align(self.conv_out32(feat32_up), hw))


def load_bisenet(spec: str, device=None) -> BiSeNet:
    """79999_iter.pth or ``random:<seed>``, in eval mode on ``device``
    (default CUDA); a bias on the main head's last conv loads where the
    checkpoint holds one."""
    return load_net(spec, lambda sd: BiSeNet(out_bias="conv_out.conv_out.bias" in sd), device)


def bisenet_state_dict_from_jax(params: Mapping) -> StateDict:
    """The reference's parameter tree (numpy leaves) -> this module's state
    dict: the inverse of ``bisenet_from_torch``."""
    sd: StateDict = {}

    def convbn(name, p):
        put_conv(sd, f"{name}.conv", p["conv"])
        put_bn(sd, f"{name}.bn", p["bn"])

    res = params["resnet"]
    put_conv(sd, "cp.resnet.conv1", res["conv1"])
    put_bn(sd, "cp.resnet.bn1", res["bn1"])
    for li in range(1, 5):
        for b, p in enumerate(res[f"layer{li}"]):
            name = f"cp.resnet.layer{li}.{b}"
            for k in ("1", "2"):
                put_conv(sd, f"{name}.conv{k}", p[f"conv{k}"])
                put_bn(sd, f"{name}.bn{k}", p[f"bn{k}"])
            if "down_conv" in p:
                put_conv(sd, f"{name}.downsample.0", p["down_conv"])
                put_bn(sd, f"{name}.downsample.1", p["down_bn"])
    for arm in ("arm16", "arm32"):
        convbn(f"cp.{arm}.conv", params[arm]["conv"])
        put_conv(sd, f"cp.{arm}.conv_atten", params[arm]["conv_atten"])
        put_bn(sd, f"cp.{arm}.bn_atten", params[arm]["bn_atten"])
    for k in ("conv_head32", "conv_head16", "conv_avg"):
        convbn(f"cp.{k}", params[k])
    convbn("ffm.convblk", params["ffm"]["convblk"])
    put_conv(sd, "ffm.conv1", params["ffm"]["conv1"])
    put_conv(sd, "ffm.conv2", params["ffm"]["conv2"])
    for k in ("conv_out", "conv_out16", "conv_out32"):
        convbn(f"{k}.conv", params[k]["conv"])
        put_conv(sd, f"{k}.conv_out", params[k]["conv_out"])
    return sd
