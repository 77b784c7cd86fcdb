"""HRNet-W18 facial-landmark heatmap net (port of
dfanerf_tpu/models/perception/hrnet.py; the module tree and its keys are
lib/models/face_hrnet.py's, so the shipped checkpoint loads as it is).

The shipped 300w_lp_menpo2D/hrnet_hm.yaml configuration: 4 stages, branch
channels 18/36/72/144, BASIC blocks, SUM fusion, a 68-joint head over
every branch upsampled and concatenated. The fuse and head upsampling is
bilinear with half-pixel centres (``jax.image.resize`` 'linear' in the
reference; on these exact 2^k upsamplings both are
``F.interpolate(align_corners=False)``). ``pose_hrnet_config`` selects
lib/models/pose_hrnet.py: nearest fuse upsampling and one conv head on the
highest-resolution branch.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dfanerf_torch.models.perception.common import (
    ConvBN, StateDict, load_net, put_bn, put_conv, put_convbn, resize_linear, resize_nearest,
)


@dataclasses.dataclass(frozen=True)
class HRNetConfig:
    """The shipped hrnet_hm.yaml EXTRA block (face variant)."""

    num_joints: int = 68
    final_conv_kernel: int = 1
    # (num_modules, num_branches, blocks_per_branch, channels)
    stage2: Tuple = (1, 2, (4, 4), (18, 36))
    stage3: Tuple = (4, 3, (4, 4, 4), (18, 36, 72))
    stage4: Tuple = (3, 4, (4, 4, 4, 4), (18, 36, 72, 144))
    head: str = "face"        # "face" (concat head) | "pose" (branch-0 conv)
    up_mode: str = "linear"   # fuse upsampling: "linear" | "nearest"


def pose_hrnet_config(num_joints: int = 68, final_conv_kernel: int = 1) -> HRNetConfig:
    """PoseHighResolutionNet (lib/models/pose_hrnet.py get_pose_net)."""
    return HRNetConfig(num_joints=num_joints, final_conv_kernel=final_conv_kernel,
                       head="pose", up_mode="nearest")


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.downsample = (ConvBN(cin, cout, 1, stride, relu=False)
                           if stride != 1 or cin != cout else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        cout = planes * 4
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.downsample = (ConvBN(cin, cout, 1, stride, relu=False)
                           if stride != 1 or cin != cout else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class HRModule(nn.Module):
    """Parallel branches of BASIC blocks, then every output row fuses all
    branches (``n_out`` rows: 1 is the pose variant's multi_scale_output=
    False)."""

    def __init__(self, n_blocks, channels, n_out: Optional[int] = None, up_mode: str = "linear"):
        super().__init__()
        n = len(channels)
        self.up_mode = up_mode
        self.branches = nn.ModuleList(
            nn.Sequential(*[BasicBlock(channels[b], channels[b]) for _ in range(n_blocks[b])])
            for b in range(n))
        rows = []
        for i in range(n if n_out is None else n_out):
            row: List[Optional[nn.Module]] = []
            for j in range(n):
                if j > i:
                    row.append(ConvBN(channels[j], channels[i], 1, relu=False))
                elif j == i:
                    row.append(None)
                else:
                    row.append(nn.Sequential(*[
                        ConvBN(channels[j], channels[i] if k == i - j - 1 else channels[j], 3, 2, 1,
                               relu=k < i - j - 1)
                        for k in range(i - j)]))
            rows.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(rows)

    def forward(self, xs):
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        resize = resize_linear if self.up_mode == "linear" else resize_nearest
        out = []
        for i, row in enumerate(self.fuse_layers):
            y = None
            for j, f in enumerate(row):
                if j == i:
                    t = xs[j]
                elif j > i:
                    t = resize(f(xs[j]), xs[i].shape[2:])
                else:
                    t = f(xs[j])
                y = t if y is None else y + t
            out.append(F.relu(y))
        return out


class HRNet(nn.Module):
    """[N, 3, 256, 256] normalised face crops -> heatmaps [N, 68, 64, 64]."""

    def __init__(self, cfg: HRNetConfig = HRNetConfig()):
        super().__init__()
        self.cfg = cfg
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(64)
        self.layer1 = nn.Sequential(Bottleneck(64, 64), *[Bottleneck(256, 64) for _ in range(3)])
        prev = [256]
        for s, (n_mod, n_br, n_blocks, channels) in enumerate(
                (cfg.stage2, cfg.stage3, cfg.stage4), start=2):
            trans: List[Optional[nn.Module]] = []
            for i in range(n_br):
                if i < len(prev):
                    trans.append(ConvBN(prev[i], channels[i], 3, 1, 1)
                                 if prev[i] != channels[i] else None)
                else:
                    trans.append(nn.Sequential(*[
                        ConvBN(prev[-1], channels[i] if j == i - len(prev) else prev[-1], 3, 2, 1)
                        for j in range(i + 1 - len(prev))]))
            setattr(self, f"transition{s - 1}", nn.ModuleList(trans))
            # the pose head reads branch 0 only: the last module fuses into it alone
            single = cfg.head == "pose" and s == 4
            setattr(self, f"stage{s}", nn.Sequential(*[
                HRModule(n_blocks, channels, 1 if single and m == n_mod - 1 else None, cfg.up_mode)
                for m in range(n_mod)]))
            prev = list(channels)
        pad = 1 if cfg.final_conv_kernel == 3 else 0
        if cfg.head == "pose":
            self.final_layer = nn.Conv2d(prev[0], cfg.num_joints, cfg.final_conv_kernel, 1, pad)
        else:
            total = sum(prev)
            self.head = nn.Sequential(
                nn.Conv2d(total, total, 1), nn.BatchNorm2d(total), nn.ReLU(),
                nn.Conv2d(total, cfg.num_joints, cfg.final_conv_kernel, 1, pad))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        feats = [self.layer1(x)]
        for s in (2, 3, 4):
            trans = getattr(self, f"transition{s - 1}")
            feats = [feats[i] if t is None else t(feats[i] if i < len(feats) else feats[-1])
                     for i, t in enumerate(trans)]
            for mod in getattr(self, f"stage{s}"):
                feats = mod(feats)
        if self.cfg.head == "pose":
            return self.final_layer(feats[0])
        hw = feats[0].shape[2:]
        x = torch.cat([feats[0]] + [resize_linear(f, hw) for f in feats[1:]], dim=1)
        return self.head(x)


def hrnet_config_from_state_dict(sd: Mapping[str, torch.Tensor]) -> HRNetConfig:
    """The configuration a checkpoint was made with: the number of modules,
    branches and blocks of each stage and the branch channels, read off its
    keys and shapes (the head kind from its head's keys)."""
    stages = []
    for s in (2, 3, 4):
        mods = {int(m.group(1)) for k in sd if (m := re.match(rf"stage{s}\.(\d+)\.", k))}
        n_mod = max(mods) + 1
        brs = {int(m.group(1)) for k in sd
               if (m := re.match(rf"stage{s}\.0\.branches\.(\d+)\.", k))}
        n_br = max(brs) + 1
        blocks = tuple(1 + max(int(m.group(1)) for k in sd
                               if (m := re.match(rf"stage{s}\.0\.branches\.{b}\.(\d+)\.", k)))
                       for b in range(n_br))
        chans = tuple(int(sd[f"stage{s}.0.branches.{b}.0.conv1.weight"].shape[0])
                      for b in range(n_br))
        stages.append((n_mod, n_br, blocks, chans))
    if "final_layer.weight" in sd:
        w = sd["final_layer.weight"]
        return dataclasses.replace(pose_hrnet_config(int(w.shape[0]), int(w.shape[-1])),
                                   stage2=stages[0], stage3=stages[1], stage4=stages[2])
    w = sd["head.3.weight"]
    return HRNetConfig(num_joints=int(w.shape[0]), final_conv_kernel=int(w.shape[-1]),
                       stage2=stages[0], stage3=stages[1], stage4=stages[2])


def load_hrnet(spec: str, device=None) -> HRNet:
    """A checkpoint (its configuration read off its keys) or ``random:<seed>``
    (the shipped configuration), in eval mode on ``device`` (default CUDA)."""
    return load_net(spec, lambda sd: HRNet(hrnet_config_from_state_dict(sd) if sd
                                           else HRNetConfig()), device)


def hrnet_state_dict_from_jax(params: Mapping) -> StateDict:
    """The reference's parameter tree (numpy leaves) -> this module's state
    dict: the inverse of ``hrnet_from_torch``."""
    sd: StateDict = {}

    def block(prefix, p):
        for k in ("1", "2", "3"):
            if f"conv{k}" in p:
                put_conv(sd, f"{prefix}.conv{k}", p[f"conv{k}"])
                put_bn(sd, f"{prefix}.bn{k}", p[f"bn{k}"])
        if "downsample" in p:
            put_convbn(sd, f"{prefix}.downsample.0", f"{prefix}.downsample.1", p["downsample"])

    for k in ("1", "2"):
        put_conv(sd, f"conv{k}", params[f"conv{k}"])
        put_bn(sd, f"bn{k}", params[f"bn{k}"])
    for i, p in enumerate(params["layer1"]):
        block(f"layer1.{i}", p)
    for s in (2, 3, 4):
        tname = f"transition{s - 1}"
        for i, t in enumerate(params[tname]):
            if t is None:
                continue
            if "convbn" in t:
                put_convbn(sd, f"{tname}.{i}.0", f"{tname}.{i}.1", t["convbn"])
            else:
                for j, q in enumerate(t["down"]):
                    put_convbn(sd, f"{tname}.{i}.{j}.0", f"{tname}.{i}.{j}.1", q)
        for m, mod in enumerate(params[f"stage{s}"]):
            for b, blocks in enumerate(mod["branches"]):
                for k, p in enumerate(blocks):
                    block(f"stage{s}.{m}.branches.{b}.{k}", p)
            for i, row in enumerate(mod["fuse"]):
                for j, f in enumerate(row):
                    base = f"stage{s}.{m}.fuse_layers.{i}.{j}"
                    if f is None:
                        continue
                    if "up" in f:
                        put_convbn(sd, f"{base}.0", f"{base}.1", f["up"])
                    else:
                        for k, q in enumerate(f["down"]):
                            put_convbn(sd, f"{base}.{k}.0", f"{base}.{k}.1", q)
    if "final" in params:
        put_conv(sd, "final_layer", params["final"])
    else:
        put_conv(sd, "head.0", params["head"]["conv1"])
        put_bn(sd, "head.1", params["head"]["bn1"])
        put_conv(sd, "head.3", params["head"]["conv2"])
    return sd
