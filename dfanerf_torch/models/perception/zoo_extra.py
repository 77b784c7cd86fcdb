"""The face-alignment zoo's other architecture families (port of
dfanerf_tpu/models/perception/zoo_extra.py; the module trees and keys are
data_util/face-alignment/lib/models' files', as the reference's
``*_from_torch`` converters read them). In the reference's order:

- ``PoseResNet`` 18 / 34 / 50 / 101 / 152 (ResNet trunk + transposed-conv
  head; pose_resnet.py) and ``PoseFaceResNet`` (two heads, concatenated);
- ``DReLU`` (dynamic ReLU type B: a pooled FC predicts per-channel
  (alpha, beta) pairs, the activation is max_k(alpha_k x + beta_k)), the
  MobileNetV2-DReLU backbone and ``FaceMobilenetDReLU``'s regress /
  heatmap / aux heads;
- ``MobileHead`` (bilinear upsampling + fixed-padding inverted residuals);
- ``FaceMobilenetDenseReg`` and the staged ``FaceMobilenetStaged``
  (eyeBranch / mutiScale) regress variants;
- ``FAN``: the stacked hourglass with CoordConv;
- ``MobileHRNet``: HRNet's skeleton with biased, fixed-padding inverted
  residuals and a nearest-upsampling SUM fuse;
- ``EyeNetGeneral`` (the eye family's knobs: RGB, brow channels, the
  gaussian-modulation conv, extra encoder / decoder layers) and
  ``EyeGhostnetRegress`` (coordinates, no heatmaps);
- ``PoseMobilenet``, ``FaceMobilenetDeconv`` and ``FaceMobilenetOld``;
- ``CenterMobilenet``: multi-scale MobileNetV2 features, a grouped-deconv
  FPN and per-task heads (a sigmoid on ``hm``).

Each family's ``*_state_dict_from_jax`` inverts the reference's converter.
Where the reference's module has a width its converter does not pin, it is
a constant here: ``EYE_BRANCH_CHANNELS``, ``MLP_HIDDEN``,
``MOBILE_HRNET_LAYER1``, ``EYE_REGRESS_HIDDEN`` (a checkpoint of other
widths needs them changed).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dfanerf_torch.models.perception.common import (
    ConvBN, ConvBNAct, StateDict, _t, put_bn, put_conv, put_convbn, put_deconv, put_linear,
    UpsampleLinear, resize_nearest,
)
from dfanerf_torch.models.perception.ghostnet_eye import (
    GhostBottleneck, _divisible, eye_net_state_dict_from_jax, put_ghost_bottleneck,
)
from dfanerf_torch.models.perception.ghostnet_face import GhostEncoderDecoder
from dfanerf_torch.models.perception.mobilenet import (
    _block_plan, indexed, mnv2_blocks, put_mnv2,
)

# --------------------------------------------------------------------------
# PoseResNet
# --------------------------------------------------------------------------

# depth -> (block kind, blocks per stage)
RESNET_SPEC = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}
_STAGE_PLANES = (64, 128, 256, 512)


def _deconv_pad(kernel: int) -> Tuple[int, int]:
    """(padding, output_padding) of a stride-2 deconvolution (pose_resnet.py
    _get_deconv_cfg)."""
    return {4: (1, 0), 3: (1, 1), 2: (0, 0)}[kernel]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = _downsample(cin, planes, stride)

    def forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = _downsample(cin, planes * 4, stride)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


def _downsample(cin: int, cout: int, stride: int) -> Optional[nn.Module]:
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False), nn.BatchNorm2d(cout))


def deconv_stack(cin: int, filters: Sequence[int], kernels: Sequence[int],
                 bias: bool = False) -> Tuple[nn.Sequential, int]:
    """(ConvTranspose2d stride 2, BatchNorm, ReLU) per layer: keys 3i, 3i + 1."""
    layers: List[nn.Module] = []
    for cout, k in zip(filters, kernels):
        pad, opad = _deconv_pad(k)
        layers += [nn.ConvTranspose2d(cin, cout, k, 2, pad, opad, bias=bias),
                   nn.BatchNorm2d(cout), nn.ReLU()]
        cin = cout
    return nn.Sequential(*layers), cin


def _final_conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=1 if k == 3 else 0)


class PoseResNet(nn.Module):
    """[N, 3, H, W] -> heatmaps [N, num_joints, H/4, W/4] (a /32 trunk, x2
    per deconvolution)."""

    def __init__(self, depth: int = 50, num_joints: int = 17,
                 deconv_filters: Sequence[int] = (256, 256, 256),
                 deconv_kernels: Sequence[int] = (4, 4, 4), final_kernel: int = 1,
                 deconv_with_bias: bool = False):
        super().__init__()
        kind, layers = RESNET_SPEC[depth]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for si, n in enumerate(layers):
            planes, stride = _STAGE_PLANES[si], 1 if si == 0 else 2
            blocks = []
            for bi in range(n):
                blocks.append(block(inplanes, planes, stride if bi == 0 else 1))
                inplanes = planes * block.expansion
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
        self.trunk_channels = inplanes
        self.deconv_layers, c = deconv_stack(inplanes, deconv_filters, deconv_kernels,
                                             deconv_with_bias)
        self.final_layer = _final_conv(c, num_joints, final_kernel)

    def trunk(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))

    def forward(self, x):
        return self.final_layer(self.deconv_layers(self.trunk(x)))


class PoseFaceResNet(PoseResNet):
    """The PoseResNet trunk with a pose head and a face head, their heatmaps
    concatenated: [N, num_joints + num_face_joints, H/4, W/4]."""

    def __init__(self, depth: int = 18, num_joints: int = 17, num_face_joints: int = 68,
                 deconv_filters: Sequence[int] = (256, 256, 256),
                 deconv_kernels: Sequence[int] = (4, 4, 4), final_kernel: int = 1,
                 deconv_with_bias: bool = False):
        super().__init__(depth, num_joints, deconv_filters, deconv_kernels, final_kernel,
                         deconv_with_bias)
        self.face_deconv_layers, c = deconv_stack(self.trunk_channels, deconv_filters,
                                                  deconv_kernels, deconv_with_bias)
        self.face_final_layer = _final_conv(c, num_face_joints, final_kernel)

    def forward(self, x):
        h = self.trunk(x)
        return torch.cat([self.final_layer(self.deconv_layers(h)),
                          self.face_final_layer(self.face_deconv_layers(h))], dim=1)


def _put_deconvs(sd: StateDict, prefix: str, deconvs: Sequence[Mapping]) -> None:
    for i, d in enumerate(deconvs):
        put_deconv(sd, f"{prefix}.{3 * i}", d["deconv"])
        put_bn(sd, f"{prefix}.{3 * i + 1}", d["bn"])


def pose_resnet_state_dict_from_jax(params: Mapping) -> StateDict:
    """The inverse of the reference's ``pose_resnet_from_torch`` (and, with
    the face head's entries, of ``pose_face_resnet_from_torch``)."""
    sd: StateDict = {}
    put_convbn(sd, "conv1", "bn1", params["stem"])
    for si, blocks in enumerate(params["stages"]):
        for bi, b in enumerate(blocks):
            pre = f"layer{si + 1}.{bi}"
            for k in ("1", "2", "3"):
                if f"conv{k}" in b:
                    put_convbn(sd, f"{pre}.conv{k}", f"{pre}.bn{k}", b[f"conv{k}"])
            if "downsample" in b:
                put_convbn(sd, f"{pre}.downsample.0", f"{pre}.downsample.1", b["downsample"])
    _put_deconvs(sd, "deconv_layers", params["deconvs"])
    put_conv(sd, "final_layer", params["final"])
    if "face_deconvs" in params:
        _put_deconvs(sd, "face_deconv_layers", params["face_deconvs"])
        put_conv(sd, "face_final_layer", params["face_final"])
    return sd


# --------------------------------------------------------------------------
# DReLU and the MobileNetV2-DReLU face net
# --------------------------------------------------------------------------


class DReLU(nn.Module):
    """Dynamic ReLU, type B, k = 2: per (sample, channel) the max of k affine
    pieces whose coefficients come from a global-pool FC. ``init_param_*``
    are the reference's frozen parameters, buffers here."""

    def __init__(self, channels: int, k: int = 2, ratio: int = 8):
        super().__init__()
        self.k = k
        self.fc = nn.Sequential(nn.Linear(channels, channels // ratio), nn.ReLU(),
                                nn.Linear(channels // ratio, 2 * k * channels))
        self.register_buffer("init_param_alpha", torch.tensor([1.0] + [0.0] * (k - 1)))
        self.register_buffer("init_param_beta", torch.zeros(k))
        self.register_buffer("init_param_gamma", torch.tensor([1.0, 0.5]))

    def forward(self, x):
        b, c = x.shape[:2]
        y = 2.0 * torch.sigmoid(self.fc(x.mean(dim=(2, 3)))) - 1.0
        y = y.reshape(b, 2, c, self.k)
        alpha = self.init_param_alpha + self.init_param_gamma[0] * y[:, 0]  # [b, c, k]
        beta = self.init_param_beta + self.init_param_gamma[1] * y[:, 1]
        out = x[..., None] * alpha[:, :, None, None] + beta[:, :, None, None]
        return out.amax(dim=-1)


def put_drelu(sd: StateDict, prefix: str, p: Mapping) -> None:
    """A DReLU leaf of the reference's tree into ``sd`` at ``prefix``."""
    put_linear(sd, f"{prefix}.fc.0", p["fc1"])
    put_linear(sd, f"{prefix}.fc.2", p["fc2"])
    for name, key in (("alpha", "alpha0"), ("beta", "beta0"), ("gamma", "gamma")):
        sd[f"{prefix}.init_param_{name}"] = _t(p[key])


def _put_act_drelu(sd, prefix, q):
    put_drelu(sd, prefix, q["drelu"])


SPLIT = 14  # before_layer3 = features[:14] (96 channels, 1/16), layer4 = features[14:]


def _split_backbone(net: nn.Module, width_mult: float = 1.0, drelu: bool = False) -> None:
    """A MobileNetV2 stack on ``net`` as ``before_layer3`` and ``layer4``,
    keeping the original indices (nn.Sequential slicing does)."""
    blocks = mnv2_blocks(width_mult, act=DReLU) if drelu else mnv2_blocks(width_mult)
    net.before_layer3 = indexed(blocks, range(SPLIT))
    net.layer4 = indexed(blocks, range(SPLIT, len(blocks)))


def _split_name(i: int) -> str:
    return f"before_layer3.{i}" if i < SPLIT else f"layer4.{i}"


def _pooled_fc(fc_out: int, cin: int) -> nn.Sequential:
    """``fc_layers``: a parameter-free slot, then the Linear (key ``.1``)."""
    return nn.Sequential(nn.Identity(), nn.Linear(cin, fc_out))


class FaceMobilenetDReLU(nn.Module):
    """MobileNetV2-DReLU (c3 = features[:14], c4 = features[14:]) with
    whichever of the regress (pooled c4 -> FC), heatmap (deconvolutions on
    c4) and aux heatmap (deconvolutions on c3) heads it is built with; the
    output is a dict."""

    def __init__(self, num_joints: int = 68, width_mult: float = 1.0, use_regress: bool = True,
                 use_heatmap: bool = True, use_aux: bool = True,
                 deconv_filters: Sequence[int] = (256, 256, 256),
                 deconv_kernels: Sequence[int] = (4, 4, 4), final_kernel: int = 1,
                 deconv_with_bias: bool = False, drelu: bool = True):
        super().__init__()
        _, last = _block_plan(width_mult)
        c3_ch = _block_plan(width_mult)[0][SPLIT - 1][2]
        _split_backbone(self, width_mult, drelu)
        if use_regress:
            self.fc_layers = _pooled_fc(num_joints * 2, last)
        if use_heatmap:
            self.deconv_layers, c = deconv_stack(last, deconv_filters, deconv_kernels,
                                                 deconv_with_bias)
            self.deconv_final_layer = _final_conv(c, num_joints, final_kernel)
        if use_aux:
            self.aux_deconv_layers, c = deconv_stack(c3_ch, deconv_filters[1:],
                                                     deconv_kernels[1:], deconv_with_bias)
            self.aux_deconv_final_layer = _final_conv(c, num_joints, final_kernel)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        c3 = self.before_layer3(x)
        c4 = self.layer4(c3)
        out = {}
        if hasattr(self, "fc_layers"):
            out["regress"] = self.fc_layers(c4.mean(dim=(2, 3)))
        if hasattr(self, "deconv_layers"):
            out["heatmap"] = self.deconv_final_layer(self.deconv_layers(c4))
        if hasattr(self, "aux_deconv_layers"):
            out["heatmap_aux"] = self.aux_deconv_final_layer(self.aux_deconv_layers(c3))
        return out


def _put_heads(sd: StateDict, params: Mapping) -> None:
    if "fc" in params:
        put_linear(sd, "fc_layers.1", params["fc"])
    if "deconvs" in params:
        _put_deconvs(sd, "deconv_layers", params["deconvs"])
        put_conv(sd, "deconv_final_layer", params["final"])
    if "aux_deconvs" in params:
        _put_deconvs(sd, "aux_deconv_layers", params["aux_deconvs"])
        put_conv(sd, "aux_deconv_final_layer", params["aux_final"])


def face_mobilenet_drelu_state_dict_from_jax(params: Mapping,
                                             width_mult: float = 1.0) -> StateDict:
    """The inverse of the reference's ``face_mobilenet_drelu_from_torch``."""
    sd: StateDict = {}
    put_mnv2(sd, params["backbone"]["blocks"], width_mult, _split_name, _put_act_drelu)
    _put_heads(sd, params)
    return sd


# --------------------------------------------------------------------------
# MobileHead
# --------------------------------------------------------------------------

MOBILE_HEAD_SETTING = ((3, 256, 3, 2), (3, 128, 3, 2), (3, 64, 3, 1))


def _fixed_pad(kernel_size: int, dilation: int = 1) -> Tuple[int, int, int, int]:
    """mobile_block.py fixed_padding: SAME-style, the odd pixel at the end."""
    eff = kernel_size + (kernel_size - 1) * (dilation - 1)
    beg = (eff - 1) // 2
    end = eff - 1 - beg
    return (beg, end, beg, end)


class MobileBlock(nn.Module):
    """mobile_block.py InvertedResidual at stride 1: the block's input padded
    (fixed padding), then [expand 1x1 ConvBNReLU6], depthwise k x k
    ConvBNReLU6 (no padding), project ConvBN; hidden width capped at 768;
    the input added back when the channels match."""

    def __init__(self, cin: int, planes: int, k: int, expand: float):
        super().__init__()
        hidden = min(round(cin * expand), 768)
        layers: List[nn.Module] = []
        if expand != 1:
            layers += [nn.Conv2d(cin, hidden, 1, bias=False), nn.BatchNorm2d(hidden),
                       nn.ReLU6()]
        layers += [nn.Conv2d(hidden, hidden, k, groups=hidden, bias=False),
                   nn.BatchNorm2d(hidden), nn.ReLU6(),
                   nn.Conv2d(hidden, planes, 1, bias=False), nn.BatchNorm2d(planes)]
        self.conv = nn.Sequential(*layers)
        self.pad = _fixed_pad(k)
        self.use_res = cin == planes

    def forward(self, x):
        h = self.conv(F.pad(x, self.pad))
        return x + h if self.use_res else h



class MobileHead(nn.Module):
    """Per stage a bilinear upsampling by ``upsample_scale`` (half-pixel
    centres) and ``nums`` MobileBlocks, then a 1x1 final conv."""

    def __init__(self, inp: int, out: int, setting=MOBILE_HEAD_SETTING, upsample_scale: int = 2):
        super().__init__()
        layers: List[nn.Module] = []
        for expand, planes, k, nums in setting:
            layers.append(UpsampleLinear(upsample_scale))
            for _ in range(nums):
                layers.append(MobileBlock(inp, planes, k, expand))
                inp = planes
        self.mobile_module = nn.Sequential(*layers)
        self.final_layer = nn.Conv2d(inp, out, 1)

    def forward(self, x):
        return self.final_layer(self.mobile_module(x))


def mobile_head_state_dict_from_jax(params: Mapping, setting=MOBILE_HEAD_SETTING,
                                    prefix: str = "") -> StateDict:
    """The inverse of the reference's ``mobile_head_from_torch``."""
    pfx = f"{prefix}." if prefix else ""
    sd: StateDict = {}
    seq, bi = 0, 0
    for expand, planes, k, nums in setting:
        seq += 1  # the upsampling's slot
        for _ in range(nums):
            base, b = f"{pfx}mobile_module.{seq}.conv", params["blocks"][bi]
            idx = ((0, 1), (3, 4), (6, 7)) if expand != 1 else ((None, None), (0, 1), (3, 4))
            for key, (c, n) in zip(("expand", "dw", "project"), idx):
                if c is not None:
                    put_convbn(sd, f"{base}.{c}", f"{base}.{n}", b[key])
            seq, bi = seq + 1, bi + 1
    put_conv(sd, f"{pfx}final_layer", params["final"])
    return sd


# --------------------------------------------------------------------------
# FaceMobilenet regress variants: denseReg, eyeBranch, mutiScale
# --------------------------------------------------------------------------


class FaceMobilenetDenseReg(nn.Module):
    """c3 = features[:14] (``before_layer3``); regress = a 1x1 conv on c3
    (``dense``) or an FC on pooled c3; with ``aux`` a deconvolution heatmap
    head on c3. (The reference's heatmap branch reads an undefined c4 and
    cannot run; it is not built.)"""

    def __init__(self, num_joints: int = 68, dense: bool = True, aux: bool = True,
                 width_mult: float = 1.0, deconv_filters: Sequence[int] = (256, 256),
                 deconv_kernels: Sequence[int] = (4, 4), final_kernel: int = 1):
        super().__init__()
        self.dense = dense
        c3_ch = _block_plan(width_mult)[0][SPLIT - 1][2]
        self.before_layer3 = nn.Sequential(*mnv2_blocks(width_mult, n_blocks=SPLIT))
        n_out = num_joints * 2
        self.last_regress_layer = (nn.Conv2d(c3_ch, n_out, 1) if dense
                                   else _pooled_fc(n_out, c3_ch))
        if aux:
            self.aux_deconv_layers, c = deconv_stack(c3_ch, deconv_filters, deconv_kernels)
            self.aux_deconv_final_layer = _final_conv(c, num_joints, final_kernel)

    def forward(self, x):
        c3 = self.before_layer3(x)
        out = {"regress": self.last_regress_layer(c3 if self.dense else c3.mean(dim=(2, 3)))}
        if hasattr(self, "aux_deconv_layers"):
            out["heatmap_aux"] = self.aux_deconv_final_layer(self.aux_deconv_layers(c3))
        return out


def face_mobilenet_densereg_state_dict_from_jax(params: Mapping,
                                                width_mult: float = 1.0) -> StateDict:
    """The inverse of the reference's ``face_mobilenet_densereg_from_torch``."""
    sd: StateDict = {}
    put_mnv2(sd, params["backbone"]["blocks"], width_mult, lambda i: f"before_layer3.{i}")
    if "regress_conv" in params:
        put_conv(sd, "last_regress_layer", params["regress_conv"])
    else:
        put_linear(sd, "last_regress_layer.1", params["fc"])
    if "aux_deconvs" in params:
        _put_deconvs(sd, "aux_deconv_layers", params["aux_deconvs"])
        put_conv(sd, "aux_deconv_final_layer", params["aux_final"])
    return sd


# plan-index ends of down_sample / stage1 .. stage4 / final_stage
_STAGE_BOUNDS = (1, 3, 5, 8, 15, 19)
_STAGE_NAMES = ("down_sample", "stage1", "stage2", "stage3", "stage4", "final_stage")
EYE_BRANCH_CHANNELS = (128, 64, 32)  # the eyeBranch's three ConvBNReLU6 widths


class FaceMobilenetStaged(nn.Module):
    """The eyeBranch / mutiScale variants: the MobileNetV2 stack split into
    down_sample (the stem itself) and stage1 .. stage4, final_stage (original
    indices). ``eyeBranch``: the face regression on pooled final features
    and an eye branch (ConvBNReLU6 x 3, grouped 1 / 8 / 8, on stage4's
    output, pooled, FC to num_eye_joints * 4); ``mutiScale``: the regression
    on the concatenated pooled stage3 / stage4 / final features."""

    def __init__(self, variant: str = "eyeBranch", num_joints: int = 68,
                 num_eye_joints: int = 6, width_mult: float = 1.0):
        super().__init__()
        if variant not in ("eyeBranch", "mutiScale"):
            raise ValueError(f"unknown variant {variant!r}")
        self.variant = variant
        plan, last = _block_plan(width_mult)
        blocks = mnv2_blocks(width_mult)
        self.down_sample = blocks[0]
        start = 1
        for name, stop in zip(_STAGE_NAMES[1:], _STAGE_BOUNDS[1:]):
            setattr(self, name, indexed(blocks, range(start, stop)))
            start = stop
        ch = [plan[stop - 1][2] for stop in _STAGE_BOUNDS]  # each group's output channels
        if variant == "eyeBranch":
            self.fc_layers = _pooled_fc(num_joints * 2, last)
            convs, cin = [], ch[4]
            for i, c in enumerate(EYE_BRANCH_CHANNELS):
                convs.append(ConvBNAct(cin, c, 3, groups=1 if i == 0 else 8))
                cin = c
            self.s4_conv_layer = nn.Sequential(*convs)
            self.s4_fc_layers = _pooled_fc(num_eye_joints * 4, cin)
        else:
            self.fc_layers = _pooled_fc(num_joints * 2, ch[3] + ch[4] + last)

    def forward(self, x):
        feats = []
        for name in _STAGE_NAMES:
            x = getattr(self, name)(x)
            feats.append(x)
        if self.variant == "eyeBranch":
            hp = self.s4_conv_layer(feats[4]).mean(dim=(2, 3))
            return {"regress": self.fc_layers(feats[5].mean(dim=(2, 3))),
                    "s4_regress": self.s4_fc_layers(hp)}
        multi = torch.cat([f.mean(dim=(2, 3)) for f in feats[3:]], dim=1)
        return {"regress": self.fc_layers(multi)}


def _staged_name(i: int) -> str:
    for name, stop in zip(_STAGE_NAMES, _STAGE_BOUNDS):
        if i < stop:
            return name if name == "down_sample" else f"{name}.{i}"
    raise IndexError(i)


def face_mobilenet_staged_state_dict_from_jax(params: Mapping,
                                              width_mult: float = 1.0) -> StateDict:
    """The inverse of the reference's ``face_mobilenet_staged_from_torch``."""
    sd: StateDict = {}
    put_mnv2(sd, params["backbone"]["blocks"], width_mult, _staged_name)
    if "fc" in params:
        put_linear(sd, "fc_layers.1", params["fc"])
    if "s4_conv" in params:
        for i, cb in enumerate(params["s4_conv"]):
            put_convbn(sd, f"s4_conv_layer.{i}.0", f"s4_conv_layer.{i}.1", cb)
        put_linear(sd, "s4_fc_layers.1", params["s4_fc"])
    return sd


# --------------------------------------------------------------------------
# FAN: stacked hourglass with CoordConv
# --------------------------------------------------------------------------


def add_coords(x: torch.Tensor, heatmap: Optional[torch.Tensor] = None,
               with_boundary: bool = False) -> torch.Tensor:
    """AddCoordsTh: the input, xx (varying along H, by (H-1)), yy (along W,
    by (W-1)), both in [-1, 1], and rr / max(rr) (the max over the whole
    batch); with a heatmap, xx and yy where its last channel (clamped to
    [0, 1]) exceeds 0.05, else 0."""
    n, _, h, w = x.shape
    xx = (torch.arange(h, dtype=x.dtype, device=x.device)[:, None] / (h - 1)) * 2 - 1
    yy = (torch.arange(w, dtype=x.dtype, device=x.device)[None, :] / (w - 1)) * 2 - 1
    xx = xx.expand(h, w)[None, None].expand(n, 1, h, w)
    yy = yy.expand(h, w)[None, None].expand(n, 1, h, w)
    rr = torch.sqrt(xx ** 2 + yy ** 2)
    parts = [x, xx, yy, rr / rr.max()]
    if with_boundary and heatmap is not None:
        b = heatmap[:, -1:].clamp(0.0, 1.0) > 0.05
        parts += [torch.where(b, xx, torch.zeros_like(xx)), torch.where(b, yy, torch.zeros_like(yy))]
    return torch.cat(parts, dim=1)


class CoordConv(nn.Module):
    """CoordConvTh's conv over the input and its coordinate channels (key
    ``conv``)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 boundary: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(cin + 3 + (2 if boundary else 0), cout, k, stride, padding)


class ConvBlock(nn.Module):
    """face_net.py ConvBlock: three BN-ReLU-3x3 conv stages (out/2, out/4,
    out/4 channels, concatenated) and a BN-ReLU-1x1 shortcut when the
    channels change."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(cin)
        self.conv1 = nn.Conv2d(cin, cout // 2, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout // 2)
        self.conv2 = nn.Conv2d(cout // 2, cout // 4, 3, 1, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout // 4)
        self.conv3 = nn.Conv2d(cout // 4, cout // 4, 3, 1, 1, bias=False)
        self.downsample = (nn.Sequential(nn.BatchNorm2d(cin), nn.ReLU(),
                                         nn.Conv2d(cin, cout, 1, bias=False))
                           if cin != cout else None)

    def forward(self, x):
        o1 = self.conv1(F.relu(self.bn1(x)))
        o2 = self.conv2(F.relu(self.bn2(o1)))
        o3 = self.conv3(F.relu(self.bn3(o2)))
        res = x if self.downsample is None else self.downsample(x)
        return torch.cat([o1, o2, o3], dim=1) + res


def _avg_pool2(x):
    return F.avg_pool2d(x, 2, 2)


class HourGlass(nn.Module):
    """Depth-4 hourglass at 256 channels behind a CoordConv (with the
    boundary channels from the second module on)."""

    def __init__(self, first_one: bool, depth: int = 4, features: int = 256):
        super().__init__()
        self.depth = depth
        self.coordconv = CoordConv(features, features, 1, boundary=not first_one)
        for level in range(depth, 0, -1):
            for name in ("b1", "b2", "b3"):
                setattr(self, f"{name}_{level}", ConvBlock(features, features))
            if level == 1:
                self.b2_plus_1 = ConvBlock(features, features)

    def _forward(self, level, x):
        up1 = getattr(self, f"b1_{level}")(x)
        low1 = getattr(self, f"b2_{level}")(_avg_pool2(x))
        low2 = self._forward(level - 1, low1) if level > 1 else self.b2_plus_1(low1)
        low3 = getattr(self, f"b3_{level}")(low2)
        return up1 + resize_nearest(low3, tuple(up1.shape[2:]))

    def forward(self, x):
        return self._forward(self.depth, self.coordconv.conv(x))


class FAN(nn.Module):
    """[N, 3, 256, 256] -> (per module heatmaps [N, num_landmarks + 1, 64,
    64], per module boundary channels [N, 2, 64, 64])."""

    def __init__(self, num_modules: int = 1, num_landmarks: int = 68, end_relu: bool = False):
        super().__init__()
        self.num_modules, self.end_relu = num_modules, end_relu
        self.conv1 = CoordConv(3, 64, 7, 2, 3)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = ConvBlock(64, 128)
        self.conv3 = ConvBlock(128, 128)
        self.conv4 = ConvBlock(128, 256)
        n_out = num_landmarks + 1
        for i in range(num_modules):
            setattr(self, f"m{i}", HourGlass(first_one=i == 0))
            setattr(self, f"top_m_{i}", ConvBlock(256, 256))
            setattr(self, f"conv_last{i}", nn.Conv2d(256, 256, 1))
            setattr(self, f"bn_end{i}", nn.BatchNorm2d(256))
            setattr(self, f"l{i}", nn.Conv2d(256, n_out, 1))
            if i < num_modules - 1:
                setattr(self, f"bl{i}", nn.Conv2d(256, 256, 1))
                setattr(self, f"al{i}", nn.Conv2d(n_out, 256, 1))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1.conv(add_coords(x))))
        h = self.conv4(self.conv3(_avg_pool2(self.conv2(h))))
        previous, tmp_out = h, None
        outputs, boundaries = [], []
        for i in range(self.num_modules):
            hg_in = add_coords(previous, tmp_out, with_boundary=True)
            hg = getattr(self, f"m{i}")(hg_in)
            ll = getattr(self, f"top_m_{i}")(hg)
            ll = F.relu(getattr(self, f"bn_end{i}")(getattr(self, f"conv_last{i}")(ll)))
            tmp_out = getattr(self, f"l{i}")(ll)
            if self.end_relu:
                tmp_out = F.relu(tmp_out)
            outputs.append(tmp_out)
            boundaries.append(hg_in[:, -2:])
            if i < self.num_modules - 1:
                previous = (previous + getattr(self, f"bl{i}")(ll)
                            + getattr(self, f"al{i}")(tmp_out))
        return outputs, boundaries


def fan_state_dict_from_jax(params: Mapping) -> StateDict:
    """The inverse of the reference's ``fan_from_torch``."""
    sd: StateDict = {}

    def convblock(prefix, p):
        for k in ("1", "2", "3"):
            put_bn(sd, f"{prefix}.bn{k}", p[f"bn{k}"])
            put_conv(sd, f"{prefix}.conv{k}", p[f"conv{k}"])
        if "down" in p:
            put_bn(sd, f"{prefix}.downsample.0", p["down"]["bn"])
            put_conv(sd, f"{prefix}.downsample.2", p["down"]["conv"])

    put_conv(sd, "conv1.conv", params["conv1"])
    put_bn(sd, "bn1", params["bn1"])
    for k in ("conv2", "conv3", "conv4"):
        convblock(k, params[k])
    i = 0
    while f"m{i}" in params:
        m = params[f"m{i}"]
        put_conv(sd, f"m{i}.coordconv.conv", m["coordconv"])
        for key, p in m.items():
            if key != "coordconv":
                convblock(f"m{i}.{key}", p)
        convblock(f"top_m_{i}", params[f"top_m_{i}"])
        put_conv(sd, f"conv_last{i}", params[f"conv_last{i}"])
        put_bn(sd, f"bn_end{i}", params[f"bn_end{i}"])
        for k in ("l", "bl", "al"):
            if f"{k}{i}" in params:
                put_conv(sd, f"{k}{i}", params[f"{k}{i}"])
        i += 1
    return sd


# --------------------------------------------------------------------------
# Mobile HRNet
# --------------------------------------------------------------------------

# (num_modules, num_branches, num_blocks_per_branch, channels) per stage
MOBILE_HRNET_STAGES = (
    (1, 2, (4, 4), (18, 36)),
    (4, 3, (4, 4, 4), (18, 36, 72)),
    (3, 4, (4, 4, 4, 4), (18, 36, 72, 144)),
)
MOBILE_HRNET_LAYER1 = 64  # layer1's MobileIR width


class MobileIR(nn.Module):
    """pose_mobile_hrnet.py InvertedResidual: expansion 6, 3x3, biased convs,
    ReLU6, the block's input padded by 1 (so the 1x1 expand sees the zero
    border) and the depthwise conv unpadded."""

    def __init__(self, cin: int, cout: int, stride: int = 1, expansion: int = 6):
        super().__init__()
        h = cin * expansion
        self.conv = nn.Sequential(
            nn.Conv2d(cin, h, 1), nn.BatchNorm2d(h), nn.ReLU6(),
            nn.Conv2d(h, h, 3, stride, 0, groups=h), nn.BatchNorm2d(h), nn.ReLU6(),
            nn.Conv2d(h, cout, 1), nn.BatchNorm2d(cout))
        self.use_res = stride == 1 and cin == cout

    def forward(self, x):
        h = self.conv(F.pad(x, (1, 1, 1, 1)))
        return x + h if self.use_res else h


def _convbn_relu(cin, cout, stride, relu=True) -> nn.Sequential:
    layers = [nn.Conv2d(cin, cout, 3, stride, 1, bias=False), nn.BatchNorm2d(cout)]
    return nn.Sequential(*layers, nn.ReLU()) if relu else nn.Sequential(*layers)


class _HRModule(nn.Module):
    def __init__(self, n_blocks, channels, multi_out: bool):
        super().__init__()
        nb = len(channels)
        self.branches = nn.ModuleList(
            nn.Sequential(*[MobileIR(c, c) for _ in range(n)]) for n, c in zip(n_blocks, channels))
        rows = []
        for i in range(nb if multi_out else 1):
            row = []
            for j in range(nb):
                if j == i:
                    row.append(None)
                elif j > i:
                    row.append(nn.Sequential(nn.Conv2d(channels[j], channels[i], 1, bias=False),
                                             nn.BatchNorm2d(channels[i])))
                else:
                    row.append(nn.Sequential(*[
                        _convbn_relu(channels[j], channels[i] if k == i - j - 1 else channels[j],
                                     2, relu=k < i - j - 1) for k in range(i - j)]))
            rows.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(rows)

    def forward(self, xs):
        bs = [br(x) for br, x in zip(self.branches, xs)]
        outs = []
        for i, row in enumerate(self.fuse_layers):
            y = None
            for j, f in enumerate(row):
                if j == i:
                    c = bs[j]
                elif j > i:
                    c = resize_nearest(f(bs[j]), tuple(bs[i].shape[2:]))
                else:
                    c = f(bs[j])
                y = c if y is None else y + c
            outs.append(F.relu(y))
        return outs


class MobileHRNet(nn.Module):
    """[N, 3, H, W] -> heatmaps [N, num_joints, H/4, W/4]: a /4 stem, 4
    MobileIR blocks (layer1, ``layer1_channels`` wide), three HR stages
    of MobileIR branches with SUM fuses, the final conv on branch 0."""

    def __init__(self, stages=MOBILE_HRNET_STAGES, num_joints: int = 17):
        super().__init__()
        c1 = MOBILE_HRNET_LAYER1
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(64)
        self.layer1 = nn.Sequential(MobileIR(64, c1), *[MobileIR(c1, c1) for _ in range(3)])
        prev = [c1]
        for si, (n_mod, n_br, n_blocks, channels) in enumerate(stages):
            trans = []
            for bi in range(n_br):
                if bi < len(prev):
                    trans.append(_convbn_relu(prev[-1], channels[bi], 1)
                                 if prev[bi] != channels[bi] else None)
                else:
                    trans.append(nn.Sequential(_convbn_relu(prev[-1], channels[bi], 2)))
            setattr(self, f"transition{si + 1}", nn.ModuleList(trans))
            setattr(self, f"stage{si + 2}", nn.ModuleList(
                _HRModule(n_blocks, channels,
                          multi_out=not (si == len(stages) - 1 and mi == n_mod - 1))
                for mi in range(n_mod)))
            prev = list(channels)
        self.final_layer = nn.Conv2d(prev[0], num_joints, 1)
        self.n_stages = len(stages)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.layer1(F.relu(self.bn2(self.conv2(h))))
        feats = [h]
        for si in range(self.n_stages):
            # a transition reads the last branch before it
            feats = [feats[bi] if t is None else t(feats[-1])
                     for bi, t in enumerate(getattr(self, f"transition{si + 1}"))]
            for mod in getattr(self, f"stage{si + 2}"):
                feats = mod(feats)
        return self.final_layer(feats[0])


def mobile_hrnet_state_dict_from_jax(params: Mapping) -> StateDict:
    """The inverse of the reference's ``mobile_hrnet_from_torch``."""
    sd: StateDict = {}

    def ir(prefix, p):
        for key, (c, b) in (("pw1", (0, 1)), ("dw", (3, 4)), ("pw2", (6, 7))):
            put_convbn(sd, f"{prefix}.conv.{c}", f"{prefix}.conv.{b}", p[key])

    for k in ("1", "2"):
        put_conv(sd, f"conv{k}", params[f"conv{k}"])
        put_bn(sd, f"bn{k}", params[f"bn{k}"])
    for i, p in enumerate(params["layer1"]):
        ir(f"layer1.{i}", p)
    si, n_prev = 0, 1
    while f"transition{si + 1}" in params:
        for bi, t in enumerate(params[f"transition{si + 1}"]):
            base = f"transition{si + 1}.{bi}"
            if t is not None and bi < n_prev:  # an existing branch's: one ConvBNReLU
                put_convbn(sd, f"{base}.0", f"{base}.1", t[0])
            elif t is not None:  # a new branch's: a list of them
                for k, cb in enumerate(t):
                    put_convbn(sd, f"{base}.{k}.0", f"{base}.{k}.1", cb)
        for mi, mod in enumerate(params[f"stage{si + 2}"]):
            mb = f"stage{si + 2}.{mi}"
            for bi, blocks in enumerate(mod["branches"]):
                for k, p in enumerate(blocks):
                    ir(f"{mb}.branches.{bi}.{k}", p)
            for i, row in enumerate(mod["fuse"]):
                for j, f in enumerate(row):
                    fb = f"{mb}.fuse_layers.{i}.{j}"
                    if f is None:
                        continue
                    if j > i:
                        put_convbn(sd, f"{fb}.0", f"{fb}.1", f)
                    else:
                        for k, cb in enumerate(f):
                            put_convbn(sd, f"{fb}.{k}.0", f"{fb}.{k}.1", cb)
        n_prev = len(params[f"stage{si + 2}"][0]["branches"])
        si += 1
    put_conv(sd, "final_layer", params["final"])
    return sd


# --------------------------------------------------------------------------
# The eye family: general encoder-decoder, coordinate regression
# --------------------------------------------------------------------------

EYE_ENCODER_SETS = (
    (3, 16, 16, 0, 1), (3, 48, 24, 0, 2), (3, 72, 24, 0, 1),
    (5, 72, 40, 1, 2), (5, 120, 40, 1, 1), (3, 240, 80, 0, 2),
)
EYE_ENCODER_ADD_SETS = (
    (3, 200, 80, 0, 1), (3, 184, 80, 0, 1), (3, 184, 80, 0, 1),
    (3, 480, 112, 1, 1), (3, 672, 112, 1, 1),
)
EYE_DECODER_SETS = ((4, 120, 40, 1, 2), (4, 72, 40, 1, 2), (4, 72, 24, 1, 2))
EYE_DECODER_ADD_SETS = ((4, 184, 80, 1, 2), (4, 120, 80, 1, 2), (4, 72, 40, 1, 2))
BROW_JOINTS = 9


def eye_net_sets(addition_encoder: int = 0, addition_decoder: bool = False):
    """get_eye_net's set tables."""
    enc = list(EYE_ENCODER_SETS)
    if addition_encoder:
        enc += list(EYE_ENCODER_ADD_SETS[:addition_encoder])
    dec = list(EYE_DECODER_ADD_SETS if addition_decoder else EYE_DECODER_SETS)
    return tuple(enc), tuple(dec)


class EyeNetGeneral(GhostEncoderDecoder):
    """The eye encoder-decoder family (eye_encoder_decoder.py / _half.py):
    grayscale or RGB input, 6 eye heatmaps (+ 9 brow ones with ``brow``),
    extra encoder / decoder layers, and the gaussian-modulation conv with
    ``gaussian_sigma`` > 0. Input [N, in_ch, 32, 48]."""

    def __init__(self, rgb: bool = False, brow: bool = False, num_joints: int = 6,
                 gaussian_sigma: float = 0.0, addition_encoder: int = 0,
                 addition_decoder: bool = False):
        super().__init__(3 if rgb else 1, *eye_net_sets(addition_encoder, addition_decoder),
                         num_joints + (BROW_JOINTS if brow else 0), gaussian_sigma)


def eye_net_general_state_dict_from_jax(params: Mapping) -> StateDict:
    """The inverse of the reference's ``eye_net_general_from_torch``."""
    return eye_net_state_dict_from_jax(params)


EYE_GHOSTNET_SETS = (
    (3, 16, 16, 0, 1), (3, 48, 24, 0, 2), (3, 72, 24, 0, 1),
    (5, 72, 40, 1, 2), (5, 120, 40, 1, 1),
)
EYE_FULL_GHOSTNET_SETS = EYE_GHOSTNET_SETS + (
    (3, 240, 80, 0, 2), (3, 200, 80, 0, 1), (3, 184, 80, 0, 1),
)
EYE_REGRESS_HIDDEN = 1280  # the classifier's hidden width (GhostNet's)


class EyeGhostnetRegress(nn.Module):
    """eye_ghostnet.py / eye_fullGhostnet.py: the encoder bottlenecks, a 1x1
    ConvBNReLU squeeze to the last set's hidden width, a global mean, then
    Linear (no bias) + BatchNorm1d + ReLU + Linear to 2 K coordinates."""

    def __init__(self, sets=EYE_GHOSTNET_SETS, in_ch: int = 1, num_joints: int = 6):
        super().__init__()
        hidden = EYE_REGRESS_HIDDEN
        layers, inp = [ConvBN(in_ch, 16, 3, 2, 1)], 16
        for k, h, c, use_se, s in sets:
            layers.append(GhostBottleneck(inp, _divisible(h), _divisible(c), k, s, use_se))
            inp = _divisible(c)
        self.features = nn.Sequential(*layers)
        sq = _divisible(sets[-1][1])
        self.squeeze = ConvBN(inp, sq, 1)
        self.classifier = nn.Sequential(nn.Linear(sq, hidden, bias=False), nn.BatchNorm1d(hidden),
                                        nn.ReLU(), nn.Identity(), nn.Linear(hidden, 2 * num_joints))

    def forward(self, x):
        return self.classifier(self.squeeze(self.features(x)).mean(dim=(2, 3)))


def eye_ghostnet_regress_state_dict_from_jax(params: Mapping) -> StateDict:
    """The inverse of the reference's ``eye_ghostnet_regress_from_torch``."""
    sd: StateDict = {}
    put_convbn(sd, "features.0.0", "features.0.1", params["stem"])
    for i, p in enumerate(params["features"]):
        put_ghost_bottleneck(sd, f"features.{i + 1}", p)
    put_convbn(sd, "squeeze.0", "squeeze.1", params["squeeze"])
    put_linear(sd, "classifier.0", params["cls1"])
    put_bn(sd, "classifier.1", params["cls_bn"])
    put_linear(sd, "classifier.4", params["cls2"])
    return sd


# --------------------------------------------------------------------------
# PoseMobilenet, FaceMobilenet-Deconv, FaceMobilenet-Old
# --------------------------------------------------------------------------


def _funnel(last: int) -> nn.Sequential:
    """``intermediate_layers``: 1x1 ConvBNReLU6 last -> 320 -> 64."""
    return nn.Sequential(ConvBNAct(last, 320, 1), ConvBNAct(320, 64, 1))


MLP_HIDDEN = (512, 256)  # the flatten heads' two hidden widths


def _mlp(n_in: int, n_out: int) -> nn.Sequential:
    """``fc_layers``: Linear layers at keys 1, 4 and 6 with ReLUs between
    (the parameter-free slots are the reference's flatten and dropout)."""
    a, b = MLP_HIDDEN
    return nn.Sequential(nn.Identity(), nn.Linear(n_in, a), nn.ReLU(), nn.Identity(),
                         nn.Linear(a, b), nn.ReLU(), nn.Linear(b, n_out))


class PoseMobilenet(nn.Module):
    """The plain MobileNetV2 stack split at 14 (``before_layer3`` /
    ``layer4``), a funnel + flatten MLP regress head and a deconvolution
    heatmap head on c4 (input [N, 3, *image_size])."""

    def __init__(self, num_joints: int = 68, image_size: Tuple[int, int] = (64, 64),
                 width_mult: float = 1.0, use_regress: bool = True, use_heatmap: bool = True,
                 deconv_filters: Sequence[int] = (256, 256, 256),
                 deconv_kernels: Sequence[int] = (4, 4, 4), final_kernel: int = 1):
        super().__init__()
        _, last = _block_plan(width_mult)
        _split_backbone(self, width_mult)
        if use_regress:
            self.intermediate_layers = _funnel(last)
            n_flat = 64 * (image_size[0] // 32) * (image_size[1] // 32)
            self.fc_layers = _mlp(n_flat, 2 * num_joints)
        if use_heatmap:
            self.deconv_layers, c = deconv_stack(last, deconv_filters, deconv_kernels)
            self.deconv_final_layer = _final_conv(c, num_joints, final_kernel)

    def forward(self, x):
        c4 = self.layer4(self.before_layer3(x))
        out = {}
        if hasattr(self, "fc_layers"):
            out["regress"] = self.fc_layers(self.intermediate_layers(c4).flatten(1))
        if hasattr(self, "deconv_layers"):
            out["heatmap"] = self.deconv_final_layer(self.deconv_layers(c4))
        return out


def _put_funnel(sd: StateDict, params: Mapping) -> None:
    for i, cb in enumerate(params["inter"]):
        put_convbn(sd, f"intermediate_layers.{i}.0", f"intermediate_layers.{i}.1", cb)
    for i, lin in zip((1, 4, 6), params["fcs"]):
        put_linear(sd, f"fc_layers.{i}", lin)


def pose_mobilenet_state_dict_from_jax(params: Mapping, width_mult: float = 1.0) -> StateDict:
    """The inverse of the reference's ``pose_mobilenet_from_torch``."""
    sd: StateDict = {}
    put_mnv2(sd, params["backbone"]["blocks"], width_mult, _split_name)
    if "inter" in params:
        _put_funnel(sd, params)
    if "deconvs" in params:
        _put_deconvs(sd, "deconv_layers", params["deconvs"])
        put_conv(sd, "deconv_final_layer", params["final"])
    return sd


class FaceMobilenetDeconv(FaceMobilenetDReLU):
    """face_mobilenet.py's deconvolution heads (use_mobile_head=False) on the
    plain ReLU6 stack: regress, heatmap and aux heatmap, as
    ``FaceMobilenetDReLU`` without its dynamic activation."""

    def __init__(self, num_joints: int = 68, width_mult: float = 1.0, **heads):
        super().__init__(num_joints, width_mult, drelu=False, **heads)


def face_mobilenet_deconv_state_dict_from_jax(params: Mapping,
                                              width_mult: float = 1.0) -> StateDict:
    """The inverse of the reference's ``face_mobilenet_deconv_from_torch``."""
    sd: StateDict = {}
    put_mnv2(sd, params["backbone"]["blocks"], width_mult, _split_name)
    _put_heads(sd, params)
    return sd


class FaceMobilenetOld(nn.Module):
    """face_mobilenet_old.py: the unsplit stack (``features``), the funnel
    and the flatten MLP: [N, 3, *image_size] -> [N, 2 num_joints]."""

    def __init__(self, num_joints: int = 68, image_size: Tuple[int, int] = (64, 64),
                 width_mult: float = 1.0):
        super().__init__()
        _, last = _block_plan(width_mult)
        self.features = nn.Sequential(*mnv2_blocks(width_mult))
        self.intermediate_layers = _funnel(last)
        self.fc_layers = _mlp(64 * (image_size[0] // 32) * (image_size[1] // 32), 2 * num_joints)

    def forward(self, x):
        return self.fc_layers(self.intermediate_layers(self.features(x)).flatten(1))


def face_mobilenet_old_state_dict_from_jax(params: Mapping, width_mult: float = 1.0) -> StateDict:
    """The inverse of the reference's ``face_mobilenet_old_from_torch``."""
    sd: StateDict = {}
    put_mnv2(sd, params["backbone"]["blocks"], width_mult, lambda i: f"features.{i}")
    _put_funnel(sd, params)
    return sd


# --------------------------------------------------------------------------
# CenterMobilenet
# --------------------------------------------------------------------------

# plan indices after which a feature map is emitted (base.feature_1 / _2 / _4 / _6)
_CENTER_FEAT_SPLITS = (3, 6, 13, 17)
_CENTER_GROUPS = (1, 2, 4, 6)
_CENTER_FEAT_CHANNELS = (24, 32, 96, 320)
DEFAULT_CENTER_HEADS = (("hm", 2), ("hm_offset", 4), ("landmarks", 36), ("densewh", 4))


class _Up(nn.Module):
    def __init__(self, cin: int, c: int):
        super().__init__()
        self.up = nn.Sequential(nn.ConvTranspose2d(c, c, 2, 2, 0, groups=c, bias=False),
                                nn.BatchNorm2d(c, eps=1e-3), nn.ReLU())
        self.conv = ConvBNAct(cin, c, 1, act=nn.ReLU(), eps=1e-3)

    def forward(self, y, skip):
        return self.up(y) + self.conv(skip)


class _DLAUp(nn.Module):
    def __init__(self, head_conv: int):
        super().__init__()
        self.conv = ConvBNAct(_CENTER_FEAT_CHANNELS[-1], head_conv, 1, act=nn.ReLU(), eps=1e-3)
        for i, c in enumerate(_CENTER_FEAT_CHANNELS[-2::-1]):
            setattr(self, f"up_{i}", _Up(c, head_conv))
        self.conv_last = ConvBNAct(head_conv, head_conv, 3, act=nn.ReLU())

    def forward(self, feats):
        y = self.conv(feats[-1])
        for i, skip in enumerate(feats[-2::-1]):
            y = getattr(self, f"up_{i}")(y, skip)
        return self.conv_last(y)


class CenterMobilenet(nn.Module):
    """[N, 3, H, W] -> dict of head maps at H/4 (sigmoid on ``hm``)."""

    def __init__(self, heads: Sequence[Tuple[str, int]] = DEFAULT_CENTER_HEADS,
                 head_conv: int = 24):
        super().__init__()
        blocks = mnv2_blocks(n_blocks=_CENTER_FEAT_SPLITS[-1] + 1)
        self.base = nn.Module()
        start = 0
        for g, stop in zip(_CENTER_GROUPS, _CENTER_FEAT_SPLITS):
            setattr(self.base, f"feature_{g}", nn.Sequential(*blocks[start:stop + 1]))
            start = stop + 1
        self.dla_up = _DLAUp(head_conv)
        self.heads = [name for name, _ in heads]
        for name, c in heads:
            setattr(self, name, nn.Conv2d(head_conv, c, 1))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        feats = []
        for g in _CENTER_GROUPS:
            x = getattr(self.base, f"feature_{g}")(x)
            feats.append(x)
        y = self.dla_up(feats)
        out = {}
        for name in self.heads:
            o = getattr(self, name)(y)
            out[name] = torch.sigmoid(o) if name == "hm" else o
        return out


def center_mobilenet_state_dict_from_jax(params: Mapping) -> StateDict:
    """The inverse of the reference's ``center_mobilenet_from_torch``."""
    def base(i):
        start = 0
        for g, stop in zip(_CENTER_GROUPS, _CENTER_FEAT_SPLITS):
            if i <= stop:
                return f"base.feature_{g}.{i - start}"
            start = stop + 1
        raise IndexError(i)

    sd: StateDict = {}
    put_mnv2(sd, params["backbone"]["blocks"], 1.0, base)
    put_convbn(sd, "dla_up.conv.0", "dla_up.conv.1", params["up_conv"])
    for i, stage in enumerate(params["fpn"]):
        w = stage["up"]["deconv"]["w"]
        put_deconv(sd, f"dla_up.up_{i}.up.0", stage["up"]["deconv"], groups=w.shape[-1])
        put_bn(sd, f"dla_up.up_{i}.up.1", stage["up"]["bn"])
        put_convbn(sd, f"dla_up.up_{i}.conv.0", f"dla_up.up_{i}.conv.1", stage["lateral"])
    put_convbn(sd, "dla_up.conv_last.0", "dla_up.conv_last.1", params["conv_last"])
    for name, p in params["heads"].items():
        put_conv(sd, name, p)
    return sd
