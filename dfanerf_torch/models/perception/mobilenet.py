"""MobileNetV2 and the face-alignment zoo's MobileNetV2 heads (port of
dfanerf_tpu/models/perception/mobilenet.py; the module trees and keys are
torchvision's MobileNetV2 and lib/models/face_mobilenet*.py's).

- ``MobileNetV2``: the feature stack (``features.{i}``: a ConvBNReLU6
  stem, inverted residuals, a last 1x1 ConvBNReLU6), with the width
  multiplier of ``_make_divisible`` and ``_block_plan``. ``mnv2_blocks``
  builds the same blocks for the zoo's nets that split or rename the stack
  (their ``nn.Sequential`` slices keep the original indices).
- ``FaceMobilenetHeatmap``: the backbone to 1/32, two (x2 bilinear
  upsampling + ConvBNReLU6) stages and a 1x1 head (the reference has an
  init for it and no checkpoint converter; its keys here are ``backbone``,
  ``head1``, ``head2`` and ``final``).
- ``FaceMobilenetGhostHead``: ``before_layer3`` (features[:14], 96
  channels at 1/16), a GhostBottleneck decoder (``head_layers``, each x2
  level preceded by a parameter-free upsampling slot) and
  ``head_final_layer``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, List, Mapping, Optional, Sequence

from torch import nn

from dfanerf_torch.models.perception.common import (
    ConvBNAct, StateDict, UpsampleLinear, put_bn, put_conv, put_convbn,
    resize_linear,
)

# (expand_ratio t, channels c, repeats n, stride s): torchvision's defaults
INVERTED_RESIDUAL_SETTING = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def _make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _block_plan(width_mult: float = 1.0):
    """The feature stack: ("stem", cin, cout, k, s), ("ir", cin, cout, s, t)
    for each inverted residual, ("last", cin, cout, 1, 1); and the last
    channel count."""
    input_channel = _make_divisible(32 * width_mult)
    last_channel = _make_divisible(1280 * max(1.0, width_mult))
    plan: List = [("stem", 3, input_channel, 3, 2)]
    for t, c, n, s in INVERTED_RESIDUAL_SETTING:
        out = _make_divisible(c * width_mult)
        for i in range(n):
            plan.append(("ir", input_channel, out, s if i == 0 else 1, t))
            input_channel = out
    plan.append(("last", input_channel, last_channel, 1, 1))
    return plan, last_channel


def relu6(c: int) -> nn.Module:
    return nn.ReLU6()


class InvertedResidual(nn.Module):
    """``conv``: [expand ConvBNAct (t != 1)], depthwise ConvBNAct, project
    conv, BatchNorm; the input added back when the stride is 1 and the
    channels match."""

    def __init__(self, cin: int, cout: int, stride: int, t: int,
                 act: Callable[[int], nn.Module] = relu6):
        super().__init__()
        hidden = int(round(cin * t))
        layers: List[nn.Module] = []
        if t != 1:
            layers.append(ConvBNAct(cin, hidden, 1, act=act(hidden)))
        layers += [ConvBNAct(hidden, hidden, 3, stride, groups=hidden, act=act(hidden)),
                   nn.Conv2d(hidden, cout, 1, bias=False), nn.BatchNorm2d(cout)]
        self.conv = nn.Sequential(*layers)
        self.use_res = stride == 1 and cin == cout

    def forward(self, x):
        return x + self.conv(x) if self.use_res else self.conv(x)


def mnv2_blocks(width_mult: float = 1.0, act: Callable[[int], nn.Module] = relu6,
                n_blocks: Optional[int] = None) -> List[nn.Module]:
    """The feature stack's blocks, each activation ``act(channels)``."""
    plan, _ = _block_plan(width_mult)
    blocks = []
    for spec in plan[:n_blocks]:
        if spec[0] == "ir":
            _, cin, cout, s, t = spec
            blocks.append(InvertedResidual(cin, cout, s, t, act))
        else:
            _, cin, cout, k, s = spec
            blocks.append(ConvBNAct(cin, cout, k, s, act=act(cout)))
    return blocks


def indexed(blocks: Sequence[nn.Module], idx) -> nn.Sequential:
    """An nn.Sequential of ``blocks[i]`` for i in ``idx``, keyed by i (how a
    slice of an nn.Sequential keeps its children's names)."""
    return nn.Sequential(OrderedDict((str(i), blocks[i]) for i in idx))


def put_mnv2_block(sd: StateDict, base: str, spec, p: Mapping,
                   put_act: Optional[Callable[[StateDict, str, Mapping], None]] = None) -> None:
    """One block of the reference's MobileNetV2 tree into ``sd`` at ``base``;
    ``put_act(sd, prefix, leaf)`` puts each ConvBNAct's activation
    parameters (the dynamic-activation variant's DReLU)."""
    def convbn_act(prefix, q):
        put_convbn(sd, f"{prefix}.0", f"{prefix}.1", q)
        if put_act is not None:
            put_act(sd, f"{prefix}.2", q)

    if spec[0] != "ir":
        convbn_act(base, p["convbn"])
        return
    ci = 0
    if spec[4] != 1:
        convbn_act(f"{base}.conv.0", p["expand"])
        ci = 1
    convbn_act(f"{base}.conv.{ci}", p["dw"])
    put_conv(sd, f"{base}.conv.{ci + 1}", p["project"]["conv"])
    put_bn(sd, f"{base}.conv.{ci + 2}", p["project"]["bn"])


def put_mnv2(sd: StateDict, blocks: Sequence[Mapping], width_mult: float,
             base: Callable[[int], str], put_act=None) -> None:
    """The reference's block list into ``sd``, block i at ``base(i)``."""
    plan, _ = _block_plan(width_mult)
    for i, (spec, p) in enumerate(zip(plan, blocks)):
        put_mnv2_block(sd, base(i), spec, p, put_act)


class MobileNetV2(nn.Module):
    """[N, 3, H, W] -> features [N, 1280, H/32, W/32]."""

    def __init__(self, width_mult: float = 1.0):
        super().__init__()
        self.features = nn.Sequential(*mnv2_blocks(width_mult))

    def forward(self, x):
        return self.features(x)


def mobilenet_v2_state_dict_from_jax(params: Mapping, width_mult: float = 1.0,
                                     prefix: str = "features") -> StateDict:
    """The inverse of the reference's ``mobilenet_v2_from_torch``."""
    sd: StateDict = {}
    put_mnv2(sd, params["blocks"], width_mult, lambda i: f"{prefix}.{i}")
    return sd



class FaceMobilenetHeatmap(nn.Module):
    """[N, 3, 256, 256] -> heatmaps [N, n_joints, 64, 64]."""

    def __init__(self, n_joints: int = 68, width_mult: float = 1.0):
        super().__init__()
        _, last = _block_plan(width_mult)
        self.backbone = MobileNetV2(width_mult)
        self.head1 = ConvBNAct(last, 256, 3)
        self.head2 = ConvBNAct(256, 128, 3)
        self.final = nn.Conv2d(128, n_joints, 1)

    def forward(self, x):
        f = self.backbone(x)
        for head in (self.head1, self.head2):
            f = head(resize_linear(f, (2 * f.shape[2], 2 * f.shape[3])))
        return self.final(f)


def face_mobilenet_heatmap_state_dict_from_jax(params: Mapping,
                                               width_mult: float = 1.0) -> StateDict:
    """The reference's ``init_face_mobilenet_heatmap`` tree -> this module's
    state dict."""
    sd = mobilenet_v2_state_dict_from_jax(params["backbone"], width_mult, "backbone.features")
    for head in ("head1", "head2"):
        put_convbn(sd, f"{head}.0", f"{head}.1", params[head])
    put_conv(sd, "final", params["final"])
    return sd


# one entry per head level: (num_layers, exp_size, out_ch, kernel, use_se, stride);
# stride 2 puts a x2 bilinear upsampling before the level's bottlenecks
DEFAULT_GHOSTHEAD_SPEC = (
    (1, 200, 96, 3, 1, 2),
    (1, 120, 64, 3, 1, 2),
)
_GHOSTHEAD_BACKBONE_BLOCKS = 14  # before_layer3 = features[:14]


class FaceMobilenetGhostHead(nn.Module):
    """[N, 3, 256, 256] -> heatmaps [N, n_joints, 64, 64] with the default spec."""

    def __init__(self, n_joints: int = 68, spec=DEFAULT_GHOSTHEAD_SPEC, final_kernel: int = 1,
                 width_mult: float = 1.0):
        super().__init__()
        from dfanerf_torch.models.perception.ghostnet_eye import GhostBottleneck

        self.before_layer3 = nn.Sequential(
            *mnv2_blocks(width_mult, n_blocks=_GHOSTHEAD_BACKBONE_BLOCKS))
        layers: List[nn.Module] = []
        inp = _block_plan(width_mult)[0][_GHOSTHEAD_BACKBONE_BLOCKS - 1][2]
        for n_layer, exp, out, k, use_se, s in spec:
            if s == 2:
                layers.append(UpsampleLinear())
            for _ in range(n_layer):
                layers.append(GhostBottleneck(inp, exp, out, k, 1, use_se))
                inp = out
        self.head_layers = nn.Sequential(*layers)
        self.head_final_layer = nn.Conv2d(inp, n_joints, final_kernel,
                                          padding=1 if final_kernel == 3 else 0)

    def forward(self, x):
        return self.head_final_layer(self.head_layers(self.before_layer3(x)))


def face_mobilenet_ghosthead_state_dict_from_jax(params: Mapping, spec=DEFAULT_GHOSTHEAD_SPEC,
                                                 width_mult: float = 1.0) -> StateDict:
    """The inverse of the reference's ``face_mobilenet_ghosthead_from_torch``."""
    from dfanerf_torch.models.perception.ghostnet_eye import put_ghost_bottleneck

    sd = mobilenet_v2_state_dict_from_jax(params["backbone"], width_mult, "before_layer3")
    seq, hi = 0, 0
    for n_layer, *_rest, s in spec:
        if s == 2:
            seq += 1  # the parameter-free upsampling's slot
        for _ in range(n_layer):
            put_ghost_bottleneck(sd, f"head_layers.{seq}", params["head"][hi])
            seq, hi = seq + 1, hi + 1
    put_conv(sd, "head_final_layer", params["final"])
    return sd
