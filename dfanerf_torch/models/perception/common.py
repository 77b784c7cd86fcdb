"""Shared pieces of the perception nets (port of
dfanerf_tpu/models/perception/common.py).

The nets are ``nn.Module``s in NCHW whose state-dict keys are those of the
reference's checkpoints, so a checkpoint loads with ``load_state_dict``.
This module holds what they share:

- ``ConvBN``: conv, inference-mode BatchNorm (eps 1e-5) and an optional ReLU;
- the resizes: ``resize_nearest`` (F.interpolate 'nearest', floor),
  ``resize_bilinear_align`` (bilinear, align_corners=True) and
  ``resize_linear`` (bilinear, align_corners=False: ``jax.image.resize``'s
  'linear' on an upsampling, which is all the nets do with it);
- ``seeded_init_``: seeded weights from a CPU ``torch.Generator`` (the
  ``random:<seed>`` assets), with BatchNorm statistics that are not the
  identity, so a swapped key shows in a comparison;
- ``load_net``: a checkpoint path (``torch.load`` + ``load_state_dict``) or
  ``random:<seed>`` -> a net in eval mode on its device;
- the builders of state-dict entries from the reference's parameter trees
  (``put_conv``, ``put_bn``, ``put_linear``, ``put_deconv``): HWIO -> OIHW,
  ``{gamma, beta, mean, var}`` -> ``weight, bias, running_mean,
  running_var``, the reference's pre-flipped transposed-conv kernels back to
  ConvTranspose2d's [in, out / groups, kh, kw]. Each net's
  ``*_state_dict_from_jax`` walks its tree with them, the inverse of the
  reference's ``*_from_torch``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dfanerf_torch.device import resolve_device

StateDict = Dict[str, torch.Tensor]


class ConvBN(nn.Sequential):
    """Conv2d (no bias), BatchNorm2d and an optional ReLU: keys ``0`` and
    ``1``, or ``conv`` and ``bn`` with ``named=True`` (the face parser's
    ConvBNReLU)."""

    def __init__(self, cin: int, cout: int, ks: int, stride: int = 1, padding: int = 0,
                 relu: bool = True, named: bool = False, groups: int = 1):
        conv = nn.Conv2d(cin, cout, ks, stride, padding, groups=groups, bias=False)
        bn = nn.BatchNorm2d(cout)
        if named:
            super().__init__()
            self.conv, self.bn = conv, bn
        else:
            super().__init__(conv, bn)
        self.relu = relu

    def forward(self, x):
        for m in self.children():
            x = m(x)
        return F.relu(x) if self.relu else x


def resize_nearest(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """F.interpolate(mode='nearest'): src = floor(dst * in / out)."""
    return F.interpolate(x, size=tuple(out_hw), mode="nearest")


def resize_bilinear_align(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear with align_corners=True."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=True)


def resize_linear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear with half-pixel centres (align_corners=False). On an
    upsampling this is ``jax.image.resize(..., 'linear')``; a downsampling
    would differ (that one filters), and none of the nets makes one."""
    if out_hw[0] < x.shape[2] or out_hw[1] < x.shape[3]:
        raise ValueError(f"resize_linear upsamples only: {tuple(x.shape[2:])} -> {tuple(out_hw)}")
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False)


@torch.no_grad()
def seeded_init_(net: nn.Module, seed: int) -> nn.Module:
    """Deterministic weights from a CPU generator, in the module's parameter
    order: conv, transposed-conv and linear weights U(-a, a) with a =
    sqrt(3 / fan_in) (variance 1 / fan_in; a transposed conv's fan is its
    weight's [out / groups, kh, kw]), biases U(-b, b) with b = 1 /
    sqrt(fan_in); a BatchNorm's (1d or 2d) weight U(0.5, 1.5), bias
    U(-0.1, 0.1), running mean U(-0.1, 0.1) and running variance
    U(0.5, 1.5)."""
    g = torch.Generator().manual_seed(seed)

    def uniform(t, lo, hi):
        t.copy_(torch.rand(t.shape, generator=g, dtype=torch.float32) * (hi - lo) + lo)

    for mod in net.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            a = math.sqrt(3.0 / fan_in)
            uniform(mod.weight, -a, a)
            if mod.bias is not None:
                uniform(mod.bias, -1.0 / math.sqrt(fan_in), 1.0 / math.sqrt(fan_in))
        elif isinstance(mod, (nn.BatchNorm1d, nn.BatchNorm2d)):
            uniform(mod.weight, 0.5, 1.5)
            uniform(mod.bias, -0.1, 0.1)
            uniform(mod.running_mean, -0.1, 0.1)
            uniform(mod.running_var, 0.5, 1.5)
    return net


def load_net(spec: str, build: Callable[[Mapping[str, torch.Tensor]], nn.Module], device=None
             ) -> nn.Module:
    """A net from a checkpoint path or ``random:<seed>``, in eval mode on
    ``device`` (default CUDA). ``build(sd)`` makes the module that ``sd``
    loads into (``sd`` is empty for ``random:``), which may map its keys."""
    dev = resolve_device(device)
    if spec.startswith("random:"):
        net = seeded_init_(build({}), int(spec.split(":", 1)[1] or 0))
    else:
        sd = torch.load(spec, map_location="cpu")
        net = build(sd)
        net.load_state_dict(sd)
    return net.eval().to(dev)


# --- state dicts from the reference's parameter trees ---------------------------------


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def put_conv(sd: StateDict, name: str, p: Mapping) -> None:
    """A conv's ``{w [kh, kw, in, out], b}`` -> ``name.weight`` [out, in, kh, kw]
    and ``name.bias``."""
    sd[f"{name}.weight"] = _t(np.asarray(p["w"]).transpose(3, 2, 0, 1))
    if "b" in p:
        sd[f"{name}.bias"] = _t(p["b"])


def put_bn(sd: StateDict, name: str, p: Mapping) -> None:
    """A BatchNorm's ``{gamma, beta, mean, var}`` -> its state-dict entries."""
    sd[f"{name}.weight"] = _t(p["gamma"])
    sd[f"{name}.bias"] = _t(p["beta"])
    sd[f"{name}.running_mean"] = _t(p["mean"])
    sd[f"{name}.running_var"] = _t(p["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0)


def put_linear(sd: StateDict, name: str, p: Mapping) -> None:
    """A linear layer's ``{w [in, out], b}`` -> ``weight`` [out, in], ``bias``
    (none without ``b``)."""
    sd[f"{name}.weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        sd[f"{name}.bias"] = _t(p["b"])


def put_convbn(sd: StateDict, cname: str, bname: str, p: Mapping) -> None:
    put_conv(sd, cname, p["conv"])
    put_bn(sd, bname, p["bn"])


def put_deconv(sd: StateDict, name: str, p: Mapping, groups: int = 1) -> None:
    """A transposed conv's pre-flipped forward kernel ``{w [kh, kw, in / groups,
    out], b}`` -> ``name.weight`` [in, out / groups, kh, kw] and ``name.bias``."""
    w = np.asarray(p["w"])
    kh, kw, cin_g, cout = w.shape
    w = w.reshape(kh, kw, cin_g, groups, cout // groups).transpose(3, 2, 4, 0, 1)
    sd[f"{name}.weight"] = _t(w.reshape(groups * cin_g, cout // groups, kh, kw)[:, :, ::-1, ::-1])
    if "b" in p:
        sd[f"{name}.bias"] = _t(p["b"])


class UpsampleLinear(nn.Module):
    """``resize_linear`` by an integer ``scale`` (no parameters: a slot in an
    nn.Sequential, as the reference's nn.Upsample is)."""

    def __init__(self, scale: int = 2):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return resize_linear(x, (self.scale * x.shape[2], self.scale * x.shape[3]))


class ConvBNAct(nn.Sequential):
    """Conv2d (no bias), BatchNorm2d and an activation module: keys ``0``,
    ``1`` and ``2`` (torchvision's ConvBNReLU layout; the activation is
    ReLU6 in MobileNetV2, a DReLU in its dynamic-activation variant)."""

    def __init__(self, cin: int, cout: int, ks: int = 3, stride: int = 1, groups: int = 1,
                 act: nn.Module = None, eps: float = 1e-5):
        super().__init__(nn.Conv2d(cin, cout, ks, stride, (ks - 1) // 2, groups=groups, bias=False),
                         nn.BatchNorm2d(cout, eps=eps), nn.ReLU6() if act is None else act)
