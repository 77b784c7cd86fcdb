"""Legacy NeRF MLPs kept for reference-checkpoint compatibility (port of
dfanerf_tpu/models/legacy.py).

The reference carries two older model classes that its shipped trainer no
longer calls but whose checkpoints exist (run_nerf_helpers.py:242-338
``FaceNeRF``, the AD-NeRF audio-concat NeRF, and :342-435 the vanilla
``NeRF``). The modules here carry the reference's key names
(``pts_linears.{i}``, ``views_linears.{i}``, ``feature_linear``,
``alpha_linear``, ``rgb_linear``, ``output_linear``), so a reference
state dict loads as it is and the converters only copy.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dfanerf_torch.compat.torch_ckpt import StateDict, _copy


class FaceNeRF(nn.Module):
    """x [N, input_ch + dim_aud + input_ch_views] -> [N, 4] (rgb, alpha), or
    [N, output_ch] without view directions. The view branch has 1 + D // 4
    layers (helpers:265-266); with view directions the branch reads the RAW
    trunk output, not ``feature_linear``'s, which is built but unused
    (helpers:287), as in the reference."""

    def __init__(self, D: int = 8, W: int = 256, input_ch: int = 3, input_ch_views: int = 3,
                 dim_aud: int = 76, output_ch: int = 4, skips: Tuple[int, ...] = (4,),
                 use_viewdirs: bool = False):
        super().__init__()
        self.in_all, self.input_ch_views = input_ch + dim_aud, input_ch_views
        self.skips, self.use_viewdirs = skips, use_viewdirs
        in_all = self.in_all
        self.pts_linears = nn.ModuleList(
            [nn.Linear(in_all, W)]
            + [nn.Linear(W + in_all if i in skips else W, W) for i in range(D - 1)])
        self.views_linears = nn.ModuleList(
            [nn.Linear(input_ch_views + W, W // 2)]
            + [nn.Linear(W // 2, W // 2) for _ in range(D // 4)])
        if use_viewdirs:
            self.feature_linear = nn.Linear(W, W)
            self.alpha_linear = nn.Linear(W, 1)
            self.rgb_linear = nn.Linear(W // 2, 3)
        else:
            self.output_linear = nn.Linear(W, output_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        input_pts = x[..., :self.in_all]
        input_views = x[..., self.in_all:self.in_all + self.input_ch_views]
        h = input_pts
        for i, layer in enumerate(self.pts_linears):
            h = F.relu(layer(h))
            if i in self.skips:
                h = torch.cat([input_pts, h], dim=-1)
        if not self.use_viewdirs:
            return self.output_linear(h)
        alpha = self.alpha_linear(h)
        h = torch.cat([h, input_views], dim=-1)
        for layer in self.views_linears:
            h = F.relu(layer(h))
        return torch.cat([self.rgb_linear(h), alpha], dim=-1)


class VanillaNeRF(nn.Module):
    """The original NeRF MLP: x [N, input_ch + input_ch_views] -> [N, 4];
    one view layer fed by ``feature_linear``."""

    def __init__(self, D: int = 8, W: int = 256, input_ch: int = 3, input_ch_views: int = 3,
                 output_ch: int = 4, skips: Tuple[int, ...] = (4,), use_viewdirs: bool = False):
        super().__init__()
        self.input_ch, self.input_ch_views = input_ch, input_ch_views
        self.skips, self.use_viewdirs = skips, use_viewdirs
        self.pts_linears = nn.ModuleList(
            [nn.Linear(input_ch, W)]
            + [nn.Linear(W + input_ch if i in skips else W, W) for i in range(D - 1)])
        self.views_linears = nn.ModuleList([nn.Linear(input_ch_views + W, W // 2)])
        if use_viewdirs:
            self.feature_linear = nn.Linear(W, W)
            self.alpha_linear = nn.Linear(W, 1)
            self.rgb_linear = nn.Linear(W // 2, 3)
        else:
            self.output_linear = nn.Linear(W, output_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        input_pts = x[..., :self.input_ch]
        input_views = x[..., self.input_ch:self.input_ch + self.input_ch_views]
        h = input_pts
        for i, layer in enumerate(self.pts_linears):
            h = F.relu(layer(h))
            if i in self.skips:
                h = torch.cat([input_pts, h], dim=-1)
        if not self.use_viewdirs:
            return self.output_linear(h)
        alpha = self.alpha_linear(h)
        h = torch.cat([self.feature_linear(h), input_views], dim=-1)
        for layer in self.views_linears:
            h = F.relu(layer(h))
        return torch.cat([self.rgb_linear(h), alpha], dim=-1)


def facenerf_from_torch(sd: Mapping[str, Any]) -> StateDict:
    """A reference FaceNeRF or NeRF state dict -> the module's (float32
    copies of the same keys, the linears that the dict holds)."""
    out: StateDict = {}
    for k, v in sd.items():
        head = k.split(".")[0]
        if head in ("pts_linears", "views_linears", "feature_linear", "alpha_linear",
                    "rgb_linear", "output_linear"):
            out[k] = _copy(v)
    return out


vanilla_nerf_from_torch = facenerf_from_torch
