"""U^2-Net landmark-heatmap net (port of
dfanerf_tpu/models/perception/u2net.py; the module tree and keys are
lib/models/face_u2net.py's).

- ``RSU`` (RSU7 .. RSU4): ``rebnconvin``, an encoder chain of L - 1
  REBNCONVs (conv with bias, BatchNorm, ReLU) with ceil-mode 2x2 max pools
  between them, a dilation-2 bottom REBNCONV, and a decoder chain of
  (concat + REBNCONV + upsampling to the next skip's size), plus the
  residual add of rebnconvin's output; depth "F" (RSU4F) has no pooling:
  dilations 1 / 2 / 4 / 8 down, 4 / 2 / 1 up.
- ``U2Net``: the full net (six RSU stages, five decoder stages, six 3x3
  side heads upsampled to stage 1's size and a 1x1 fusion), returning (d0,
  d2 .. d6) as the reference's forward does (d1 made, not returned); with
  ``small`` the 5-stage U2NETP_S5, returning (d0, d1 .. d5).

The upsampling is bilinear with half-pixel centres to the target's size
(``resize_linear``); at odd sizes the ceil-mode pools make it a
non-integer ratio (e.g. 13 -> 25).
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from dfanerf_torch.models.perception.common import StateDict, put_bn, put_conv, resize_linear

# (rsu depth or "F", in_ch, mid_ch, out_ch)
U2NET_STAGES = (
    (7, 3, 32, 64),
    (6, 64, 32, 128),
    (5, 128, 64, 256),
    (4, 256, 128, 512),
    ("F", 512, 256, 512),
    ("F", 512, 256, 512),
)
U2NET_DECODE = (
    ("F", 1024, 256, 512),
    (4, 1024, 128, 256),
    (5, 512, 64, 128),
    (6, 256, 32, 64),
    (7, 128, 16, 64),
)
U2NETP_S5_STAGES = (
    (6, 3, 16, 64),
    (5, 64, 16, 64),
    (4, 64, 16, 64),
    ("F", 64, 16, 64),
    ("F", 64, 16, 64),
)
U2NETP_S5_DECODE = (
    ("F", 128, 16, 64),
    (4, 128, 16, 64),
    (5, 128, 16, 64),
    (6, 128, 16, 64),
)
_F_DIRATES = (1, 2, 4, 8)


class REBNCONV(nn.Module):
    def __init__(self, cin: int, cout: int, dirate: int = 1):
        super().__init__()
        self.conv_s1 = nn.Conv2d(cin, cout, 3, padding=dirate, dilation=dirate)
        self.bn_s1 = nn.BatchNorm2d(cout)

    def forward(self, x):
        return F.relu(self.bn_s1(self.conv_s1(x)))


def _pool_ceil(x):
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _upsample_like(src, tar):
    return resize_linear(src, tuple(tar.shape[2:]))


class RSU(nn.Module):
    def __init__(self, depth, cin: int, mid: int, cout: int):
        super().__init__()
        self.depth = depth
        n_enc = 4 if depth == "F" else depth
        self.n_enc = n_enc
        self.rebnconvin = REBNCONV(cin, cout)
        for i in range(n_enc):
            if depth == "F":
                d = _F_DIRATES[i]
            else:
                d = 2 if i == n_enc - 1 else 1
            setattr(self, f"rebnconv{i + 1}", REBNCONV(cout if i == 0 else mid, mid, d))
        for i in range(n_enc - 1, 0, -1):  # rebnconv{n_enc-1}d .. rebnconv1d
            d = _F_DIRATES[i - 1] if depth == "F" else 1
            setattr(self, f"rebnconv{i}d", REBNCONV(2 * mid, cout if i == 1 else mid, d))

    def forward(self, x):
        hxin = self.rebnconvin(x)
        n_enc = self.n_enc
        hs, h = [], hxin
        if self.depth == "F":
            for i in range(n_enc):
                h = getattr(self, f"rebnconv{i + 1}")(h)
                hs.append(h)
            for i in range(n_enc - 1, 0, -1):
                h = getattr(self, f"rebnconv{i}d")(torch.cat([h, hs[i - 1]], dim=1))
            return h + hxin
        for i in range(n_enc - 1):
            h = getattr(self, f"rebnconv{i + 1}")(h)
            hs.append(h)
            if i < n_enc - 2:
                h = _pool_ceil(h)
        h = getattr(self, f"rebnconv{n_enc}")(h)
        for i in range(n_enc - 1, 0, -1):
            h = getattr(self, f"rebnconv{i}d")(torch.cat([h, hs[i - 1]], dim=1))
            if i > 1:
                h = _upsample_like(h, hs[i - 2])
        return h + hxin


class U2Net(nn.Module):
    """[N, 3, H, W] -> (d0, side maps ...), each [N, out_ch, H, W]."""

    def __init__(self, out_ch: int = 68, small: bool = False):
        super().__init__()
        self.small = small
        stages = U2NETP_S5_STAGES if small else U2NET_STAGES
        decode = U2NETP_S5_DECODE if small else U2NET_DECODE
        n = len(stages)
        for i, (d, ci, m, co) in enumerate(stages):
            setattr(self, f"stage{i + 1}", RSU(d, ci, m, co))
        for i, (d, ci, m, co) in enumerate(decode):
            setattr(self, f"stage{n - 1 - i}d", RSU(d, ci, m, co))
        side_in = [64] * 6 if small else [64, 64, 128, 256, 512, 512]
        for i in range(n):
            setattr(self, f"side{i + 1}", nn.Conv2d(side_in[i], out_ch, 3, padding=1))
        self.outconv = nn.Conv2d(out_ch * n, out_ch, 1)
        self.n = n

    def forward(self, x):
        n = self.n
        hs, h = [], x
        for i in range(n):
            h = getattr(self, f"stage{i + 1}")(h)
            hs.append(h)
            if i < n - 1:
                h = _pool_ceil(h)
        decs = []
        for lvl in range(n - 2, -1, -1):
            h = _upsample_like(h, hs[lvl])
            h = getattr(self, f"stage{lvl + 1}d")(torch.cat([h, hs[lvl]], dim=1))
            decs.append(h)
        feats = decs[::-1] + [hs[-1]]
        sides = [getattr(self, "side1")(feats[0])]
        for i, f in enumerate(feats[1:], start=2):
            sides.append(_upsample_like(getattr(self, f"side{i}")(f), feats[0]))
        d0 = self.outconv(torch.cat(sides, dim=1))
        return (d0, *sides) if self.small else (d0, *sides[1:])


def u2net_state_dict_from_jax(params: Mapping) -> StateDict:
    """The inverse of the reference's ``u2net_from_torch``."""
    sd: StateDict = {}

    def reb(prefix, p):
        put_conv(sd, f"{prefix}.conv_s1", p["conv"])
        put_bn(sd, f"{prefix}.bn_s1", p["bn"])

    def rsu(prefix, p):
        reb(f"{prefix}.rebnconvin", p["in"])
        for i, q in enumerate(p["enc"]):
            reb(f"{prefix}.rebnconv{i + 1}", q)
        n_enc = len(p["enc"])
        for i, q in enumerate(p["dec"]):
            reb(f"{prefix}.rebnconv{n_enc - 1 - i}d", q)

    n = len(params["stages"])
    for i, p in enumerate(params["stages"]):
        rsu(f"stage{i + 1}", p)
    for i, p in enumerate(params["decode"]):
        rsu(f"stage{n - 1 - i}d", p)
    for i, p in enumerate(params["sides"]):
        put_conv(sd, f"side{i + 1}", p)
    put_conv(sd, "outconv", params["fuse"])
    return sd
