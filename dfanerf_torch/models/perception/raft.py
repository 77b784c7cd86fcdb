"""RAFT dense optical flow (small and basic), the test_flow crop/uncrop
wrapper and the ImportanceWeights head (port of
dfanerf_tpu/models/perception/raft.py; the module trees and keys are
UNFaceFlow/core's, so raft-small.pth and raft-things.pth load, with or
without their 'module.' prefix).

- The all-pairs correlation volume is one batched product divided by
  sqrt(D), its pyramid four 2x2 average poolings over the target grid.
- The lookup samples each level bilinearly at 7x7 offsets (radius 3),
  zeroing each corner that falls outside: the reference's gather, written
  out, which is grid_sample(align_corners=True, padding_mode='zeros') on
  pixel coordinates but stays defined on a one-pixel level.
- The recurrent update (a ConvGRU) runs 12 iterations in a Python loop.
- The feature encoder's instance norm has no affine parameters and eps
  1e-5, like torch's InstanceNorm2d default.

RAFT-basic (``RAFTBasic``, core/raft.py's small=False path): the
BasicEncoder's residual towers (instance norm in fnet, batch norm in cnet),
BasicMotionEncoder, the SepConvGRU's 1x5 and 5x1 passes, the 0.25-scaled
mask head and the convex upsampling of the flow (a softmax over the 3x3
window positions, ``upsample_flow_convex``), at correlation radius 4; with
``alternate_corr`` the correlation is sampled from the pooled fmap2 and
dotted with fmap1 (``lookup_corr_alternate``, corr.py's
AlternateCorrBlock), which equals the pyramid's lookup up to float32
summation order. ``ImportanceWeights`` (network_test_flow.py's refinement
head; the reference has an init and no converter, its keys here are
``conv1``, ``block0``, ``res.{i}.{0,1}`` and ``head``): no BatchNorm, a
sigmoid weight per pixel.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dfanerf_torch.models.perception.common import (
    StateDict, load_net, put_bn, put_conv, resize_bilinear_align,
)

HDIM, CDIM = 96, 64
CORR_LEVELS, CORR_RADIUS = 4, 3


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, norm: str):
        super().__init__()
        self.instance = norm == "instance"
        self.conv1 = nn.Conv2d(cin, planes // 4, 1)
        self.conv2 = nn.Conv2d(planes // 4, planes // 4, 3, stride, 1)
        self.conv3 = nn.Conv2d(planes // 4, planes, 1)
        self.downsample = nn.Sequential(nn.Conv2d(cin, planes, 1, stride)) if stride != 1 else None

    def _n(self, y):
        return F.instance_norm(y, eps=1e-5) if self.instance else y

    def forward(self, x):
        y = F.relu(self._n(self.conv1(x)))
        y = F.relu(self._n(self.conv2(y)))
        y = F.relu(self._n(self.conv3(y)))
        if self.downsample is not None:
            x = self._n(self.downsample(x))
        return F.relu(x + y)


class SmallEncoder(nn.Module):
    """[N, 3, H, W] -> [N, out, H/8, W/8]."""

    def __init__(self, out_dim: int, norm: str):
        super().__init__()
        self.instance = norm == "instance"
        self.conv1 = nn.Conv2d(3, 32, 7, 2, 3)
        self.layer1 = nn.Sequential(Bottleneck(32, 32, 1, norm), Bottleneck(32, 32, 1, norm))
        self.layer2 = nn.Sequential(Bottleneck(32, 64, 2, norm), Bottleneck(64, 64, 1, norm))
        self.layer3 = nn.Sequential(Bottleneck(64, 96, 2, norm), Bottleneck(96, 96, 1, norm))
        self.conv2 = nn.Conv2d(96, out_dim, 1)

    def forward(self, x):
        x = self.conv1(x)
        x = F.relu(F.instance_norm(x, eps=1e-5) if self.instance else x)
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class SmallMotionEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.convc1 = nn.Conv2d(CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2, 96, 1)
        self.convf1 = nn.Conv2d(2, 64, 7, padding=3)
        self.convf2 = nn.Conv2d(64, 32, 3, padding=1)
        self.conv = nn.Conv2d(128, 80, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc1(corr))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class ConvGRU(nn.Module):
    def __init__(self, hidden: int = HDIM, inp: int = 82 + CDIM):
        super().__init__()
        self.convz = nn.Conv2d(hidden + inp, hidden, 3, padding=1)
        self.convr = nn.Conv2d(hidden + inp, hidden, 3, padding=1)
        self.convq = nn.Conv2d(hidden + inp, hidden, 3, padding=1)

    def forward(self, h, x):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


class FlowHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(HDIM, 128, 3, padding=1)
        self.conv2 = nn.Conv2d(128, 2, 3, padding=1)

    def forward(self, x):
        feat = F.relu(self.conv1(x))
        return self.conv2(feat), feat


class SmallUpdateBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = SmallMotionEncoder()
        self.gru = ConvGRU()
        self.flow_head = FlowHead()


def coords_grid(batch: int, h: int, w: int, device=None) -> torch.Tensor:
    """[N, 2, H, W] (x, y) pixel coordinates."""
    ys, xs = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                            indexing="ij")
    return torch.stack([xs, ys]).to(torch.float32)[None].expand(batch, 2, h, w)


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """img [M, H, W], coords [M, Q, 2] (x, y) pixel coordinates -> [M, Q];
    a corner outside the image contributes zero."""
    m, h, w = img.shape
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    flat = img.reshape(m, h * w)

    def gather(xi, yi):
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = yi.clamp(0, h - 1).to(torch.int64) * w + xi.clamp(0, w - 1).to(torch.int64)
        return torch.gather(flat, 1, idx) * valid

    return (gather(x0, y0) * ((1 - wx) * (1 - wy)) + gather(x0 + 1, y0) * (wx * (1 - wy))
            + gather(x0, y0 + 1) * ((1 - wx) * wy) + gather(x0 + 1, y0 + 1) * (wx * wy))


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor):
    """fmaps [N, D, H, W] -> CORR_LEVELS volumes [N*H*W, h_l, w_l]."""
    n, d, h, w = fmap1.shape
    corr = torch.bmm(fmap1.reshape(n, d, h * w).transpose(1, 2), fmap2.reshape(n, d, h * w))
    corr = (corr / torch.sqrt(torch.tensor(float(d)))).reshape(n * h * w, 1, h, w)
    pyramid = [corr[:, 0]]
    for _ in range(CORR_LEVELS - 1):
        corr = F.avg_pool2d(corr, 2, 2)
        pyramid.append(corr[:, 0])
    return pyramid


def lookup_corr(pyramid, coords: torch.Tensor, radius: int = CORR_RADIUS) -> torch.Tensor:
    """coords [N, 2, H, W] -> correlation features [N, LEVELS * (2r+1)^2, H, W].
    The offsets are the reference's: the first meshgrid axis adds to x."""
    n, _, h, w = coords.shape
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords.device)
    dyx = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1).reshape(1, -1, 2)
    base = coords.permute(0, 2, 3, 1).reshape(n * h * w, 1, 2)
    out = [bilinear_sampler(corr, base / (2 ** i) + dyx).reshape(n, h, w, -1)
           for i, corr in enumerate(pyramid)]
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2)


class RAFTSmall(nn.Module):
    def __init__(self):
        super().__init__()
        self.fnet = SmallEncoder(128, "instance")
        self.cnet = SmallEncoder(HDIM + CDIM, "none")
        self.update_block = SmallUpdateBlock()

    def forward(self, image1, image2, iters: int = 12) -> Tuple[torch.Tensor, torch.Tensor]:
        """image1/2 [N, 3, H, W] at 0..255 scale, H and W multiples of 8 ->
        (flow [N, 2, H, W] in pixels, the last update feature [N, 128, H/8, W/8])."""
        image1 = 2.0 * (image1 / 255.0) - 1.0
        image2 = 2.0 * (image2 / 255.0) - 1.0
        n = image1.shape[0]
        fmaps = self.fnet(torch.cat([image1, image2]))
        pyramid = build_corr_pyramid(fmaps[:n], fmaps[n:])
        cnet = self.cnet(image1)
        net, inp = torch.tanh(cnet[:, :HDIM]), F.relu(cnet[:, HDIM:])
        h8, w8 = fmaps.shape[2:]
        coords0 = coords_grid(n, h8, w8, image1.device)
        coords1 = coords0
        ub = self.update_block
        feat = None
        for _ in range(iters):
            corr = lookup_corr(pyramid, coords1)
            flow = coords1 - coords0
            motion = ub.encoder(flow, corr)
            net = ub.gru(net, torch.cat([inp, motion], dim=1))
            delta, feat = ub.flow_head(net)
            coords1 = coords1 + delta
        return upflow8(coords1 - coords0), feat


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """x8 bilinear (align_corners=True) upsampling, the flow scaled by 8."""
    return 8.0 * resize_bilinear_align(flow, (8 * flow.shape[2], 8 * flow.shape[3]))


def load_raft_small(spec: str, device=None) -> RAFTSmall:
    """raft-small.pth (a 'module.' prefix is dropped) or ``random:<seed>``, in
    eval mode on ``device`` (default CUDA)."""
    def build(sd):
        for k in [k for k in sd if k.startswith("module.")]:
            sd[k[len("module."):]] = sd.pop(k)
        return RAFTSmall()

    return load_net(spec, build, device)


@torch.no_grad()
def flow_on_crops(net: RAFTSmall, src_crop: np.ndarray, tar_crop: np.ndarray,
                  crop_params: np.ndarray, full_hw: Tuple[int, int], iters: int = 12) -> np.ndarray:
    """The test_flow inference contract (network_test_flow.py:73-104): RAFT
    on fixed-size crops, the flow rescaled and offset back into the full
    frame, on the net's device.

    src_crop/tar_crop: [N, ch, cw, 3] crops at 0..255 scale; crop_params
    [N, 8] int (x1s, x2s, y1s, y2s, x1t, x2t, y1t, y2t), the source and
    target rects in the full frame; full_hw (H, W). Returns [N, H, W, 2]
    flow in full-frame pixels (zero outside the source rect)."""
    dev = next(net.parameters()).device
    n, ch, cw, _ = src_crop.shape
    H, W = full_hw

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev).permute(0, 3, 1, 2)

    flow_crop, _ = net(nchw(src_crop), nchw(tar_crop), iters)
    grid_crop = coords_grid(1, ch, cw, dev)[0]  # [2, ch, cw]
    out = torch.zeros((n, H, W, 2), dtype=torch.float32, device=dev)
    for i in range(n):
        x1s, x2s, y1s, y2s, x1t, x2t, y1t, y2t = [int(v) for v in crop_params[i]]
        scale1 = torch.tensor([(x2s - x1s) / cw, (y2s - y1s) / ch], dtype=torch.float32,
                              device=dev)[:, None, None]
        scale2 = torch.tensor([(x2t - x1t) / cw, (y2t - y1t) / ch], dtype=torch.float32,
                              device=dev)[:, None, None]
        f = (scale2 - scale1) * grid_crop + scale2 * flow_crop[i]
        # to the source rect's size (bilinear, align_corners=True)
        f = resize_bilinear_align(f[None], (y2s - y1s, x2s - x1s))[0]
        f = f + torch.tensor([x1t - x1s, y1t - y1s], dtype=torch.float32, device=dev)[:, None, None]
        out[i, y1s:y2s, x1s:x2s] = f.permute(1, 2, 0)
    return out.cpu().numpy()


def mask_crop(color: np.ndarray, mask: np.ndarray, crop_hw: Tuple[int, int] = (320, 240),
              bound: int = 10):
    """The UNFaceFlow dataset crop (data_test_flow/dd_dataset.py:52-64), on
    the host: the mask's bbox padded by ``bound`` px and clamped, the colour
    zeroed outside the mask, cropped and resized to crop_hw = (crop_height,
    crop_width). Returns (crop [ch, cw, 3] float32 at 0..255,
    (x1, x2, y1, y2))."""
    import cv2

    nz = np.nonzero(mask)
    assert nz[0].size > 0, "mask_crop: empty mask"
    h, w = mask.shape[:2]
    min_x = max(0, int(nz[1].min()) - bound)
    max_x = min(w - 1, int(nz[1].max()) + bound)
    min_y = max(0, int(nz[0].min()) - bound)
    max_y = min(h - 1, int(nz[0].max()) + bound)
    masked = color.astype(np.float32) * (mask != 0).astype(np.float32)[..., None]
    crop = masked[min_y:max_y, min_x:max_x]
    crop = cv2.resize(np.ascontiguousarray(crop), (crop_hw[1], crop_hw[0]),
                      interpolation=cv2.INTER_LINEAR)
    return crop, (min_x, max_x, min_y, max_y)


def raft_small_state_dict_from_jax(params: Mapping) -> StateDict:
    """The reference's parameter tree (numpy leaves) -> this module's state
    dict: the inverse of ``raft_small_from_torch``."""
    sd: StateDict = {}
    for enc in ("fnet", "cnet"):
        p = params[enc]
        put_conv(sd, f"{enc}.conv1", p["conv1"])
        for li in ("layer1", "layer2", "layer3"):
            for i, b in enumerate(p[li]):
                for k in ("conv1", "conv2", "conv3"):
                    put_conv(sd, f"{enc}.{li}.{i}.{k}", b[k])
                if "downsample" in b:
                    put_conv(sd, f"{enc}.{li}.{i}.downsample.0", b["downsample"])
        put_conv(sd, f"{enc}.conv2", p["conv2"])
    for part, keys in (("encoder", ("convc1", "convf1", "convf2", "conv")),
                       ("gru", ("convz", "convr", "convq")), ("flow_head", ("conv1", "conv2"))):
        for k in keys:
            put_conv(sd, f"update_block.{part}.{k}", params["update"][part][k])
    return sd


# --- RAFT basic ----------------------------------------------------------------------

BASIC_HDIM, BASIC_CDIM = 128, 128
BASIC_RADIUS = 4


class ResidualBlock(nn.Module):
    """extractor.py ResidualBlock: two 3x3 convs (the stride on the first)
    and, at stride 2, a 1x1 downsample; norm "instance" (affine-free) or
    "batch" (``norm1``, ``norm2``, and ``norm3``, which is also the
    downsample's second module, so a checkpoint holds it under both keys)."""

    def __init__(self, cin: int, planes: int, stride: int, norm: str):
        super().__init__()
        self.instance = norm == "instance"
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1)
        batch = norm == "batch"
        if batch:
            self.norm1, self.norm2 = nn.BatchNorm2d(planes), nn.BatchNorm2d(planes)
            if stride != 1:
                self.norm3 = nn.BatchNorm2d(planes)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(nn.Conv2d(cin, planes, 1, stride),
                                            *([self.norm3] if batch else []))

    def _n(self, y, k):
        if self.instance:
            return F.instance_norm(y, eps=1e-5)
        return getattr(self, f"norm{k}")(y)

    def forward(self, x):
        y = F.relu(self._n(self.conv1(x), 1))
        y = F.relu(self._n(self.conv2(y), 2))
        if self.downsample is not None:
            x = self.downsample(x)
            x = F.instance_norm(x, eps=1e-5) if self.instance else x
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """[N, 3, H, W] -> [N, out, H/8, W/8]: 64 -> 64 / 96 / 128 residual
    towers, a 1x1 output conv."""

    def __init__(self, out_dim: int, norm: str):
        super().__init__()
        self.instance = norm == "instance"
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        if not self.instance:
            self.norm1 = nn.BatchNorm2d(64)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, 1, norm), ResidualBlock(64, 64, 1, norm))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, 2, norm), ResidualBlock(96, 96, 1, norm))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, 2, norm),
                                    ResidualBlock(128, 128, 1, norm))
        self.conv2 = nn.Conv2d(128, out_dim, 1)

    def forward(self, x):
        x = self.conv1(x)
        x = F.relu(F.instance_norm(x, eps=1e-5) if self.instance else self.norm1(x))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class BasicMotionEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.convc1 = nn.Conv2d(CORR_LEVELS * (2 * BASIC_RADIUS + 1) ** 2, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(256, 126, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    """A horizontal (1x5) then a vertical (5x1) ConvGRU pass."""

    def __init__(self, hidden: int = BASIC_HDIM, inp: int = 128 + BASIC_CDIM):
        super().__init__()
        for sfx, ks, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for g in ("z", "r", "q"):
                setattr(self, f"conv{g}{sfx}", nn.Conv2d(hidden + inp, hidden, ks, padding=pad))

    def forward(self, h, x):
        for sfx in ("1", "2"):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{sfx}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{sfx}")(hx))
            q = torch.tanh(getattr(self, f"convq{sfx}")(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class BasicFlowHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(BASIC_HDIM, 256, 3, padding=1)
        self.conv2 = nn.Conv2d(256, 2, 3, padding=1)

    def forward(self, x):
        feat = F.relu(self.conv1(x))
        return self.conv2(feat), feat


class BasicUpdateBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = BasicMotionEncoder()
        self.gru = SepConvGRU()
        self.flow_head = BasicFlowHead()
        self.mask = nn.Sequential(nn.Conv2d(128, 256, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(256, 64 * 9, 1))


def upsample_flow_convex(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """flow [N, 2, H, W] at 1/8 and mask [N, 64 * 9, H, W] -> [N, 2, 8H, 8W]:
    each fine pixel a convex combination (softmax over the 9 positions of
    the 3x3 window, row-major) of 8x the coarse flow; mask channel c = k * 64
    + i * 8 + j for window position k and sub-pixel (i, j)."""
    n, _, h, w = flow.shape
    m = torch.softmax(mask.view(n, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8.0 * flow, (3, 3), padding=1).view(n, 2, 9, 1, 1, h, w)
    up = (m * up).sum(dim=2)  # [N, 2, 8, 8, H, W]
    return up.permute(0, 1, 4, 2, 5, 3).reshape(n, 2, 8 * h, 8 * w)


def bilinear_sampler_channels(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """img [M, C, H, W], coords [M, Q, 2] (x, y) pixel coordinates -> [M, Q, C]:
    ``bilinear_sampler`` with every channel gathered at once."""
    m, c, h, w = img.shape
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    flat = img.reshape(m, c, h * w).transpose(1, 2)  # [M, HW, C]

    def gather(xi, yi):
        valid = ((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1))[..., None]
        idx = yi.clamp(0, h - 1).to(torch.int64) * w + xi.clamp(0, w - 1).to(torch.int64)
        return torch.gather(flat, 1, idx[..., None].expand(-1, -1, c)) * valid

    return (gather(x0, y0) * ((1 - wx) * (1 - wy)) + gather(x0 + 1, y0) * (wx * (1 - wy))
            + gather(x0, y0 + 1) * ((1 - wx) * wy) + gather(x0 + 1, y0 + 1) * (wx * wy))


def lookup_corr_alternate(fmap1: torch.Tensor, fmap2: torch.Tensor, coords: torch.Tensor,
                          num_levels: int = CORR_LEVELS, radius: int = BASIC_RADIUS
                          ) -> torch.Tensor:
    """corr.py AlternateCorrBlock: per level, fmap2 average-pooled 2^i times
    and sampled (``bilinear_sampler_channels``) in the (2r+1)^2 window
    around coords / 2^i, dotted with the full-resolution fmap1 and divided
    by sqrt(D). fmaps [N, D, H, W], coords [N, 2, H, W] -> [N, LEVELS *
    (2r+1)^2, H, W]; the offsets as ``lookup_corr``'s. It never builds the
    [N (HW)^2] volume; it equals ``lookup_corr`` on ``build_corr_pyramid``
    up to float32 summation order (the dot product is linear in fmap2)."""
    n, d, h, w = fmap1.shape
    off = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords.device)
    dyx = torch.stack(torch.meshgrid(off, off, indexing="ij"), dim=-1).reshape(1, 1, -1, 2)
    k = dyx.shape[2]
    f1 = fmap1.reshape(n, d, h * w).transpose(1, 2)  # [N, HW, D]
    base = coords.permute(0, 2, 3, 1).reshape(n, h * w, 1, 2)
    f2, out = fmap2, []
    for i in range(num_levels):
        pts = (base / (2.0 ** i) + dyx).reshape(n, h * w * k, 2)
        sampled = bilinear_sampler_channels(f2, pts).reshape(n, h * w, k, d)
        corr = torch.einsum("npd,npkd->npk", f1, sampled) / torch.sqrt(torch.tensor(float(d)))
        out.append(corr.reshape(n, h, w, k))
        if i < num_levels - 1:
            f2 = F.avg_pool2d(f2, 2, 2)
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2)


class RAFTBasic(nn.Module):
    def __init__(self):
        super().__init__()
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(BASIC_HDIM + BASIC_CDIM, "batch")
        self.update_block = BasicUpdateBlock()

    def forward(self, image1, image2, iters: int = 12, alternate_corr: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """image1/2 [N, 3, H, W] at 0..255 scale, H and W multiples of 8 ->
        (the last iteration's convex-upsampled flow [N, 2, H, W] in pixels,
        its FlowHead feature [N, 256, H/8, W/8])."""
        image1 = 2.0 * (image1 / 255.0) - 1.0
        image2 = 2.0 * (image2 / 255.0) - 1.0
        n = image1.shape[0]
        fmaps = self.fnet(torch.cat([image1, image2]))
        fmap1, fmap2 = fmaps[:n], fmaps[n:]
        pyramid = None if alternate_corr else build_corr_pyramid(fmap1, fmap2)
        cnet = self.cnet(image1)
        net, inp = torch.tanh(cnet[:, :BASIC_HDIM]), F.relu(cnet[:, BASIC_HDIM:])
        h8, w8 = fmaps.shape[2:]
        coords0 = coords_grid(n, h8, w8, image1.device)
        coords1 = coords0
        ub = self.update_block
        feat = mask = None
        for _ in range(iters):
            corr = (lookup_corr_alternate(fmap1, fmap2, coords1) if alternate_corr
                    else lookup_corr(pyramid, coords1, radius=BASIC_RADIUS))
            flow = coords1 - coords0
            motion = ub.encoder(flow, corr)
            net = ub.gru(net, torch.cat([inp, motion], dim=1))
            delta, feat = ub.flow_head(net)
            mask = 0.25 * ub.mask(net)
            coords1 = coords1 + delta
        return upsample_flow_convex(coords1 - coords0, mask), feat


def raft_basic_state_dict_from_jax(params: Mapping) -> StateDict:
    """The reference's parameter tree (numpy leaves) -> this module's state
    dict: the inverse of ``raft_basic_from_torch`` (a batch-norm block's
    downsample BatchNorm under both of its keys)."""
    sd: StateDict = {}
    for enc in ("fnet", "cnet"):
        p = params[enc]
        put_conv(sd, f"{enc}.conv1", p["conv1"])
        if "norm1" in p:
            put_bn(sd, f"{enc}.norm1", p["norm1"])
        for li in ("layer1", "layer2", "layer3"):
            for i, b in enumerate(p[li]):
                pre = f"{enc}.{li}.{i}"
                put_conv(sd, f"{pre}.conv1", b["conv1"])
                put_conv(sd, f"{pre}.conv2", b["conv2"])
                for k in ("norm1", "norm2", "norm3"):
                    if k in b:
                        put_bn(sd, f"{pre}.{k}", b[k])
                if "downsample" in b:
                    put_conv(sd, f"{pre}.downsample.0", b["downsample"])
                    if "norm3" in b:
                        put_bn(sd, f"{pre}.downsample.1", b["norm3"])
        put_conv(sd, f"{enc}.conv2", p["conv2"])
    up = params["update"]
    for part, keys in (("encoder", ("convc1", "convc2", "convf1", "convf2", "conv")),
                       ("gru", ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2")),
                       ("flow_head", ("conv1", "conv2"))):
        for k in keys:
            put_conv(sd, f"update_block.{part}.{k}", up[part][k])
    put_conv(sd, "update_block.mask.0", up["mask"]["conv1"])
    put_conv(sd, "update_block.mask.2", up["mask"]["conv2"])
    return sd


# --- ImportanceWeights ----------------------------------------------------------------


class ImportanceWeights(nn.Module):
    """images6 [N, 6, H, W] (the source and target pair) and a RAFT update
    feature [N, in_dim, H, W] -> weights [N, 1, H, W] in (0, 1): a 3x3 conv
    of the feature to 16 channels, concatenated with the images, one conv
    block and three residual blocks at 16 channels, a sigmoid head. No
    BatchNorm (the reference's use_batch_norm=False path)."""

    def __init__(self, in_dim: int = 128):
        super().__init__()
        self.conv1 = nn.Conv2d(in_dim, 16, 3, padding=1)
        self.block0 = nn.Conv2d(22, 16, 3, padding=1)
        self.res = nn.ModuleList(nn.ModuleList([nn.Conv2d(16, 16, 3, padding=1),
                                                nn.Conv2d(16, 16, 3, padding=1)])
                                 for _ in range(3))
        self.head = nn.Conv2d(16, 1, 3, padding=1)

    def forward(self, images6, feature):
        x = F.relu(self.block0(torch.cat([self.conv1(feature), images6], dim=1)))
        for r0, r1 in self.res:
            x = F.relu(x + r1(F.relu(r0(x))))
        return torch.sigmoid(self.head(x))


def importance_weights_state_dict_from_jax(params: Mapping) -> StateDict:
    """The reference's ``init_importance_weights`` tree -> this module's
    state dict."""
    sd: StateDict = {}
    for k in ("conv1", "block0", "head"):
        put_conv(sd, k, params[k])
    for i, (r0, r1) in enumerate(params["res"]):
        put_conv(sd, f"res.{i}.0", r0)
        put_conv(sd, f"res.{i}.1", r1)
    return sd
