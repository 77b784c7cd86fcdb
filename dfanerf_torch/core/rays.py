"""Pinhole-camera ray generation (port of dfanerf_tpu/core/rays.py get_rays,
rays_for_pixels and ndc_rays).

Pixel grid with 'xy' indexing, camera looking down -z with y flipped:
dir = [(i - cx) / f, -(j - cy) / f, -1], rotated by c2w[:3, :3]; ray
directions are not normalized.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def linspace(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """float32 linspace rounded the way the reference package's
    ``jnp.linspace`` is on XLA:CPU: out[i] = fma(i, stop * r, start * (1 - i * r))
    with r = 1 / (num - 1) in float32, and out[-1] = stop. The fma is taken in
    float64, where the product i * (stop * r) is exact. ``torch.linspace``
    rounds differently in the last bit, which moves every sample depth.

    Computed on ``device`` from host scalars: no host-to-device copy, which
    would synchronize a frame that builds depths."""
    f32 = torch.float32
    s, e = np.float32(start), np.float32(stop)
    if num == 1:
        return torch.full((1,), float(s), dtype=f32, device=device)
    r = np.float32(1.0) / np.float32(num - 1)
    i = torch.arange(num - 1, dtype=f32, device=device)
    head = float(s) * (1.0 - i * float(r))
    out = (i.double() * float(np.float32(e * r)) + head.double()).to(f32)
    return torch.cat([out, torch.full((1,), float(e), dtype=f32, device=device)])


def get_rays(
    H: int,
    W: int,
    focal: float,
    c2w: torch.Tensor,
    cx: Optional[float] = None,
    cy: Optional[float] = None,
    stride: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays for every pixel: rays_o, rays_d each [H // stride, W // stride, 3]."""
    if cx is None:
        cx = W * 0.5
    if cy is None:
        cy = H * 0.5
    i = linspace(0.0, W - 1, W // stride, device=c2w.device)
    j = linspace(0.0, H - 1, H // stride, device=c2w.device)
    jj, ii = torch.meshgrid(j, i, indexing="ij")
    dirs = torch.stack([(ii - cx) / focal, -(jj - cy) / focal, -torch.ones_like(ii)], dim=-1)
    rays_d = torch.einsum("...j,ij->...i", dirs, c2w[:3, :3].to(torch.float32))
    rays_o = c2w[:3, -1].to(torch.float32).expand(rays_d.shape)
    return rays_o, rays_d


def rays_for_pixels(coords_yx: torch.Tensor, focal: float, c2w: torch.Tensor, cx: float,
                    cy: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays of explicit (row, col) pixel coordinates coords_yx [N, 2] (reference
    :66): rays_o, rays_d each [N, 3], the rows of get_rays at those pixels,
    without building the frame's grid."""
    y = coords_yx[..., 0].to(torch.float32)
    x = coords_yx[..., 1].to(torch.float32)
    dirs = torch.stack([(x - cx) / focal, -(y - cy) / focal, -torch.ones_like(x)], dim=-1)
    rays_d = torch.einsum("...j,ij->...i", dirs, c2w[:3, :3].to(torch.float32))
    rays_o = c2w[:3, -1].to(torch.float32).expand(rays_d.shape)
    return rays_o, rays_d


def ndc_rays(H: int, W: int, focal: float, near: float, rays_o: torch.Tensor,
             rays_d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shift rays to the near plane and project them to NDC space (reference
    :96; the vanilla-NeRF / LLFF convention, which the talking-head pipeline
    does not use): rays_o, rays_d [..., 3] -> the same in NDC."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (H / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]
    return torch.stack([o0, o1, o2], dim=-1), torch.stack([d0, d1, d2], dim=-1)
