"""Differentiable point splatting (port of dfanerf_tpu/ops/splat.py), plain
PyTorch on the points' device.

The reference package's stand-in for the reference's unshipped CUDA
extensions ``point_render`` (UNFaceFlow/models/point_render_func.py) and
``render_util`` (face_tracking_ba/render_land.py): each projected point
adds a bilinear footprint to its 4 neighbouring pixels, weighted by a soft
z-buffer term so the nearest surface dominates; differentiable with respect
to positions and colours.

The sums are ``index_add``: in index order on the CPU, with atomics on
CUDA, where the order of a pixel's sum changes from run to run. The card's
images therefore agree with the CPU's to float32 rounding, not bit for bit.
``_splat`` takes a leading batch of frames (one index space over the
frames' pixels), which photometric refinement uses in place of the
reference's vmap.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dfanerf_torch.core.geometry import euler2rot, proj_pts


def _splat(pts_cam: torch.Tensor, colors: torch.Tensor, focal, cxy, hw: Tuple[int, int],
           z_sharpness: float = 50.0):
    """pts_cam [B, N, 3], colors [B, N, C] -> color [B, H, W, C], depth
    [B, H, W], weight [B, H, W]; each frame's z-buffer is its own."""
    H, W = hw
    B, N = pts_cam.shape[:2]
    cxy = torch.as_tensor(cxy, dtype=torch.float32, device=pts_cam.device)
    proj = proj_pts(pts_cam, focal, cxy)
    u, v, z = proj[..., 0], proj[..., 1], proj[..., 2]
    depth = -z  # positive in front of the camera
    # soft visibility: nearer (smaller depth) -> larger weight; the nearest
    # depth is a constant of the gradient (stop_gradient in the reference)
    zmin = depth.amin(dim=1, keepdim=True).detach()
    vis_w = torch.exp(-z_sharpness * (depth - zmin) / torch.clamp_min(zmin, 1e-3))

    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = u - u0, v - v0
    base = (torch.arange(B, device=pts_cam.device) * (H * W))[:, None]
    C = colors.shape[-1]
    color_img = pts_cam.new_zeros((B * H * W, C))
    depth_img = pts_cam.new_zeros((B * H * W,))
    weight_img = pts_cam.new_zeros((B * H * W,))
    for du, dv, w_bi in ((0, 0, (1 - fu) * (1 - fv)), (1, 0, fu * (1 - fv)),
                         (0, 1, (1 - fu) * fv), (1, 1, fu * fv)):
        px, py = u0 + du, v0 + dv
        valid = (px >= 0) & (px < W) & (py >= 0) & (py < H)
        idx = ((py.clamp(0, H - 1) * W + px.clamp(0, W - 1)).to(torch.int64) + base).reshape(-1)
        w = w_bi * vis_w * valid
        color_img = color_img.index_add(0, idx, (w[..., None] * colors).reshape(-1, C))
        depth_img = depth_img.index_add(0, idx, (w * depth).reshape(-1))
        weight_img = weight_img.index_add(0, idx, w.reshape(-1))

    denom = torch.clamp_min(weight_img, 1e-8)
    return ((color_img / denom[:, None]).reshape(B, H, W, C), (depth_img / denom).reshape(B, H, W),
            weight_img.reshape(B, H, W))


def splat_points(pts_cam: torch.Tensor, colors: torch.Tensor, focal, cxy, hw: Tuple[int, int],
                 z_sharpness: float = 50.0):
    """Splat camera-space points [N, 3] (the camera looks down -z) with
    colours [N, C] into (color [H, W, C], weight-normalised; depth [H, W],
    the weighted mean of -z; weight [H, W]). Weights are exp(-z_sharpness
    * (depth - depth_min) / depth_min): a differentiable z-buffer."""
    color, depth, weight = _splat(pts_cam[None], colors[None], focal, cxy, hw, z_sharpness)
    return color[0], depth[0], weight[0]


def render_geometry_points(geometry: torch.Tensor, colors: torch.Tensor, euler: torch.Tensor,
                           trans: torch.Tensor, focal, cxy, hw: Tuple[int, int]):
    """World geometry [N, 3] moved rigidly by (euler [3], trans [3]) and
    splatted (the reference's Render_RGB role): differentiable with respect
    to every input."""
    rot = euler2rot(euler[None])[0]
    return splat_points(geometry @ rot.t() + trans, colors, focal, cxy, hw)
