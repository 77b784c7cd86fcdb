"""Photometric 3DMM refinement (port of dfanerf_tpu/pipeline/photometric.py),
plain PyTorch with autograd on the model's device.

The reference's unshipped photometric tracking (face_tracking_ba/
render_land.py:59-150, over a CUDA rasteriser absent from its repository):
project the 3DMM mesh, shade it with 9-term spherical-harmonics lighting
of its normals, render against the frame and minimise the mean colour
distance over covered pixels plus the landmark distance. As in the
reference package:

- triangle normals, per-vertex normals (a vertex takes its ``vert_tris``
  triangle's) and visibility (-(n . p / |p|) >= 0.01) follow
  render_land.py:8-20, 44-57;
- the real SH-9 irradiance basis stands in for the unshipped
  ``normal_base_forward``;
- the shaded visible vertices are splatted (ops/splat.py) with a soft
  z-buffer; back-facing ones are pushed to depth 1e3, where their weight is
  negligible (exp(-50 * 400 / 600) ~ 1e-15 for a face 600 units away);
- landmarks use the model's static ``lands_info``.

The reference vmaps the per-frame loss; here the frames are one batch
(``photometric_losses``) and refinement takes their mean.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from dfanerf_torch.core.geometry import euler2rot, proj_pts, rot_trans_pts
from dfanerf_torch.ops.splat import _splat
from dfanerf_torch.pipeline.face3dmm import Face3DMM, forward_geo, forward_tex
from dfanerf_torch.train.optim import adam_state, adam_update

_FAR = (0.0, 0.0, -1e3)  # where back-facing vertices are splatted


def compute_tri_normal(geometry: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """Unit triangle normals: geometry [..., N, 3], tris [T, 3] -> [..., T, 3]
    (render_land.py:8-20's orientation)."""
    v1, v2, v3 = (geometry[..., tris[:, k], :] for k in range(3))
    n = torch.linalg.cross(v2 - v1, v3 - v1, dim=-1)
    return n / torch.clamp_min(torch.linalg.norm(n, dim=-1, keepdim=True), 1e-12)


def sh9_basis(normals: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics up to l = 2 of unit normals: [..., 3] -> [..., 9]."""
    x, y, z = normals[..., 0], normals[..., 1], normals[..., 2]
    return torch.stack([
        torch.full_like(x, 0.282095), 0.488603 * y, 0.488603 * z, 0.488603 * x,
        1.092548 * x * y, 1.092548 * y * z, 0.315392 * (3.0 * z * z - 1.0), 1.092548 * x * z,
        0.546274 * (x * x - y * y)], dim=-1)


def vertex_visibility(rott_geo: torch.Tensor, vert_normals: torch.Tensor) -> torch.Tensor:
    """1.0 where -(n . p / |p|) >= 0.01 (render_land.py:52-54), else 0.0."""
    p = rott_geo / torch.clamp_min(torch.linalg.norm(rott_geo, dim=-1, keepdim=True), 1e-12)
    return (-(vert_normals * p).sum(dim=-1) >= 0.01).to(rott_geo.dtype)


class PhotoLoss(NamedTuple):
    color: torch.Tensor     # mean masked colour distance (render_land.py:144-146)
    landmark: torch.Tensor  # mean landmark distance (render_land.py:147-149)


def photometric_losses(model: Face3DMM, tris, vert_tris, id_para, exp_para, tex_para, light,
                       euler, trans, focal, cxy, images, lands_gt=None,
                       land_index=None) -> PhotoLoss:
    """cal_loss_rgb (render_land.py:131-150) of F frames at once: exp_para
    [F, exp_dim], euler and trans [F, 3], images [F, H, W, 3] in [0, 255];
    id_para [id_dim], tex_para [tex_dim] and light [9, 3] are shared;
    lands_gt [F, L, 2]. Returns the colour and landmark losses, each [F]."""
    F, H, W = images.shape[:3]
    geo = forward_geo(model, id_para[None].expand(F, -1), exp_para)      # [F, N, 3]
    tex = forward_tex(model, tex_para[None])                              # [1, N, 3]
    rott = rot_trans_pts(geo, euler2rot(euler), trans)
    vert_n = compute_tri_normal(rott, tris)[:, vert_tris]                 # [F, N, 3]
    vis = vertex_visibility(rott, vert_n)[..., None]
    shaded = tex * (sh9_basis(vert_n) @ light)
    far = torch.tensor(_FAR, dtype=rott.dtype, device=rott.device)
    color_img, _, weight_img = _splat(rott * vis + (1.0 - vis) * far, shaded, focal, cxy, (H, W))
    valid = (weight_img > 1e-4).to(images.dtype)
    # eps-guarded norm: a bare norm has a NaN gradient at zero residuals
    col_minus = torch.sqrt(((color_img - images) ** 2).sum(dim=-1) + 1e-12)
    color = (col_minus * valid).sum(dim=(1, 2)) / (valid.sum(dim=(1, 2)) + 1e-5)
    if lands_gt is None:
        return PhotoLoss(color, torch.zeros_like(color))
    if land_index is None:
        land_index = torch.as_tensor(model.lands_info, dtype=torch.int64)
    land_index = torch.as_tensor(land_index, dtype=torch.int64, device=rott.device)
    cxy = torch.as_tensor(cxy, dtype=torch.float32, device=rott.device)
    proj = proj_pts(rott, focal, cxy)[:, land_index, :2]
    return PhotoLoss(color, torch.linalg.norm(proj - lands_gt, dim=-1).mean(dim=-1))


def photometric_loss(model: Face3DMM, tris, vert_tris, id_para, exp_para, tex_para, light, euler,
                     trans, focal, cxy, image, lands_gt=None, land_index=None) -> PhotoLoss:
    """``photometric_losses`` of one frame (exp_para [exp_dim], euler and
    trans [3], image [H, W, 3]): scalar colour and landmark losses."""
    out = photometric_losses(model, tris, vert_tris, id_para, exp_para[None], tex_para, light,
                             euler[None], trans[None], focal, cxy, image[None],
                             None if lands_gt is None else lands_gt[None], land_index)
    return PhotoLoss(out.color[0], out.landmark[0])


def refine_photometric(model: Face3DMM, tris, vert_tris, id_para, exp_para, euler, trans, focal,
                       cxy, images, lands_gt=None, n_iters: int = 200, lr: float = 1e-2,
                       w_land: float = 1.0) -> Dict[str, torch.Tensor]:
    """Refine (tex, light, euler, trans) against the frames with Adam while
    id and exp stay fixed (the role render_land.py plays for the
    reference's unshipped photometric stage). images [F, H, W, 3]; euler,
    trans, exp_para per frame. Texture starts at 0, light at 3.0 on the
    constant SH term. Returns the refined parameters and ``loss``, the
    mean over frames of colour + w_land * landmark at the last step (taken
    before its update), on the model's device."""
    dev = model.mu.device
    light = torch.zeros((9, 3), device=dev)
    light[0] = 3.0
    params = {"tex": torch.zeros((model.base_tex.shape[0],), device=dev), "light": light,
              "euler": torch.as_tensor(euler, dtype=torch.float32, device=dev).clone(),
              "trans": torch.as_tensor(trans, dtype=torch.float32, device=dev).clone()}
    opt = adam_state(params)
    tris = torch.as_tensor(tris, dtype=torch.int64, device=dev)
    vert_tris = torch.as_tensor(vert_tris, dtype=torch.int64, device=dev)
    loss = torch.tensor(float("inf"), device=dev)
    for _ in range(n_iters):
        for p in params.values():
            p.requires_grad_(True)
        pl = photometric_losses(model, tris, vert_tris, id_para, exp_para, params["tex"],
                                params["light"], params["euler"], params["trans"], focal, cxy,
                                images, lands_gt)
        loss = (pl.color + w_land * pl.landmark).mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        for p in params.values():
            p.requires_grad_(False)
        adam_update(opt, dict(zip(params, grads)), params, lr, True)
        loss = loss.detach()
    return {**params, "loss": loss}
