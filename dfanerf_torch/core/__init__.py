"""Math core: positional encodings, rays, pose geometry."""

from dfanerf_torch.core.geometry import pose_to_euler_trans, rot_to_euler
from dfanerf_torch.core.posenc import (
    et_embed, gauss_B_matrices, gauss_posenc, nerf_embed_dim, nerf_embedder, sincos_posenc,
)
from dfanerf_torch.core.rays import get_rays, linspace, ndc_rays, rays_for_pixels

__all__ = [
    "et_embed",
    "gauss_B_matrices",
    "gauss_posenc",
    "get_rays",
    "linspace",
    "ndc_rays",
    "nerf_embed_dim",
    "nerf_embedder",
    "pose_to_euler_trans",
    "rays_for_pixels",
    "rot_to_euler",
    "sincos_posenc",
]
