"""Positional encodings (port of dfanerf_tpu/core/posenc.py).

``sincos_posenc`` is the decoder's GIRAFFE-style encoding (input divided by
``downscale``, frequencies pi * 2**i, layout [sin, cos] per frequency, no
raw input); ``gauss_posenc`` its random-Fourier alternative (the decoder's
``positional_encoding='gauss'``, over ``gauss_B_matrices``);
``nerf_embedder`` is the original-NeRF embedder used for the torso pose
signal (raw input first, then [sin, cos] per frequency).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def sincos_posenc(p: torch.Tensor, n_freqs: int, downscale: float = 1.0) -> torch.Tensor:
    """[..., d] -> [..., 2 * n_freqs * d], per-frequency layout [sin, cos]."""
    p = p / downscale
    freqs = (2.0 ** torch.arange(n_freqs, dtype=p.dtype, device=p.device)) * math.pi
    scaled = p[..., None, :] * freqs[:, None]
    enc = torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1)
    return enc.reshape(*p.shape[:-1], 2 * n_freqs * p.shape[-1])


def gauss_B_matrices(gauss_dim_pos: int = 10, gauss_dim_view: int = 4,
                     gauss_std: float = 4.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's fixed Gaussian projections (decoder.py:189-199): numpy's
    legacy RNG seeded with 42 draws B_pos = std * randn(1, 3 * gauss_dim_pos,
    3), THEN B_view = std * randn(1, 3 * gauss_dim_view, 3). Constants of the
    configuration, not trainable. Returns (B_pos [3 * gp, 3], B_view
    [3 * gv, 3]) float32 on the CPU."""
    rs = np.random.RandomState(42)
    b_pos = (gauss_std * rs.randn(1, gauss_dim_pos * 3, 3)).astype(np.float32)
    b_view = (gauss_std * rs.randn(1, gauss_dim_view * 3, 3)).astype(np.float32)
    return torch.from_numpy(b_pos[0]), torch.from_numpy(b_view[0])


def gauss_posenc(p: torch.Tensor, B: torch.Tensor, downscale: float = 1.0) -> torch.Tensor:
    """[..., 3] -> [..., 2m]: proj = (pi * p / downscale) @ B.T for B [m, 3],
    then [sin(proj), cos(proj)] (decoder.py:257-269 ``transform_points``)."""
    proj = (p / downscale * math.pi) @ B.t()
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def nerf_embed_dim(multires: int, input_dims: int = 3, include_input: bool = True) -> int:
    return input_dims * ((1 if include_input else 0) + 2 * multires)


def nerf_embedder(x: torch.Tensor, multires: int, include_input: bool = True) -> torch.Tensor:
    """Log-sampled NeRF embedder: [x, sin(f0 x), cos(f0 x), sin(f1 x), ...]
    with f_k = 2**k."""
    freqs = 2.0 ** torch.linspace(0.0, multires - 1, multires, dtype=x.dtype, device=x.device)
    scaled = x[..., None, :] * freqs[:, None]  # [..., m, d]
    sc = torch.stack([torch.sin(scaled), torch.cos(scaled)], dim=-2)  # [..., m, 2, d]
    sc = sc.reshape(*x.shape[:-1], 2 * multires * x.shape[-1])
    if include_input:
        return torch.cat([x, sc], dim=-1)
    return sc


def et_embed(et: torch.Tensor, multires: int = 3) -> torch.Tensor:
    """Pose-signal embedding: PE(euler) ++ PE(translation) -> [..., 42]."""
    return torch.cat(
        [nerf_embedder(et[..., :3], multires), nerf_embedder(et[..., 3:], multires)],
        dim=-1,
    )
