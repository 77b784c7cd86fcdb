"""Depth sampling along rays (port of dfanerf_tpu/core/sampling.py): the
coarse depths, with training's stratified jitter, and the inverse-CDF
importance resample of the hierarchical render.

Where the reference takes a PRNG key the port takes a ``torch.Generator``.
JAX's random bits cannot be reproduced, so each random form is split in
two: a transform of the uniform draws ``u`` (``jitter_z_vals``,
``inverse_cdf``), which the tests feed JAX's own draws, and the wrapper
that draws them.

``sample_pdf`` selects with ``torch.searchsorted(right=True)`` and gathers,
as the original NeRF code does (run_nerf_helpers.py:537-581). The reference
selects the same elements with masked maxima and minima over a broadcast
comparison, a TPU workaround; at a 450x450 frame's 215,296 rays x 128 queries
x 63 bins that comparison would be a 7 GB tensor on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from dfanerf_torch.core.rays import linspace


def stratified_z_vals(near: float, far: float, n_rays: int, n_samples: int,
                      generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """Coarse depths uniformly spaced in [near, far] (reference :17),
    [n_rays, n_samples], with the reference's float32 rounding; with a
    ``generator`` (on ``device``), jittered within their bins (--perturb)."""
    t = linspace(0.0, 1.0, n_samples, device=device)
    z = (near * (1.0 - t) + far * t).expand(n_rays, n_samples)
    if generator is None:
        return z
    return jitter_z_vals(z, torch.rand(z.shape, generator=generator, device=z.device))


def jitter_z_vals(z: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Stratified jitter (reference :40-45): each depth moved to
    lower + (upper - lower) * u within the bin between its neighbours'
    midpoints, u [..., S] uniform in [0, 1)."""
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    upper = torch.cat([mids, z[..., -1:]], dim=-1)
    lower = torch.cat([z[..., :1], mids], dim=-1)
    return lower + (upper - lower) * u


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               generator: Optional[torch.Generator] = None, det: bool = False) -> torch.Tensor:
    """``n_samples`` depths per ray from the piecewise-constant PDF of
    ``weights`` [..., M] over ``bins`` [..., M + 1] (reference :49): u evenly
    spaced in [0, 1] with ``det``, else uniform draws from ``generator``."""
    shape = (*weights.shape[:-1], n_samples)
    if det:
        u = linspace(0.0, 1.0, n_samples, device=weights.device).expand(shape)
    elif generator is None:
        raise ValueError("sample_pdf: a generator is required when det=False")
    else:
        u = torch.rand(shape, generator=generator, device=weights.device)
    return inverse_cdf(bins, weights, u)


def inverse_cdf(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The inverse-CDF transform of sample_pdf at draws u [..., n]: a 1e-5
    weight floor, the CDF prefixed with 0, and interpolation denominators
    below 1e-5 clamped to 1."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1).contiguous()  # [..., M + 1]
    u = u.contiguous()
    inds = torch.searchsorted(cdf, u, right=True)
    below = (inds - 1).clamp_min(0)
    above = inds.clamp_max(cdf.shape[-1] - 1)
    cdf_below, cdf_above = cdf.gather(-1, below), cdf.gather(-1, above)
    bins_below, bins_above = bins.gather(-1, below), bins.gather(-1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def hierarchical_z_vals(z_vals: torch.Tensor, weights: torch.Tensor, n_importance: int,
                        generator: Optional[torch.Generator] = None,
                        det: bool = False) -> torch.Tensor:
    """Coarse-to-fine resample (reference :112): ``n_importance`` depths from
    the coarse weights without their two end weights, returned sorted with
    the coarse depths, [..., n_samples + n_importance]."""
    z_mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_fine = sample_pdf(z_mids.contiguous(), weights[..., 1:-1], n_importance,
                        generator=generator, det=det)
    return torch.sort(torch.cat([z_vals, z_fine.detach()], dim=-1), dim=-1).values
