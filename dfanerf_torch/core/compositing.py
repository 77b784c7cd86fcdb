"""Volume rendering: alpha compositing and multi-field composition (port of
dfanerf_tpu/core/compositing.py).

Float32 throughout, whatever the network's precision: interval lengths
scaled by |ray_d|, alpha = 1 - exp(-(relu(sigma) + 1e-6) * dist), the
exclusive transmittance cumprod with its 1e-10 guard and ``last_dist`` on
the final interval. ``torch.cumprod`` multiplies in another order than
XLA's cumprod, so the weights agree with the reference's to a few float32
ulps, not bit for bit (tests/test_torch_sampling.py bounds the difference).
"""

from __future__ import annotations

from typing import Tuple

import torch


def calc_volume_weights(z_vals: torch.Tensor, ray_d: torch.Tensor, sigma: torch.Tensor,
                        last_dist: float = 1e10) -> torch.Tensor:
    """Per-sample compositing weights alpha_i * T_i (reference :23).

    z_vals, sigma [..., R, S] (sigma before the relu applied here); ray_d
    [..., R, 3] unnormalized. Returns [..., R, S] weights, each ray's sum
    at most 1."""
    z_vals = z_vals.float()
    sigma = sigma.float()
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], last_dist)], dim=-1)
    dists = dists * torch.linalg.norm(ray_d.float(), dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-(torch.relu(sigma) + 1e-6) * dists)
    trans = _PositiveCumprod.apply(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], dim=-1))[..., :-1]
    return alpha * trans


class _PositiveCumprod(torch.autograd.Function):
    """torch.cumprod along the last axis of an input with no zeros (the
    transmittance factors 1 - alpha + 1e-10 are at least 1e-10). Its backward
    is torch's own formula for that case, reversed_cumsum(out * grad) / x,
    without the test for zeros torch's backward makes, which reads a device
    value on the host in every training step."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return torch.flip(torch.cumsum(torch.flip(out * grad, [-1]), dim=-1), [-1]) / x


def composite_fields(sigma: torch.Tensor, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge F density fields sampled at shared depths (reference :55):
    sigma [F, ..., R, S] (relu'd by the caller), feat [F, ..., R, S, C] ->
    (summed density [..., R, S], density-weighted feature [..., R, S, C]),
    with the 1e-4 guard on a zero denominator."""
    if sigma.shape[0] == 1:
        return sigma[0], feat[0]
    denom = sigma.sum(dim=0, keepdim=True)
    denom = torch.where(denom == 0, 1e-4, denom)
    w = sigma / denom
    return sigma.sum(dim=0), (feat * w[..., None]).sum(dim=0)


def volume_render(z_vals: torch.Tensor, ray_d: torch.Tensor, sigma: torch.Tensor,
                  feat: torch.Tensor, last_dist: float = 1e10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single- or multi-field volume render (reference :79): z_vals [R, S],
    ray_d [R, 3], sigma [F, R, S] (relu'd), feat [F, R, S, C] -> (rgb [R, C],
    weights [R, S])."""
    sigma_sum, feat_weighted = composite_fields(sigma, feat)
    weights = calc_volume_weights(z_vals, ray_d, sigma_sum, last_dist=last_dist)
    rgb = (weights[..., None] * feat_weighted.float()).sum(dim=-2)
    return rgb, weights


def apply_background_concat(feat_head: torch.Tensor, sigma_head: torch.Tensor,
                            bc_rgb: torch.Tensor, sigma_torso: torch.Tensor = None):
    """The reference's ``--concate_bg`` (reference :102; run_nerf_com_
    trainExpLater.py:863-886): the head field's last sample colour becomes
    the background pixel, the torso's last density 0, and 1e-6 is added to
    the last density of the last field of each stack (the head in the
    head-only stack, the torso in the head+torso one) so the background
    stays reachable when every density is zero.

    feat_head [R, S, 3], sigma_head [R, S] (post-relu), bc_rgb [R, 3],
    sigma_torso [R, S] or None -> (feat_head', sigma_head for the head-only
    stack, sigma_head for the composite stack (unchanged), sigma_torso' or
    None)."""
    feat_head = torch.cat([feat_head[..., :-1, :], bc_rgb[..., None, :].to(feat_head.dtype)],
                          dim=-2)
    bump = torch.zeros_like(sigma_head)
    bump[..., -1] += 1e-6
    sigma_head_headstack = sigma_head + bump
    if sigma_torso is None:
        return feat_head, sigma_head_headstack, sigma_head, None
    sigma_torso = sigma_torso.clone()
    sigma_torso[..., -1] = 0.0
    return feat_head, sigma_head_headstack, sigma_head, sigma_torso + bump
