"""The head+torso ray-batch forward (port of dfanerf_tpu/render/fields.py):
decoder evaluation, background concat, field composition and volume
rendering, the compute of a training step and of the unfused renderers.

- the head field renders alone against the head+neck target: its stack gets
  the background colour as its last sample and a +1e-6 last-sample density;
- the composite stacks [head, torso]: the torso's last density is zeroed
  (only the head carries the background) and, as the stack's last field,
  gets the +1e-6;
- the head-only render composites with the head rays' norms, the composite
  with the torso rays' norms.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dfanerf_torch.config import RenderConfig
from dfanerf_torch.core.compositing import volume_render
from dfanerf_torch.core.sampling import hierarchical_z_vals
from dfanerf_torch.models.decoder import Decoder
from dfanerf_torch.ops.fused_render import density_act


def compute_dtype_of(rcfg: RenderConfig) -> Optional[torch.dtype]:
    """The decoder's compute dtype for a render config: None is float32."""
    return torch.bfloat16 if rcfg.compute_dtype == "bfloat16" else None


def _last_bumped(sigma: torch.Tensor, last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sigma [R, S] with its last sample replaced by ``last`` (default: the
    same) plus 1e-6."""
    last = sigma[:, -1:] if last is None else last
    return torch.cat([sigma[:, :-1], last + 1e-6], dim=1)


def _field(decoder: Decoder, branch: str, ro, rd, z_vals, sig, zs, za, dt):
    """feat [R, S, 3] and activated density [R, S] of one field at the
    points ro + rd * z."""
    R, S = z_vals.shape
    pts = ro[:, None, :] + rd[:, None, :] * z_vals[..., None]
    feat, sigma = decoder(pts.reshape(-1, 3), rd.repeat_interleave(S, dim=0), zs, za, sig,
                          branch, compute_dtype=dt)
    return (feat.reshape(R, S, -1),
            density_act(sigma.reshape(R, S), decoder.cfg.density_activation))


def render_ray_batch(
    decoder: Decoder,
    rcfg: RenderConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    rays_o_torso: torch.Tensor,
    rays_d_torso: torch.Tensor,
    z_vals: torch.Tensor,
    signal: Optional[torch.Tensor],
    signal_torso: torch.Tensor,
    z_shape_head: torch.Tensor,
    z_app_head: torch.Tensor,
    z_shape_torso: torch.Tensor,
    z_app_torso: torch.Tensor,
    bc_rgb: Optional[torch.Tensor],
    head_branch: str = "head",
    return_weights: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Render one ray batch through both fields (reference :32).

    rays_* [R, 3] (the torso's from the frame-0 pose), z_vals [R, S] shared
    depths, signal [dim_signal] (unused by 'head_listener', the reference's
    listener objects), signal_torso [dim_et_embed], z_* [z_dim] latents,
    bc_rgb [R, 3] (needed with rcfg.concate_bg).

    Returns rgb_head, rgb_com [R, 3]; with ``return_weights`` also each
    stack's compositing weights w_head, w_com [R, S]."""
    dt = compute_dtype_of(rcfg)
    feat_h, sigma_h = _field(decoder, head_branch, rays_o, rays_d, z_vals,
                             signal if head_branch == "head" else None,
                             z_shape_head, z_app_head, dt)
    feat_t, sigma_t = _field(decoder, "torso", rays_o_torso, rays_d_torso, z_vals, signal_torso,
                             z_shape_torso, z_app_torso, dt)
    if rcfg.concate_bg:
        if bc_rgb is None:
            raise ValueError("render_ray_batch: concate_bg needs bc_rgb")
        feat_h = torch.cat([feat_h[:, :-1], bc_rgb[:, None, :].to(feat_h.dtype)], dim=1)
        sigma_h_headstack = _last_bumped(sigma_h)
        sigma_t_comstack = _last_bumped(sigma_t, torch.zeros_like(sigma_t[:, -1:]))
    else:
        sigma_h_headstack, sigma_t_comstack = sigma_h, sigma_t
    rgb_head, w_head = volume_render(z_vals, rays_d, sigma_h_headstack[None], feat_h[None],
                                     last_dist=rcfg.last_dist)
    rgb_com, w_com = volume_render(z_vals, rays_d_torso, torch.stack([sigma_h, sigma_t_comstack]),
                                   torch.stack([feat_h, feat_t]), last_dist=rcfg.last_dist)
    if return_weights:
        return rgb_head, rgb_com, w_head, w_com
    return rgb_head, rgb_com


def render_head_hierarchical(
    decoder: Decoder,
    rcfg: RenderConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    z_vals: torch.Tensor,
    signal: torch.Tensor,
    z_shape: torch.Tensor,
    z_app: torch.Tensor,
    bc_rgb: Optional[torch.Tensor],
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Coarse + fine head-field render (reference :127): a coarse pass at
    z_vals, ``rcfg.n_importance`` depths resampled from its weights
    (deterministic without a ``generator``), one fine pass over the sorted
    union. The background concat applies to each pass's last sample.
    Returns the fine pass's rgb [R, 3]."""
    dt = compute_dtype_of(rcfg)

    def field(zv):
        feat, sigma = _field(decoder, "head", rays_o, rays_d, zv, signal, z_shape, z_app, dt)
        if rcfg.concate_bg:
            if bc_rgb is None:
                raise ValueError("render_head_hierarchical: concate_bg needs bc_rgb")
            feat = torch.cat([feat[:, :-1], bc_rgb[:, None, :].to(feat.dtype)], dim=1)
            sigma = _last_bumped(sigma)
        return feat, sigma

    feat_c, sigma_c = field(z_vals)
    _, weights = volume_render(z_vals, rays_d, sigma_c[None], feat_c[None],
                               last_dist=rcfg.last_dist)
    z_fine = hierarchical_z_vals(z_vals, weights, rcfg.n_importance, generator=generator,
                                 det=generator is None)
    feat_f, sigma_f = field(z_fine)
    rgb, _ = volume_render(z_fine, rays_d, sigma_f[None], feat_f[None], last_dist=rcfg.last_dist)
    return rgb
