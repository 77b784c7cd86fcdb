"""Compositing of the pair-compacted renders and the background catch-all
(port of dfanerf_tpu/ops/fused_render.py deferred_composite :1698, bg_blend
:1663, _bg_epilogue :805 and deferred_composite_head :2369).

``deferred_composite`` marches the head-only and composite stacks over the
per-sample buffers that ops/pair_field.py writes, with the same per-sample
math as the dense kernel in its background-epilogue mode (the final sample
is the caller's ``bg_blend``). Reads are masked with ``torch.where(flag, x,
0)``, never a multiply: blocks of unlisted pairs are never written and may
hold NaN. ``_bg_epilogue`` closes the render kernel's epilogue mode: both
fields at the far plane, then ``bg_blend``. All are plain PyTorch, as the
reference leaves them to XLA.
"""

from __future__ import annotations

import torch

from dfanerf_torch.ops.fused_render import (
    R_T, S_SLAB, density_act, packed_field, view_bias,
)
from dfanerf_torch.ops.occupancy import packed_sigma_xla


def deferred_composite(buf_h, buf_t, occ: torch.Tensor, rays_d: torch.Tensor,
                       rays_d_t: torch.Tensor, z_vals: torch.Tensor,
                       with_diagnostics: bool = True, buf_h2=None, buf_t2=None, occ2=None,
                       s_slab: int = None, with_ray_diag: bool = False, ray_err_bc=None,
                       with_keys: bool = False):
    """Composite two pair_field_eval buffers.

    buf_h/buf_t: (sigma, r, g, b), each [J, sp, NT] at ``s_slab`` = sp
    samples per slab (8 by default, 4 for the half-slabs of occ_pack2); occ
    [2, T, J] masks every (tile, slab) the pair lists may have skipped; rays
    [T * 256, 3]. Returns (acc_head [n, 3], acc_com [n, 3], t_head [n, 1],
    t_com [n, 1]) and, with ``with_diagnostics``, the per-(tile, slab)
    maxima over each tile's rays of the slab-start transmittances
    (tile_trans_head, tile_trans_com [T, J]) and of each field's summed
    compositing weight over both stacks (contrib_head, contrib_torso [T, J]).

    With the diagnostics and ``with_ray_diag`` (the budgeted prune's input,
    reference :1889-1937) two more outputs [J, T, 256] follow, each field's
    drop cost per (slab, tile, ray): its compositing mass over both stacks,
    or with ``ray_err_bc`` (the background pixels [n, 3]) a first-order
    estimate of the colour error of dropping the pair, which renormalizes
    the ray's remaining transmittance onto what lies behind it (later
    slabs and the background): per channel |sum w c - (sum w) c_behind|,
    the largest over channels and, for the head, over both stacks.

    With ``with_keys`` (occ_live_keys, the served frame's own prune keys;
    reference :1815-1860) the outputs are (acc_head, acc_com, t_head, t_com,
    keys), whatever ``with_diagnostics`` says: keys holds four [T, J]
    per-(tile, slab) maxima over each tile's rays, the slab-start
    transmittances of the head-only and composite stacks and each field's
    drop cost, the colour-error estimate of ``with_ray_diag`` summed over a
    slab's samples, or without ``ray_err_bc`` the slab's compositing mass
    over both stacks.

    The packed-2 kernel's second quartets ``buf_h2``/``buf_t2`` come with
    their flag partition ``occ2`` (disjoint from ``occ``): each partition is
    unpacked under its own flags and the two are summed (reference
    :1767-1777)."""
    if (buf_h2 is None) != (occ2 is None) or (buf_h2 is None) != (buf_t2 is None):
        raise ValueError("buf_h2, buf_t2 and occ2 come together")
    J = buf_h[0].shape[0]
    NT = buf_h[0].shape[2]
    n = rays_d.shape[0]
    S = z_vals.shape[0]
    T = n // R_T
    sp = S_SLAB if s_slab is None else s_slab
    if J * sp != S:
        raise ValueError(f"buffers of {J} slabs of {sp} samples for {S} samples")

    def unpack(bufs, occ_f):
        # [S, n] per channel; flag [T, J] -> [J, 1, T, 1]
        flag = occ_f.bool().t()[:, None, :, None]

        def chan(buf):
            x = buf.reshape(J, sp, NT // R_T, R_T)[:, :, :T]
            return torch.where(flag, x.float(), 0.0).reshape(S, n)

        return chan(bufs[0]), tuple(chan(b) for b in bufs[1:])

    sig_h, rgb_h = unpack(buf_h, occ[0])
    sig_t, rgb_t = unpack(buf_t, occ[1])
    if buf_h2 is not None:
        # the partitions are disjoint, so the masked sums merge them exactly
        s_h2, r_h2 = unpack(buf_h2, occ2[0])
        s_t2, r_t2 = unpack(buf_t2, occ2[1])
        sig_h, sig_t = sig_h + s_h2, sig_t + s_t2
        rgb_h = tuple(a + b for a, b in zip(rgb_h, r_h2))
        rgb_t = tuple(a + b for a, b in zip(rgb_t, r_t2))

    # background-epilogue dists: tail 0 (the final sample is bg_blend's)
    z = z_vals.float()
    diffs = torch.cat([z[1:] - z[:-1], z.new_zeros(1)])

    def dists_for(rd):
        return diffs[:, None] * torch.linalg.norm(rd.float(), dim=-1)[None, :]

    def march(alpha, colors):
        # transmittance scan along the sample axis: accumulated colour
        # [n, 3], final transmittance [n, 1], slab-start transmittances
        # [J, n] and per-sample compositing weights [S, n]
        t = torch.cumprod(1.0 - alpha + 1e-10, dim=0)
        t_prev = torch.cat([t.new_ones((1, n)), t[:-1]], dim=0)
        w = alpha * t_prev
        acc = torch.stack([(w * c).sum(dim=0) for c in colors], dim=-1)
        return acc, t[-1:].t(), t_prev[0:S:sp], w

    alpha_h = 1.0 - torch.exp(-(sig_h + 1e-6) * dists_for(rays_d))
    acc_head, tl_h, starts_h, w_h = march(alpha_h, rgb_h)

    ssum = sig_h + sig_t
    denom = torch.where(ssum == 0.0, 1e-4, ssum)
    c_mix = tuple((sig_h * ch + sig_t * ct) / denom for ch, ct in zip(rgb_h, rgb_t))
    alpha_c = 1.0 - torch.exp(-(ssum + 1e-6) * dists_for(rays_d_t))
    acc_com, tl_c, starts_c, w_c = march(alpha_c, c_mix)
    if not (with_diagnostics or with_keys):
        return acc_head, acc_com, tl_h, tl_c

    def tile_max(x):  # [J, T, R_T] -> [T, J]
        return x.amax(dim=2).t()

    def slab_sum(x):  # [S, n] -> [J, T, R_T]
        return x.reshape(J, sp, T, R_T).sum(dim=1)

    def color_costs(m_hs, m_ch, m_ct):
        """Each field's per-(slab, tile, ray) first-order colour error of
        dropping the pair: it renormalizes the ray's remaining transmittance
        onto what lies behind it (later slabs, then the background)."""
        def behind(slab_x, tail):  # the sum over later slabs, plus tail
            rev = torch.cumsum(slab_x.flip(0), dim=0).flip(0)
            return torch.cat([rev[1:], torch.zeros_like(rev[:1])]) + tail

        bc_r = ray_err_bc.float().t().reshape(3, T, R_T)
        tlh, tlc = tl_h[:, 0].reshape(T, R_T), tl_c[:, 0].reshape(T, R_T)
        bm_h = behind(m_hs, tlh)        # the mass behind a pair that replaces it
        bm_c = behind(m_ch + m_ct, tlc)
        e_h, e_t = torch.zeros_like(m_hs), torch.zeros_like(m_ct)
        for c in range(3):
            col_hs = slab_sum(w_h * rgb_h[c])
            col_ch = slab_sum(w_c * frac_h * rgb_h[c])
            col_ct = slab_sum(w_c * frac_t * rgb_t[c])
            cb_h = behind(col_hs, tlh * bc_r[c]) / torch.clamp(bm_h, min=1e-8)
            cb_c = behind(col_ch + col_ct, tlc * bc_r[c]) / torch.clamp(bm_c, min=1e-8)
            e_h = torch.maximum(e_h, (col_hs - m_hs * cb_h).abs())
            e_h = torch.maximum(e_h, (col_ch - m_ch * cb_c).abs())
            e_t = torch.maximum(e_t, (col_ct - m_ct * cb_c).abs())
        return e_h, e_t

    frac_h = sig_h / denom
    frac_t = 1.0 - frac_h
    if with_keys:
        m_hs = slab_sum(w_h)            # head-stack mass of head pairs
        m_ch = slab_sum(w_c * frac_h)   # composite-stack mass, head share
        m_ct = slab_sum(w_c * frac_t)   # composite-stack mass, torso share
        e_h, e_t = (m_hs + m_ch, m_ct) if ray_err_bc is None else color_costs(m_hs, m_ch, m_ct)
        keys = (tile_max(starts_h.reshape(J, T, R_T)), tile_max(starts_c.reshape(J, T, R_T)),
                tile_max(e_h), tile_max(e_t))
        return acc_head, acc_com, tl_h, tl_c, keys

    mass_h, mass_t = w_h + w_c * frac_h, w_c * frac_t
    out = (acc_head, acc_com, tl_h, tl_c, tile_max(starts_h.reshape(J, T, R_T)),
           tile_max(starts_c.reshape(J, T, R_T)), tile_max(slab_sum(mass_h)),
           tile_max(slab_sum(mass_t)))
    if not with_ray_diag:
        return out
    if ray_err_bc is None:
        return out + (slab_sum(mass_h), slab_sum(mass_t))
    return out + color_costs(slab_sum(w_h), slab_sum(w_c * frac_h), slab_sum(w_c * frac_t))


def bg_blend(sh, ct, rays_d, rays_d_t, bc_rgb, last_dist, acc_head, acc_com, t_head, t_com):
    """The background catch-all at the final sample, given the far-plane
    head density sh [n, 1] and torso colour ct [n, 3] (the reference's
    bg-concat last-sample math). Returns (head [n, 3], com [n, 3])."""
    dh_l = last_dist * torch.linalg.norm(rays_d.float(), dim=-1, keepdim=True)
    dt_l = last_dist * torch.linalg.norm(rays_d_t.float(), dim=-1, keepdim=True)
    bc = bc_rgb.float()

    sh_head = sh + 1e-6
    alpha_h = 1.0 - torch.exp(-(sh_head + 1e-6) * dh_l)
    head = acc_head + (alpha_h * t_head) * bc

    st_com = 1e-6
    ssum = sh + st_com
    denom = torch.where(ssum == 0.0, 1e-4, ssum)
    c_mix = (sh * bc + st_com * ct) / denom
    alpha_c = 1.0 - torch.exp(-(ssum + 1e-6) * dt_l)
    com = acc_com + (alpha_c * t_com) * c_mix
    return head, com


def _bg_epilogue(pw_h, pw_t, rays_o, rays_d, rays_o_t, rays_d_t, z_vals, bc_rgb, last_dist,
                 acc_head, acc_com, t_head, t_com, act: str = "relu"):
    """The background catch-all of the render kernel's epilogue mode as a
    per-ray pass (reference :805): the head's density sh [n, 1] (after the
    density activation) and the torso's colour ct [n, 3] at each ray's far
    point o + d * z_vals[-1], through the packed fields with the sin/cos
    PE, then ``bg_blend`` on the kernel's accumulators [n, 3] and
    transmittances [n, 1]. Products round to the packed weights' dtype with
    float32 accumulation, as the reference's dots."""
    far = z_vals[-1]
    dtype = pw_h["w_blocks"].dtype
    sh = density_act(packed_sigma_xla(pw_h, rays_o + rays_d * far, "head", dtype), act)[:, None]
    vb_t = view_bias(pw_t, rays_d_t).to(torch.bfloat16)
    ct, _ = packed_field(pw_t, rays_o_t + rays_d_t * far, vb_t, "torso", dtype=dtype)
    return bg_blend(sh, ct, rays_d, rays_d_t, bc_rgb, last_dist, acc_head, acc_com, t_head, t_com)


def deferred_composite_head(buf, occ: torch.Tensor, dists: torch.Tensor,
                            bc_rgb: torch.Tensor) -> torch.Tensor:
    """Head-only composite of a pair buffer with per-ray dists (the
    hierarchical fine pass; reference :2369).

    buf: the (sigma, r, g, b) buffers of pair_hier.pair_field_eval_perz,
    each [J, 8, NT]; occ [T, J] the flags that built its pair list (any
    dtype, nonzero = listed); dists [S, n] per-ray interval lengths, 0 on
    the final one; bc_rgb [n, 3]. With the catch-all's last_dist >= 1e8 its
    alpha is exactly 1 in float32, so the background closes the march with
    no field value at the far sample: head = acc + t_final * bc. Returns
    [n, 3] float32."""
    J, NT = buf[0].shape[0], buf[0].shape[2]
    S, n = dists.shape
    T = n // R_T
    if S != J * S_SLAB:
        raise ValueError(f"dists for {S} samples, buffers for {J * S_SLAB}")
    flag = occ.bool().t()[:, None, :, None]

    def chan(b):
        x = b.reshape(J, S_SLAB, NT // R_T, R_T)[:, :, :T]
        return torch.where(flag, x.float(), 0.0).reshape(S, n)

    sigma = chan(buf[0])
    alpha = 1.0 - torch.exp(-(sigma + 1e-6) * dists)
    t = torch.cumprod(1.0 - alpha + 1e-10, dim=0)
    t_prev = torch.cat([t.new_ones((1, n)), t[:-1]], dim=0)
    w = alpha * t_prev
    acc = torch.stack([(w * chan(b)).sum(dim=0) for b in buf[1:]], dim=-1)
    return acc + t[-1:].t() * bc_rgb.float()
