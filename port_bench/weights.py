"""The seeded weights of a configuration, made on the device in two calls of a
``torch.Generator`` there, as a name -> tensor dict under the names of the
program's parameter tree (the interface both sides read), and the density
calibration that stands in for a trained model's empty space.

Every layer is drawn as torch's default init draws it, U(-1/sqrt(fan_in),
+1/sqrt(fan_in)) for weight and bias; the latents z_shape and z_app are
standard normal. Random weights give densities that vary little over space
(a few 1e-2 around the density bias), so the occupancy flags would be all
on or all off. ``calibrate`` shifts the density bias so that a stated
quantile of one field's raw density over a fixed probe of the frustum sits
at the occupancy grid's node threshold (occ_sigma_thresh / 4): a stated
share of space is occupied, the same in every run.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np
import torch

from port_bench import reference

Shapes = "OrderedDict[str, Tuple[int, ...]]"
PROBE_DEPTHS = 64


def _linear(shapes, name, n_in, n_out):
    shapes[name + ".weight"] = (n_out, n_in)
    shapes[name + ".bias"] = (n_out,)


def _conv(shapes, name, c_in, c_out, k=3):
    shapes[name + ".weight"] = (c_out, c_in, k)
    shapes[name + ".bias"] = (c_out,)


def param_shapes(model: dict) -> Shapes:
    """Every parameter of one identity at the configuration's widths."""
    dec, sig = model["decoder"], model["signal"]
    s = OrderedDict()
    Hd, Z = dec["hidden_size"], dec["z_dim"]
    pe, pe_v = 6 * dec["n_freq_posenc"], 6 * dec["n_freq_posenc_views"]
    et = dec["dim_et_embed"]
    n_skips = sum(i in dec["skips"] for i in range(dec["n_blocks"] - 1))
    d = "decoder."
    _linear(s, d + "fc_in", pe + dec["dim_signal"], Hd)
    _linear(s, d + "fc_in_listener", pe, Hd)
    _linear(s, d + "fc_in_torso", pe + et, Hd)
    for i in range(dec["n_blocks"] - 1):
        _linear(s, d + f"blocks.{i}", Hd, Hd)
    _linear(s, d + "sigma_out", Hd, 1)
    _linear(s, d + "fc_z_view", Z, Hd)
    _linear(s, d + "feat_view", Hd, Hd)
    _linear(s, d + "fc_view", pe_v, Hd)
    _linear(s, d + "feat_out", Hd, 3)
    _linear(s, d + "fc_z", Z, Hd)
    for k in range(n_skips):
        _linear(s, d + f"fc_z_skips.{k}", Z, Hd)
    for k in range(n_skips):
        _linear(s, d + f"fc_p_skips.{k}", pe + dec["dim_signal"], Hd)
    for k in range(n_skips):
        _linear(s, d + f"fc_p_skips_listener.{k}", pe, Hd)
    for k in range(n_skips):
        _linear(s, d + f"fc_p_skips_torso.{k}", pe + et, Hd)
    df, dh = d + "deform_net.", model["deformation"]["hidden_size"]
    n_def = model["deformation"]["n_blocks"]
    for chain, width in (("embed", pe), ("signal", et)):
        _linear(s, df + f"blocks_{chain}.0", pe + et, dh)
        for i in range(1, n_def - 2):
            _linear(s, df + f"blocks_{chain}.{i}", dh, dh)
        _linear(s, df + f"out_{chain}", dh, width)
    for chain, width in (("embed", pe), ("signal", et)):
        for k in range(sum(i in model["deformation"]["skips"] for i in range(n_def - 1))):
            _linear(s, df + f"fc_{chain}_skips.{k}", width, dh)
    _linear(s, "audnet.fc1", 512, 256)
    _linear(s, "audnet.fc2", 256, 128)
    _linear(s, "audnet.fc3", 128, 64)
    _linear(s, "expnet.fc1", 64, 32)
    _linear(s, "expnet.fc2", 32, 32)
    for net, dim, seq in (("audattnet", sig["dim_aud"], sig["smo_size"]),
                          ("poseattnet", et, sig["smo_torso_size"])):
        for k, (a, b) in enumerate(((dim, 16), (16, 8), (8, 4), (4, 2), (2, 1)), 1):
            _conv(s, f"{net}.conv{k}", a, b)
        _linear(s, f"{net}.att_fc", seq, seq)
    return s


def make_weights(model: dict, seed: int, device) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                                                          torch.Tensor]:
    """(params, z_shape [2, Z], z_app [2, Z]) float32 on ``device`` from
    ``seed``: one uniform draw for every parameter, one normal draw for the
    latents."""
    shapes = param_shapes(model)
    g = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(int(np.prod(v)) for v in shapes.values())
    flat = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    params, at = {}, 0
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        w_shape = shapes[name.rsplit(".", 1)[0] + ".weight"]
        fan_in = int(np.prod(w_shape[1:]))
        params[name] = flat[at:at + n].reshape(shape) / np.sqrt(fan_in)
        at += n
    Z = model["decoder"]["z_dim"]
    lat = torch.randn((4, Z), generator=g, device=device)
    return params, lat[:2].contiguous(), lat[2:].contiguous()


def probe_points(clip, stride: int, n_depths: int, device):
    """A fixed probe of the frustum: every ``stride``-th pixel's ray of the
    orbit's centre pose (eye on +z at the clip's radius), at n_depths
    uniform depths. (points [N, 3], directions [N, 3])."""
    eye = torch.tensor([0.0, 0.0, 0.6], device=device)
    c2w = torch.eye(4, device=device)
    c2w[:3, 3] = eye
    ro, rd = reference.rays(clip.H, clip.W, clip.focal, c2w)
    keep = torch.arange(clip.H * clip.W, device=device).reshape(clip.H, clip.W)[::stride, ::stride]
    ro, rd = ro[keep.reshape(-1)], rd[keep.reshape(-1)]
    z = torch.linspace(clip.near, clip.far, n_depths, device=device)
    return (ro[:, None] + rd[:, None] * z[:, None]).reshape(-1, 3), rd.repeat_interleave(n_depths, 0)


def _quantile(params, model, branch, probe, signal, z_shape, z_app, q) -> float:
    with reference.strict_float32():
        _, raw = reference.field(params, model["decoder"], branch, *probe, signal, z_shape, z_app,
                                 raw_sigma=True)
    return float(torch.quantile(raw, q))


@torch.no_grad()
def calibrate(params, z_shape, z_app, signals, model: dict, clip, field_cfg: dict,
              threshold: float, fields=("head", "torso")) -> dict:
    """Give the random field a trained field's contrast, then place the
    occupancy. The density output is scaled by ``contrast``, so that densities
    are near-binary and empty space is exactly empty under relu (random init
    varies by a few 1e-2 over space). Then the density bias is shifted
    so that the ``quantile[f]`` of the last of ``fields``' raw density over
    the probe sits at the node threshold ``threshold / 4``; with two fields,
    the head's shape latent is then scaled (over a fixed ladder) so that the
    head's quantile lands nearest it. Returns the shift and the scale."""
    params["decoder.sigma_out.weight"] *= float(field_cfg["contrast"])
    act = model["decoder"]["density_activation"]
    target = reference.density_inverse(threshold / 4.0, act)
    probe = probe_points(clip, field_cfg.get("probe_stride", 15), PROBE_DEPTHS, z_shape.device)
    qs = field_cfg["quantile"]
    last = fields[-1]
    k = 0 if last == "head" else 1
    shift = target - _quantile(params, model, last, probe, signals[k], z_shape[k], z_app[k],
                               qs[last])
    params["decoder.sigma_out.bias"] += shift
    scale = 1.0
    if len(fields) == 2:
        ladder = [2.0 ** (e / 4.0) for e in range(-8, 13)]
        z0 = z_shape[0].clone()
        gaps = [abs(_quantile(params, model, "head", probe, signals[0], z0 * s, z_app[0],
                              qs["head"]) - target) for s in ladder]
        scale = ladder[min(range(len(ladder)), key=gaps.__getitem__)]
        z_shape[0] = z0 * scale
    return {"shift": shift, "head_latent_scale": scale}
