"""The plain reference: DFA-NeRF's decoder with its positional encoding and
torso deformation field, the per-frame conditioning signals (the audio,
expression and attention nets), ray generation, volume compositing with the
background concat, and hierarchical resampling, written from the model's
equations in plain PyTorch. It imports nothing of the program: weights come
in as the benchmark's own name -> tensor dict (``weights.py``), inputs as the
benchmark's clip.

It runs in float32 with TF32 off (``strict_float32``). ``prec="fp8"``
rounds both operands of every per-point matrix product to float8 e4m3 with a
per-tensor scale and accumulates in float32: the control, one precision
below the configuration's bf16 products.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
FP8_MAX = 448.0  # largest finite float8 e4m3fn


@contextmanager
def strict_float32():
    """float32 products with TF32 off, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    s = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def lin(P: Params, name: str, x: torch.Tensor, prec: str = "fp32") -> torch.Tensor:
    w, b = P[name + ".weight"], P[name + ".bias"]
    if prec == "fp8":
        return fp8(x) @ fp8(w).t() + b
    return x @ w.t() + b


def leaky(x):
    return F.leaky_relu(x, 0.02)


def density(x: torch.Tensor, act: str) -> torch.Tensor:
    return F.softplus(x) if act == "softplus" else torch.relu(x)


def density_inverse(y: float, act: str) -> float:
    """The raw density at which ``density`` reaches y > 0."""
    return math.log(math.expm1(y)) if act == "softplus" else y


# ---------------------------------------------------------------- encodings

def posenc(p: torch.Tensor, n_freqs: int, downscale: float) -> torch.Tensor:
    """[..., d] -> [..., 2 n d]: per frequency pi 2^i, sin then cos of p / downscale."""
    p = p / downscale
    scaled = p[..., None, :] * (math.pi * 2.0 ** torch.arange(n_freqs, device=p.device,
                                                             dtype=p.dtype))[:, None]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1).flatten(-2)


def nerf_embed(x: torch.Tensor, multires: int) -> torch.Tensor:
    """[x, sin(x), cos(x), sin(2x), cos(2x), ...] over frequencies 2^0 .. 2^(m-1)."""
    scaled = x[..., None, :] * (2.0 ** torch.arange(multires, device=x.device,
                                                    dtype=x.dtype))[:, None]
    return torch.cat([x, torch.stack([torch.sin(scaled), torch.cos(scaled)], -2).flatten(-3)], -1)


def pose_embed(poses: torch.Tensor, multires: int) -> torch.Tensor:
    """[..., 4, 4] poses -> the torso signal's embedding of (euler, translation)."""
    R = poses[..., :3, :3]
    euler = torch.stack([torch.atan2(R[..., 2, 2], R[..., 1, 2]), torch.asin(-R[..., 0, 2]),
                         torch.atan2(R[..., 0, 0], -R[..., 0, 1])], dim=-1)
    return torch.cat([nerf_embed(euler, multires), nerf_embed(poses[..., :3, 3], multires)], -1)


# ---------------------------------------------------------------- signals

def window(arr: torch.Tensor, i: int, size: int, n_valid: int) -> torch.Tensor:
    """Rows i - size/2 .. i + size/2 - 1 of arr, zero outside [0, n_valid)."""
    idx = torch.arange(i - size // 2, i - size // 2 + size, device=arr.device)
    valid = ((idx >= 0) & (idx < n_valid)).to(arr.dtype)
    return arr[idx.clamp(0, arr.shape[0] - 1)] * valid.reshape((size,) + (1,) * (arr.ndim - 1))


def attention(P: Params, net: str, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Temporal attention over a window x [L, D]: a conv1d stack over x's first
    ``dim`` channels gives one logit per frame; softmax weights average x."""
    y = x[None, :, :dim].transpose(1, 2)
    for k in range(1, 6):
        y = leaky(F.conv1d(y, P[f"{net}.conv{k}.weight"], P[f"{net}.conv{k}.bias"], padding=1))
    att = torch.softmax(lin(P, f"{net}.att_fc", y.reshape(1, x.shape[0])), dim=1)
    return (att.reshape(-1, 1) * x).sum(dim=0)


def head_signal(P: Params, auds, exps, i: int, n_valid: int, smo: int) -> torch.Tensor:
    a = window(auds, i, smo, n_valid)
    e = window(exps, i, smo, n_valid)
    a = lin(P, "audnet.fc3", leaky(lin(P, "audnet.fc2", leaky(lin(P, "audnet.fc1", a)))))
    e = lin(P, "expnet.fc2", leaky(lin(P, "expnet.fc1", e)))
    win = torch.cat([a, e], dim=-1)
    return attention(P, "audattnet", win, win.shape[-1])


def torso_signal(P: Params, poses, i: int, n_valid: int, smo: int, multires: int) -> torch.Tensor:
    emb = pose_embed(window(poses, i, smo, n_valid), multires)
    return attention(P, "poseattnet", emb, emb.shape[-1])


# ---------------------------------------------------------------- the field

def deform(P: Params, x: torch.Tensor, n_pe: int, prec: str) -> torch.Tensor:
    """The torso deformation: two 64-wide chains (PE and pose signal), both
    reading the whole input first, a skip before their last block, and
    outputs of the input's two widths."""
    d = "decoder.deform_net."
    h = [torch.relu(lin(P, d + f"blocks_{c}.0", x, prec)) for c in ("embed", "signal")]
    n = sum(1 for k in P if k.startswith(d + "blocks_embed.") and k.endswith(".weight"))
    for k in range(1, n):
        h = [torch.relu(lin(P, d + f"blocks_{c}.{k}", v, prec)) for c, v in zip(("embed", "signal"), h)]
        if k + 1 == 4 and k < n - 1:
            h = [h[0] + lin(P, d + "fc_embed_skips.0", x[:, :n_pe], prec),
                 h[1] + lin(P, d + "fc_signal_skips.0", x[:, n_pe:], prec)]
    return torch.cat([lin(P, d + "out_embed", h[0], prec), lin(P, d + "out_signal", h[1], prec)], -1)


def field(P: Params, dec: dict, branch: str, pts, dirs, signal, z_shape, z_app,
          prec: str = "fp32", raw_sigma: bool = False):
    """One field at points pts [N, 3] seen along dirs [N, 3]: (rgb [N, 3],
    density [N]) after the sigmoid and the density activation; with
    ``raw_sigma`` the density before it."""
    d = "decoder."
    p = posenc(pts, dec["n_freq_posenc"], dec["downscale_p_by"])
    n_pe = p.shape[-1]
    p = torch.cat([p, signal.expand(p.shape[0], -1)], dim=-1)
    if branch == "torso":
        p = deform(P, p, n_pe, prec) + p
    suffix = "" if branch == "head" else "_torso"
    net = torch.relu(lin(P, d + f"fc_in{suffix}", p, prec) + lin(P, d + "fc_z", z_shape))
    n_blocks = dec["n_blocks"] - 1
    for idx in range(n_blocks):
        net = torch.relu(lin(P, d + f"blocks.{idx}", net, prec))
        if idx + 1 in dec["skips"] and idx < n_blocks - 1:
            k = sorted(dec["skips"]).index(idx + 1)
            net = (net + lin(P, d + f"fc_z_skips.{k}", z_shape)
                   + lin(P, d + f"fc_p_skips{suffix}.{k}", p, prec))
    sigma = lin(P, d + "sigma_out", net, prec)[:, 0]
    if raw_sigma:
        return None, sigma
    net = lin(P, d + "feat_view", net, prec) + lin(P, d + "fc_z_view", z_app)
    rd = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    net = torch.relu(net + lin(P, d + "fc_view",
                               posenc(rd, dec["n_freq_posenc_views"], dec["downscale_p_by"]), prec))
    rgb = torch.sigmoid(lin(P, d + "feat_out", net, prec))
    return rgb, density(sigma, dec["density_activation"])


# ---------------------------------------------------------------- rays, compositing

def rays(H: int, W: int, focal: float, c2w: torch.Tensor):
    """Pinhole rays of every pixel, row-major: (origins, directions) [H W, 3]."""
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=c2w.device),
                          torch.arange(W, dtype=torch.float32, device=c2w.device), indexing="ij")
    dirs = torch.stack([(i - W * 0.5) / focal, -(j - H * 0.5) / focal, -torch.ones_like(i)], -1)
    rd = dirs.reshape(-1, 3) @ c2w[:3, :3].t()
    return c2w[:3, 3].expand(rd.shape), rd


def weights(z: torch.Tensor, rd: torch.Tensor, sigma: torch.Tensor, last_dist: float):
    """Compositing weights alpha_i T_i [R, S] at depths z [R, S]."""
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], last_dist)], dim=1)
    dists = dists * torch.linalg.norm(rd, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-(torch.relu(sigma) + 1e-6) * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], 1), 1)
    return alpha * trans[:, :-1]


def composite(z, rd, sigmas, rgbs, last_dist):
    """Fields sharing depths: densities add, colours mix by density share."""
    if len(sigmas) == 1:
        sigma, rgb = sigmas[0], rgbs[0]
    else:
        sigma = sum(sigmas)
        denom = torch.where(sigma == 0, 1e-4, sigma)
        rgb = sum(s[..., None] / denom[..., None] * c for s, c in zip(sigmas, rgbs))
    w = weights(z, rd, sigma, last_dist)
    return (w[..., None] * rgb).sum(dim=1), w


def _eval(P, dec, branch, ro, rd, z, signal, zs, za, prec):
    R, S = z.shape
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    rgb, sigma = field(P, dec, branch, pts.reshape(-1, 3), rd.repeat_interleave(S, 0), signal,
                       zs, za, prec)
    return rgb.reshape(R, S, 3), sigma.reshape(R, S)


def with_background(rgb, sigma, bc, bump=True):
    """The background concat: the last sample's colour is the background
    pixel and its density gets +1e-6."""
    rgb = torch.cat([rgb[:, :-1], bc[:, None, :]], dim=1)
    return rgb, torch.cat([sigma[:, :-1], sigma[:, -1:] + 1e-6], dim=1) if bump else sigma


@torch.no_grad()
def head_torso_frame(P, dec, rcfg, frame, hwf, prec="fp32", block=8192):
    """The dense no-skip frame of both fields over the background: (head
    [H, W, 3], composite [H, W, 3]). ``frame`` holds pose, pose_torso,
    signal, signal_torso, z_shape [2, Z], z_app [2, Z] and bc [H W, 3] in
    [0, 1]."""
    H, W, focal = hwf
    ro, rd = rays(H, W, focal, frame["pose"])
    ro_t, rd_t = rays(H, W, focal, frame["pose_torso"])
    z1 = torch.linspace(rcfg["near"], rcfg["far"], rcfg["n_samples"], device=ro.device)
    zs, za = frame["z_shape"], frame["z_app"]
    heads, coms = [], []
    for a in range(0, H * W, block):
        sl = slice(a, min(a + block, H * W))
        z = z1.expand(sl.stop - a, -1)
        rgb_h, s_h = _eval(P, dec, "head", ro[sl], rd[sl], z, frame["signal"], zs[0], za[0], prec)
        rgb_t, s_t = _eval(P, dec, "torso", ro_t[sl], rd_t[sl], z, frame["signal_torso"], zs[1],
                           za[1], prec)
        rgb_h, s_hh = with_background(rgb_h, s_h, frame["bc"][sl])
        s_tc = torch.cat([s_t[:, :-1], torch.full_like(s_t[:, -1:], 1e-6)], dim=1)
        heads.append(composite(z, rd[sl], [s_hh], [rgb_h], rcfg["last_dist"])[0])
        coms.append(composite(z, rd_t[sl], [s_h, s_tc], [rgb_h, rgb_t], rcfg["last_dist"])[0])
    return torch.cat(heads).reshape(H, W, 3), torch.cat(coms).reshape(H, W, 3)


def sample_pdf(bins: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """n deterministic depths (u evenly spaced in [0, 1]) from the piecewise
    constant PDF of w [R, M] over bins [R, M + 1]."""
    w = w + 1e-5
    cdf = torch.cumsum(w / w.sum(dim=-1, keepdim=True), dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1).contiguous()
    u = torch.linspace(0.0, 1.0, n, device=w.device).expand(w.shape[0], n).contiguous()
    inds = torch.searchsorted(cdf, u, right=True)
    lo, hi = (inds - 1).clamp_min(0), inds.clamp_max(cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(1, lo), cdf.gather(1, hi)
    b0, b1 = bins.gather(1, lo), bins.gather(1, hi)
    denom = torch.where(c1 - c0 < 1e-5, torch.ones_like(c1), c1 - c0)
    return b0 + (u - c0) / denom * (b1 - b0)


@torch.no_grad()
def head_hier_frame(P, dec, rcfg, frame, hwf, prec="fp32", block=8192):
    """The no-skip coarse + fine head frame over the background [H, W, 3]:
    ``n_samples`` coarse depths, ``n_importance`` resampled from the coarse
    weights without their end weights, one fine pass over the sorted union."""
    H, W, focal = hwf
    ro, rd = rays(H, W, focal, frame["pose"])
    z1 = torch.linspace(rcfg["near"], rcfg["far"], rcfg["n_samples"], device=ro.device)
    zs, za = frame["z_shape"][0], frame["z_app"][0]
    out = []
    for a in range(0, H * W, block):
        sl = slice(a, min(a + block, H * W))
        z = z1.expand(sl.stop - a, -1)
        bc = frame["bc"][sl]
        rgb, sig = with_background(*_eval(P, dec, "head", ro[sl], rd[sl], z, frame["signal"],
                                          zs, za, prec), bc)
        w = composite(z, rd[sl], [sig], [rgb], rcfg["last_dist"])[1]
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        z_f = torch.sort(torch.cat([z, sample_pdf(mids, w[:, 1:-1], rcfg["n_importance"])], 1),
                         dim=1).values
        rgb, sig = with_background(*_eval(P, dec, "head", ro[sl], rd[sl], z_f, frame["signal"],
                                          zs, za, prec), bc)
        out.append(composite(z_f, rd[sl], [sig], [rgb], rcfg["last_dist"])[0])
    return torch.cat(out).reshape(H, W, 3)


# ---------------------------------------------------------------- training

def pixel_rays(coords: torch.Tensor, focal: float, W: int, H: int, c2w: torch.Tensor):
    """Rays of pixels coords [R, 2] (row, column)."""
    y, x = coords[:, 0].to(c2w.dtype), coords[:, 1].to(c2w.dtype)
    dirs = torch.stack([(x - W * 0.5) / focal, -(y - H * 0.5) / focal, -torch.ones_like(x)], -1)
    rd = dirs @ c2w[:3, :3].t()
    return c2w[:3, 3].expand(rd.shape), rd


def train_loss(P: Params, model: dict, data: dict, batch: dict, z_shape, z_app,
               prec: str = "fp32", rows: Optional[int] = None) -> torch.Tensor:
    """One step's loss before the signals' smoothing stage begins: the
    per-frame signals, both stacks rendered at the batch's pixels, the mean
    squared error of the head stack against the head target plus that of the
    composite against the composite target. ``rows`` keeps only the first
    rows of the batch (a fault the check must see)."""
    dec, s = model["decoder"], model["signal"]
    i, coords, z = batch["img_i"], batch["coords"], batch["z_vals"]
    if rows is not None:
        coords, z = coords[:rows], z[:rows]
    a = lin(P, "audnet.fc3", leaky(lin(P, "audnet.fc2", leaky(lin(P, "audnet.fc1",
                                                                  data["auds"][i])))))
    e = lin(P, "expnet.fc2", leaky(lin(P, "expnet.fc1", data["exps"][i])))
    sig = torch.cat([a, e], dim=-1)
    sig_t = pose_embed(data["poses"][i], s["et_multires"])
    H, W, focal = data["hwf"]
    ro, rd = pixel_rays(coords, focal, W, H, data["poses"][i])
    ro_t, rd_t = pixel_rays(coords, focal, W, H, data["poses"][0])
    ys, xs = coords[:, 0], coords[:, 1]
    bc = data["bc_img"][ys, xs].to(z.dtype) / 255.0
    rgb_h, s_h = _eval(P, dec, "head", ro, rd, z, sig, z_shape[0], z_app[0], prec)
    rgb_t, s_t = _eval(P, dec, "torso", ro_t, rd_t, z, sig_t, z_shape[1], z_app[1], prec)
    rgb_h, s_hh = with_background(rgb_h, s_h, bc)
    s_tc = torch.cat([s_t[:, :-1], torch.full_like(s_t[:, -1:], 1e-6)], dim=1)
    last = model["render"]["last_dist"]
    head = composite(z, rd, [s_hh], [rgb_h], last)[0]
    com = composite(z, rd_t, [s_h, s_tc], [rgb_h, rgb_t], last)[0]
    t_head = data["imgs_head"][i, ys, xs].to(z.dtype) / 255.0
    t_com = data["imgs_com"][i, ys, xs].to(z.dtype) / 255.0
    return torch.mean((head - t_head) ** 2) + torch.mean((com - t_com) ** 2)


def train_steps(P0: Params, model: dict, data: dict, batches, z_shape, z_app, trained,
                prec: str = "fp32", rows: Optional[int] = None):
    """The reference's steps from the weights P0 over ``batches``: the loss,
    the gradient and an Adam step (float32 bias corrections, the decayed
    learning rate) of the ``trained`` parameters, the rest held. Returns
    (losses, first gradients {name: tensor}, parameters after the steps)."""
    t = model["train"]
    P = {k: v.detach().clone().requires_grad_(k in trained) for k, v in P0.items()}
    m = {k: torch.zeros_like(P[k]) for k in trained}
    v = {k: torch.zeros_like(P[k]) for k in trained}
    losses, first = [], None
    b1, b2 = t["adam_b1"], t["adam_b2"]
    for step, batch in enumerate(batches):
        loss = train_loss(P, model, data, batch, z_shape, z_app, prec, rows)
        grads = [torch.zeros_like(P[k]) if g is None else g for k, g in zip(
            trained, torch.autograd.grad(loss, [P[k] for k in trained], allow_unused=True))]
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(trained, grads)}
        n = step + 1
        c1 = 1.0 - float(np.float32(b1) ** np.float32(n))
        c2 = 1.0 - float(np.float32(b2) ** np.float32(n))
        lr = float(np.float32(t["lrate"]) * np.power(np.float32(0.1), np.float32(step)
                                                     / np.float32(t["lrate_decay"] * 1500)))
        with torch.no_grad():
            for k, g in zip(trained, grads):
                m[k].mul_(b1).add_(g * (1.0 - b1))
                v[k].mul_(b2).add_(g * (1.0 - b2) * g)
                P[k] -= lr * (m[k] / c1) / ((v[k] / c2).sqrt() + t["adam_eps"])
    return losses, first, {k: p.detach() for k, p in P.items()}


# ---------------------------------------------------------------- skipping

# The serving paths skip work by rules their configuration states: a
# conservative occupancy of (tile, slab) blocks on a node grid, rebuilt on
# every refresh frame from that frame's inputs and held until the next, the
# tile classes that decide which field a block evaluates, and the
# hierarchical path's prunes. The reference makes these decisions itself
# from the same settings and cadence. Where a decision lies within rounding
# of its rule (a node near the threshold, a box bound near a node, a prune
# near its limit) the program may decide either way: such a block is
# uncertain. Each frame comes with its nominal render (every decision as the
# rule reads in float32) and, per pixel, a bound U on what the uncertain
# blocks can change: the sum over their samples of the transmittance that
# the certain blocks leave times the sample's full alpha (colours lie in
# [0, 1], so no choice of the uncertain blocks moves a pixel by more).

TILE = 16
SLAB = 8
SUPERSAMPLE = 2  # fine density nodes per grid step along each axis


def tile_pixels(H: int, W: int, device) -> torch.Tensor:
    """Pixel indices [T, 256] of each 16x16 tile, tiles and pixels row-major,
    edge tiles clamped to the last row and column."""
    hb, wb = -(-H // TILE), -(-W // TILE)
    t = torch.arange(TILE, device=device)
    y = (torch.arange(hb, device=device)[:, None, None, None] * TILE + t[None, None, :, None])
    x = (torch.arange(wb, device=device)[None, :, None, None] * TILE + t[None, None, None, :])
    return (y.clamp(max=H - 1) * W + x.clamp(max=W - 1)).reshape(hb * wb, TILE * TILE)


def untile(v: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """[T, 256, C] in tile order -> [H, W, C]."""
    hb, wb = -(-H // TILE), -(-W // TILE)
    return v.reshape(hb, wb, TILE, TILE, -1).permute(0, 2, 1, 3, 4).reshape(
        hb * TILE, wb * TILE, -1)[:H, :W]


CORNERS = (0, TILE - 1, TILE * (TILE - 1), TILE * TILE - 1)


def block_points(o_c: torch.Tensor, d_c: torch.Tensor, z_ends: torch.Tensor) -> torch.Tensor:
    """The 8 points bounding each (tile, slab): corner rays [T, 4, 3] at the
    slab's nearest and farthest depth z_ends [T, J, 2] -> [T, J, 2, 4, 3]."""
    return o_c[:, None, None] + d_c[:, None, None] * z_ends[..., None, None]


def node_raw(P: Params, dec: dict, branch: str, lo, span, grid_res: int, signal, z_shape, z_app,
             prec: str = "fp32", block: int = 1 << 16) -> torch.Tensor:
    """Raw density at the (2 grid_res)^3 fine nodes over [lo, lo + span],
    axes (z, y, x)."""
    gf = grid_res * SUPERSAMPLE
    g = torch.linspace(0.0, 1.0, gf, device=lo.device)
    gz, gy, gx = torch.meshgrid(g, g, g, indexing="ij")
    pts = lo + torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3) * span
    raw = [field(P, dec, branch, pts[a:a + block], pts[a:a + block], signal, z_shape, z_app, prec,
                 raw_sigma=True)[1] for a in range(0, pts.shape[0], block)]
    return torch.cat(raw).reshape(gf, gf, gf)


def node_table(on: torch.Tensor) -> torch.Tensor:
    """Occupied fine nodes [Gf]^3 -> the summed-area table [G+1]^3 of the
    grid's voxels (a voxel is occupied where one of its fine nodes is),
    dilated by one voxel."""
    occ = F.max_pool3d(on.float()[None, None], SUPERSAMPLE, SUPERSAMPLE)
    occ = F.max_pool3d(occ, 3, 1, padding=1)[0, 0].long()
    return F.pad(occ, (1, 0, 1, 0, 1, 0)).cumsum(0).cumsum(1).cumsum(2)


def box_any(sat: torch.Tensor, i_lo: torch.Tensor, i_hi: torch.Tensor) -> torch.Tensor:
    """Whether the inclusive node boxes [..., 3] (x, y, z) hold an occupied voxel."""
    empty = (i_lo > i_hi).any(dim=-1)
    hi = torch.maximum(i_hi, i_lo)
    a0, b0, c0 = i_lo[..., 2], i_lo[..., 1], i_lo[..., 0]
    a1, b1, c1 = hi[..., 2] + 1, hi[..., 1] + 1, hi[..., 0] + 1
    count = (sat[a1, b1, c1] - sat[a0, b1, c1] - sat[a1, b0, c1] - sat[a1, b1, c0]
             + sat[a0, b0, c1] + sat[a0, b1, c0] + sat[a1, b0, c0] - sat[a0, b0, c0])
    return (count > 0) & ~empty


def node_box(pts: torch.Tensor, lo, span, grid_res: int, grow: float):
    """The inclusive node box [T, J, 3] of each block's points [T, J, 2, 4, 3]
    (the nodes within half a node step of the points' bounding box), grown
    (grow > 0) or shrunk by ``grow`` node steps on every side."""
    voxel = span / (grid_res - 1)
    a = (pts.amin(dim=(2, 3)) - lo) / voxel - 0.5
    b = (pts.amax(dim=(2, 3)) - lo) / voxel + 0.5
    i_lo = torch.clamp(torch.ceil(a - grow), 0, grid_res - 1).long()
    i_hi = torch.clamp(torch.floor(b + grow), 0, grid_res - 1).long()
    return i_lo, i_hi


class Grid:
    """One field's occupancy grid of a refresh frame: the summed-area tables
    of its nodes above the threshold by more than ``margin`` (sure), above it
    (nominal) and above it less ``margin`` (maybe), over [lo, lo + span]."""

    def __init__(self, raw: torch.Tensor, thr_raw: float, margin: float, lo, span, grid_res: int):
        self.lo, self.span, self.grid_res = lo, span, grid_res
        self.sats = [node_table(raw > thr_raw + m) for m in (margin, 0.0, -margin)]

    def flags(self, pts: torch.Tensor, eps: float):
        """(sure, nominal, maybe) [T, J] bool flags of the blocks pts
        [T, J, 2, 4, 3]: a block is flagged when its node box meets an
        occupied voxel; the sure box is shrunk and the maybe box grown by eps."""
        return tuple(box_any(sat, *node_box(pts, self.lo, self.span, self.grid_res, g))
                     for sat, g in zip(self.sats, (-eps, 0.0, eps)))


def grid_extent(pts: torch.Tensor):
    allp = pts.reshape(-1, 3)
    lo = allp.amin(0)
    return lo, torch.clamp_min(allp.amax(0) - lo, 1e-6)


def tiled_rays(hwf, c2w: torch.Tensor, pix: torch.Tensor):
    """Rays [T, 256, 3] of the tiles' pixels."""
    ro, rd = rays(*hwf, c2w)
    return ro[pix], rd[pix]


def decisions(P: Params, dec: dict, rcfg: dict, frame: dict, hwf, margin: float, eps: float,
              prec: str = "fp32") -> dict:
    """The tile-class path's decisions at a refresh frame: each field's
    (sure, nominal, maybe) flags [T, J] over the slabs of the shared depths,
    on one node grid spanning both fields' blocks."""
    H, W, _ = hwf
    pix = tile_pixels(H, W, frame["pose"].device)
    z = torch.linspace(rcfg["near"], rcfg["far"], rcfg["n_samples"], device=pix.device)
    zs = z.reshape(-1, SLAB)
    pts = []
    for pose in (frame["pose"], frame["pose_torso"]):
        ro, rd = tiled_rays(hwf, pose, pix[:, list(CORNERS)])
        z_ends = torch.stack([zs[:, 0], zs[:, -1]], dim=-1).expand(ro.shape[0], -1, -1)
        pts.append(block_points(ro, rd, z_ends))
    lo, span = grid_extent(torch.cat(pts))
    thr = density_inverse(rcfg["occ_sigma_thresh"] / 4.0, dec["density_activation"])
    out = {}
    for k, (branch, sig) in enumerate((("head", "signal"), ("torso", "signal_torso"))):
        raw = node_raw(P, dec, branch, lo, span, rcfg["occ_grid_res"], frame[sig],
                       frame["z_shape"][k], frame["z_app"][k], prec)
        out[branch] = Grid(raw, thr, margin, lo, span, rcfg["occ_grid_res"]).flags(pts[k], eps)
    return out


def class_masks(flags: dict):
    """Which blocks each field evaluates under the tile classes: a tile
    flagged in both fields runs both fields on their joint flags, any other
    tile its own field on its own flags; padding a class to its bucket can
    borrow any tile into the two-field class, so a field may also run
    wherever the joint flags may be set. Returns {field: (certain, nominal,
    possible)} [T, J]."""
    (hs, hn, hm), (ts, tn, tm) = flags["head"], flags["torso"]
    both_s = (hs.any(1) & ts.any(1))[:, None]
    both_n = (hn.any(1) & tn.any(1))[:, None]
    joint_s, joint_n, joint_m = hs | ts, hn | tn, hm | tm
    return {"head": (hs | (joint_s & both_s), hn | (joint_n & both_n), joint_m),
            "torso": (ts | (joint_s & both_s), tn | (joint_n & both_n), joint_m)}


def _sample_mask(m: torch.Tensor, S: int) -> torch.Tensor:
    """Block flags [t, J] -> sample flags [t, 1, S] over all samples but the
    last, which the background closes and no flag skips."""
    out = m.repeat_interleave(SLAB, dim=1).float()[:, None, :]
    out[..., -1] = 1.0
    return out


def _alpha(sigma, dists):
    return 1.0 - torch.exp(-(torch.relu(sigma) + 1e-6) * dists)


def _trans(alpha):
    return torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], -1),
                         -1)[..., :-1]


def uncertainty(alpha_full, trans_cert, unc):
    """U per ray: the uncertain samples' full alpha times the transmittance
    that the certain samples leave."""
    return (unc * trans_cert * alpha_full).sum(dim=-1)


@torch.no_grad()
def head_torso_skip_frame(P, dec, rcfg, frame, masks, hwf, margin: float = 0.0, prec="fp32",
                          tiles=32):
    """The tile-class frame under the masks of ``class_masks``: (composite
    [H, W, 3] with every decision nominal, U [H, W]). The composite's last
    sample blends (sh bc + 1e-6 ct) / (sh + 1e-6): it is the background
    where the head's density sh at the far plane is well above 0 and the
    torso's colour ct where it is 0, so where the head's raw density there
    lies within ``margin`` of relu's kink the sample is uncertain too, by
    the transmittance before it times |bc - ct|."""
    H, W, focal = hwf
    pix = tile_pixels(H, W, frame["pose"].device)
    ro, rd = tiled_rays(hwf, frame["pose"], pix)
    ro_t, rd_t = tiled_rays(hwf, frame["pose_torso"], pix)
    bc = frame["bc"][pix]
    S = rcfg["n_samples"]
    z1 = torch.linspace(rcfg["near"], rcfg["far"], S, device=pix.device)
    zs, za = frame["z_shape"], frame["z_app"]
    coms, us = [], []
    for a in range(0, pix.shape[0], tiles):
        sl = slice(a, min(a + tiles, pix.shape[0]))
        n = (sl.stop - a) * TILE * TILE
        z = z1.expand(n, -1)
        r_h, d_h, r_t, d_t = (x[sl].reshape(n, 3) for x in (ro, rd, ro_t, rd_t))
        rgb_h, s_h = _eval(P, dec, "head", r_h, d_h, z, frame["signal"], zs[0], za[0], prec)
        rgb_t, s_t = _eval(P, dec, "torso", r_t, d_t, z, frame["signal_torso"], zs[1], za[1],
                           prec)
        rgb_h = torch.cat([rgb_h[:, :-1], bc[sl].reshape(n, 1, 3)], dim=1)
        s_t = torch.cat([s_t[:, :-1], torch.zeros_like(s_t[:, -1:])], dim=1)
        m = {f: [_sample_mask(x[sl], S).expand(-1, TILE * TILE, -1).reshape(n, S)
                 for x in masks[f]] for f in ("head", "torso")}
        dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], rcfg["last_dist"])],
                          1) * torch.linalg.norm(d_t, dim=-1, keepdim=True)
        last = torch.zeros_like(z)
        last[:, -1] = 1e-6
        sh, st = s_h * m["head"][1], s_t * m["torso"][1] + last
        ssum = sh + st
        denom = torch.where(ssum == 0, 1e-4, ssum)
        rgb = (sh[..., None] * rgb_h + st[..., None] * rgb_t) / denom[..., None]
        alpha = _alpha(ssum, dists)
        coms.append(((alpha * _trans(alpha))[..., None] * rgb).sum(dim=1))
        unc = sum(m[f][2] - m[f][0] for f in ("head", "torso"))
        tr_cert = _trans(_alpha(s_h * m["head"][0] + s_t * m["torso"][0] + last, dists))
        _, raw_far = field(P, dec, "head", r_h + d_h * z1[-1], d_h, frame["signal"], zs[0], za[0],
                           prec, raw_sigma=True)
        swing = (raw_far.abs() <= margin) * (bc[sl].reshape(n, 3) - rgb_t[:, -1]).abs().amax(-1)
        us.append(uncertainty(_alpha(s_h + s_t + last, dists), tr_cert, unc)
                  + tr_cert[:, -1] * swing)
    T = pix.shape[0]
    return (untile(torch.cat(coms).reshape(T, TILE * TILE, 3), H, W),
            untile(torch.cat(us).reshape(T, TILE * TILE, 1), H, W)[..., 0])


def slab_mass(w: torch.Tensor, z_f: torch.Tensor, z_c: torch.Tensor) -> torch.Tensor:
    """The coarse compositing mass inside each fine slab's depth range, the
    tile's largest: coarse weights w [t, 256, S_c] (the catch-all's, the
    last, left out) spread uniformly over their bins [z_c[k], z_c[k + 1]];
    z_f [t, 256, S_f] the sorted depths. Returns [t, S_f / 8]."""
    z_lo, z_hi = z_f[..., ::SLAB], z_f[..., SLAB - 1::SLAB]
    zb0, zb1 = z_c[:-1], z_c[1:]
    ov = torch.minimum(z_hi[..., None], zb1) - torch.maximum(z_lo[..., None], zb0)
    frac = torch.clamp(ov / (zb1 - zb0), 0.0, 1.0)
    return (w[..., None, :-1] * frac).sum(dim=-1).amax(dim=1)


def _coarse_fine(P, dec, rcfg, frame, hwf, st, sl, pix, prec):
    """One block of tiles of the hierarchical path: the coarse pass under the
    refresh frame's nominal coarse flags, the resample, and the fine blocks'
    (sure, nominal, maybe) flags after the prunes. Returns (rays, z_f,
    flags)."""
    H, W, _ = hwf
    S_c = rcfg["n_samples"]
    z_c = torch.linspace(rcfg["near"], rcfg["far"], S_c, device=pix.device)
    t = sl.stop - sl.start
    n = t * TILE * TILE
    ro, rd = (x.reshape(n, 3) for x in tiled_rays(hwf, frame["pose"], pix[sl]))
    z = z_c.expand(n, -1)
    _, sig = _eval(P, dec, "head", ro, rd, z, frame["signal"], frame["z_shape"][0],
                   frame["z_app"][0], prec)
    flag_c = st["coarse"][1][sl].repeat_interleave(SLAB, dim=1)
    sig = sig * flag_c.repeat_interleave(TILE * TILE, dim=0).float()
    sig = torch.cat([sig[:, :-1], sig[:, -1:] + 1e-6], dim=1)
    w = weights(z, rd, sig, rcfg["last_dist"])
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    z_f = torch.sort(torch.cat([z, sample_pdf(mids, w[:, 1:-1], rcfg["n_importance"])], 1),
                     dim=1).values
    J_f = z_f.shape[1] // SLAB
    zt = z_f.reshape(t, TILE * TILE, J_f, SLAB)
    z_ends = torch.stack([zt.amin(dim=(1, 3)), zt.amax(dim=(1, 3))], dim=-1)
    o_c, d_c = tiled_rays(hwf, frame["pose"], pix[sl][:, list(CORNERS)])
    sure, nom, maybe = st["grid"].flags(block_points(o_c, d_c, z_ends), st["eps"])
    # everything behind a saturated coarse transmittance drops
    pt = rcfg["occ_prune_trans"]
    t_prev = 1.0 - torch.cat([w.new_zeros((n, 1)), torch.cumsum(w, dim=1)[:, :-1]], dim=1)
    t_tile = t_prev.reshape(t, TILE * TILE, S_c).amax(dim=1)
    z0 = zt[..., 0].amin(dim=1)
    t_at = torch.where(z_c[None, None, :] >= z0[:, :, None], t_tile[:, None, :], 0.0).amax(-1)
    sure, nom, maybe = sure & (t_at > 2.0 * pt), nom & (t_at > pt), maybe & (t_at > 0.5 * pt)
    budget = rcfg.get("occ_prune_contrib", 0.0)
    if budget > 0:
        # per tile, the smallest-mass flagged slabs drop while their masses
        # sum to at most the budget; a slab well over it never drops
        mass = slab_mass(w.reshape(t, TILE * TILE, S_c), z_f.reshape(t, TILE * TILE, -1), z_c)
        m_n = torch.where(nom, mass, 0.0)
        order = torch.argsort(m_n, dim=1, stable=True)
        drop = torch.zeros_like(nom).scatter_(1, order, torch.cumsum(m_n.gather(1, order), 1)
                                              <= budget)
        sure, nom = sure & (mass > 1.5 * budget), nom & ~drop
    return (ro, rd), z_f, (sure, nom, maybe)


def hier_refresh(P, dec, rcfg, frame, hwf, margin: float, eps: float, prec="fp32",
                 tiles=32) -> dict:
    """The hierarchical path's decisions at a refresh frame: the head's node
    grid over the coarse blocks, the coarse flags, and the fine blocks'
    flags of the frame itself (its lists)."""
    H, W, _ = hwf
    pix = tile_pixels(H, W, frame["pose"].device)
    z_c = torch.linspace(rcfg["near"], rcfg["far"], rcfg["n_samples"], device=pix.device)
    zs = z_c.reshape(-1, SLAB)
    ro, rd = tiled_rays(hwf, frame["pose"], pix[:, list(CORNERS)])
    pts = block_points(ro, rd, torch.stack([zs[:, 0], zs[:, -1]], -1).expand(ro.shape[0], -1, -1))
    lo, span = grid_extent(pts)
    thr = density_inverse(rcfg["occ_sigma_thresh"] / 4.0, dec["density_activation"])
    raw = node_raw(P, dec, "head", lo, span, rcfg["occ_grid_res"], frame["signal"],
                   frame["z_shape"][0], frame["z_app"][0], prec)
    st = {"grid": Grid(raw, thr, margin, lo, span, rcfg["occ_grid_res"]), "eps": eps}
    st["coarse"] = st["grid"].flags(pts, eps)
    parts = [_coarse_fine(P, dec, rcfg, frame, hwf, st, slice(a, min(a + tiles, pix.shape[0])),
                          pix, prec)[2] for a in range(0, pix.shape[0], tiles)]
    st["list"] = tuple(torch.cat(x) for x in zip(*parts))
    return st


@torch.no_grad()
def head_hier_skip_frame(P, dec, rcfg, frame, st, hwf, prec="fp32", tiles=32):
    """The hierarchical frame under a refresh frame's decisions ``st``: the
    frame's own coarse pass and resample, its fine flags and prunes ANDed
    with the refresh frame's lists, tiles without a coarse flag the
    background. Returns (rgb [H, W, 3] with every decision nominal, U [H, W])."""
    H, W, _ = hwf
    pix = tile_pixels(H, W, frame["pose"].device)
    union = [c.any(dim=1)[:, None] for c in st["coarse"]]
    outs, us = [], []
    for a in range(0, pix.shape[0], tiles):
        sl = slice(a, min(a + tiles, pix.shape[0]))
        (ro, rd), z_f, cur = _coarse_fine(P, dec, rcfg, frame, hwf, st, sl, pix, prec)
        n, S = z_f.shape
        cert, nom, poss = (c & li[sl] & u[sl] for c, li, u in zip(cur, st["list"], union))
        rgb, sig = _eval(P, dec, "head", ro, rd, z_f, frame["signal"], frame["z_shape"][0],
                         frame["z_app"][0], prec)
        m = [x.repeat_interleave(SLAB, dim=1).repeat_interleave(TILE * TILE, dim=0).float()
             for x in (cert, nom, poss)]
        dists = torch.cat([z_f[:, 1:] - z_f[:, :-1], torch.zeros_like(z_f[:, :1])], 1)
        dists = dists * torch.linalg.norm(rd, dim=-1, keepdim=True)
        alpha = _alpha(sig * m[1], dists)
        tr = _trans(alpha)
        t_end = tr[:, -1:] * (1.0 - alpha[:, -1:] + 1e-10)
        bc = frame["bc"][pix[sl]].reshape(n, 3)
        outs.append(((alpha * tr)[..., None] * rgb).sum(dim=1) + t_end * bc)
        us.append(uncertainty(_alpha(sig, dists), _trans(_alpha(sig * m[0], dists)), m[2] - m[0]))
    T = pix.shape[0]
    return (untile(torch.cat(outs).reshape(T, TILE * TILE, 3), H, W),
            untile(torch.cat(us).reshape(T, TILE * TILE, 1), H, W)[..., 0])
