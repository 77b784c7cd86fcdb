"""The training step (port of dfanerf_tpu/train/step.py).

One step is one reference train iteration (run_nerf_com_trainExpLater.py:
738-931): draw a training frame and ``n_rand`` of its pixels, render their
rays through both fields (render/fields.py render_ray_batch), take the MSE
of the head-only and the composite render against their targets (plus the
opt-in distortion term and the opt-in serving-bake sparsity prior),
backpropagate, optionally clip, and step the staged Adam groups whose stage
has begun.

The step is split in two:
- ``TrainStep.draw_batch(generator)``: the random draws, from a host
  ``torch.Generator``. The frame index is drawn on the host, so the face
  rect and the signal window need no device read; the pixel scores, the
  depth jitter and the sparsity prior's draws are drawn on the device from
  a generator seeded by it.
- ``TrainStep.step_on_batch(state, data, batch)``: everything else. The
  tests feed it the reference package's own draws.
Nothing in a step reads a device value on the host: the stage gates come
from the host step counter, the clip scale stays a tensor, and the metrics
are returned as tensors.
The stages are spans (STAGES; dfanerf_torch/spans.py), torch.profiler
ranges under a profiler that records CPU activity: the draws, the loss (the
signals and both fields' forward render), the backward with the gradient
norm and clip, and the staged Adam update with the metrics. The backward's
kernels are launched from autograd's device thread, outside its range.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from dfanerf_torch.config import ExperimentConfig
from dfanerf_torch.core.compositing import _PositiveCumprod
from dfanerf_torch.core.rays import get_rays, linspace, rays_for_pixels
from dfanerf_torch.core.sampling import stratified_z_vals
from dfanerf_torch.data.dataset import FrameDataset, speaking_i_train
from dfanerf_torch.device import resolve_device
from dfanerf_torch.ops.fused_render import density_act
from dfanerf_torch.render.fields import render_ray_batch
from dfanerf_torch.spans import span
from dfanerf_torch.train.optim import adam_update, exp_decay_lr
from dfanerf_torch.train.signals import encode_signal, encode_signal_torso
from dfanerf_torch.train.state import OPT_GROUPS, TrainState

STAGES = ("train.draws", "train.loss", "train.backward", "train.adam")
SPARSITY_MODES = ("points", "visibility", "deadzone")


def dataset_to_device(ds: FrameDataset, device=None) -> Dict:
    """The arrays a step reads, on ``device`` (default CUDA): poses, auds,
    exps, the uint8 background and, where the dataset has them, the uint8
    targets. The training frames and the face rects are the step's own
    (TrainStep), read on the host with its host frame draw."""
    dev = resolve_device(device)
    data = {k: torch.from_numpy(np.ascontiguousarray(getattr(ds, k))).to(dev)
            for k in ("poses", "auds", "exps", "bc_img")}
    for key, val in (("imgs_head", ds.imgs_head), ("imgs_com", ds.imgs_com)):
        if val is not None:
            data[key] = torch.from_numpy(np.ascontiguousarray(val)).to(dev)
    return data


def pixel_coords_from_scores(u: torch.Tensor, H: int, W: int, n_rand: int, sample_rate: float,
                             rect) -> torch.Tensor:
    """The pixels of the ``n_rand`` largest scores u [H * W] (reference :65):
    uniform without replacement when ``sample_rate`` is 0; else that share
    from inside the face rect (rect[0], rect[2]: row origin and extent) or
    the lower half, and the rest from outside. Returns [n_rand, 2] (row, col)."""
    if sample_rate <= 0.0:
        idx = torch.topk(u, n_rand).indices
    else:
        pix = torch.arange(H * W, device=u.device)
        rows, cols = pix // W, pix % W
        r0, c0, rh, cw = (int(x) for x in rect)
        mask = ((rows >= r0) & (rows <= r0 + rh) & (cols >= c0) & (cols <= c0 + cw)
                | (rows >= H // 2))
        n_in = int(n_rand * sample_rate)
        idx_in = torch.topk(u.masked_fill(~mask, -math.inf), n_in).indices
        idx_out = torch.topk(u.masked_fill(mask, -math.inf), n_rand - n_in).indices
        idx = torch.cat([idx_in, idx_out])
    return torch.stack([idx // W, idx % W], dim=-1)


def sample_pixel_coords(generator: torch.Generator, H: int, W: int, n_rand: int,
                        sample_rate: float, rect, device=None) -> torch.Tensor:
    """pixel_coords_from_scores of uniform scores drawn from ``generator``
    (on ``device``)."""
    u = torch.rand(H * W, generator=generator, device=device)
    return pixel_coords_from_scores(u, H, W, n_rand, sample_rate, rect)


def device_generator(generator: torch.Generator, device: torch.device) -> torch.Generator:
    """The generator of a step's device draws: the host ``generator`` itself
    on the CPU, else a generator on ``device`` seeded from it."""
    if device.type == "cpu":
        return generator
    seed = int(torch.randint(2 ** 62, (), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


def distortion_loss(w: torch.Tensor, z_vals: torch.Tensor, near: float, far: float) -> torch.Tensor:
    """mip-NeRF 360's distortion (eq. 15) in its O(S) cumsum form (reference
    :251), on one stack's weights w [R, S] at normalized positions
    s = (z - near) / (far - near), the catch-all sample at s = 1:
    mean over rays of sum_ij w_i w_j |s_i - s_j| + (1/3) sum w_i^2 d_i."""
    s = (z_vals - near) / (far - near)
    sm = torch.cat([0.5 * (s[:, 1:] + s[:, :-1]), s[:, -1:]], dim=1)
    d = torch.cat([s[:, 1:] - s[:, :-1], torch.zeros_like(s[:, :1])], dim=1)
    cw = torch.cumsum(w, dim=1)
    cws = torch.cumsum(w * sm, dim=1)
    zero = torch.zeros_like(cw[:, :1])
    prev_w = torch.cat([zero, cw[:, :-1]], dim=1)
    prev_ws = torch.cat([zero, cws[:, :-1]], dim=1)
    cross = 2.0 * torch.sum(w * (sm * prev_w - prev_ws), dim=1)
    self_term = torch.sum(w * w * d, dim=1) / 3.0
    return torch.mean(cross + self_term)


def render_pixels(params, rcfg, data: Dict, hwfcxy, img_i: int, coords: torch.Tensor,
                  z_vals: torch.Tensor, signal, signal_torso: torch.Tensor, z_shape: torch.Tensor,
                  z_app: torch.Tensor, obj: int = 0, head_branch: str = "head",
                  return_weights: bool = False):
    """render_ray_batch at pixels ``coords`` [R, 2] of training frame ``img_i``
    through object ``obj``'s latents (2 obj for the head, 2 obj + 1 for the
    torso; the torso's rays from frame 0's pose), with their targets:
    (outs, target_head, target_com), outs as render_ray_batch returns them."""
    _, _, focal, cx, cy = hwfcxy
    ys, xs = coords[:, 0], coords[:, 1]
    target_head = data["imgs_head"][img_i, ys, xs].float() / 255.0
    target_com = data["imgs_com"][img_i, ys, xs].float() / 255.0
    bc_rgb = data["bc_img"][ys, xs].float() / 255.0
    rays_o, rays_d = rays_for_pixels(coords, focal, data["poses"][img_i], cx, cy)
    rays_o_t, rays_d_t = rays_for_pixels(coords, focal, data["poses"][0], cx, cy)
    outs = render_ray_batch(
        params.decoder, rcfg, rays_o, rays_d, rays_o_t, rays_d_t, z_vals, signal, signal_torso,
        z_shape[2 * obj], z_app[2 * obj], z_shape[2 * obj + 1], z_app[2 * obj + 1], bc_rgb,
        head_branch=head_branch, return_weights=return_weights)
    return outs, target_head, target_com


def staged_adam(cfg: ExperimentConfig, state: TrainState, use_smo: bool, use_exp: bool):
    """One staged Adam step (reference :397-421) of every group whose stage
    has begun, from the parameters' ``.grad`` (None steps as zero), in place;
    the gradients are cleared after. Returns the step's float32 lr."""
    tcfg, params = cfg.train, state["params"]
    lr = exp_decay_lr(state["step"], tcfg.lrate, tcfg.lrate_decay)
    gates = {"always": True, "smo": use_smo, "exp": use_exp}
    for name, lr_mult, gate_kind in OPT_GROUPS:
        group = dict(getattr(params, name).named_parameters())
        adam_update(state["opt"][name], {n: p.grad for n, p in group.items()}, group,
                    np.float32(lr * np.float32(lr_mult)), gates[gate_kind],
                    tcfg.adam_b1, tcfg.adam_b2, tcfg.adam_eps)
    for p in params.parameters():
        p.grad = None
    return lr


def psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)


def frustum_aabb(ds: FrameDataset) -> Tuple[torch.Tensor, torch.Tensor]:
    """The box around every training pose's view frustum between near and
    far (reference :142-156): the corner rays of each pose at both depths."""
    H, W, focal, cx, cy = ds.hwfcxy
    H, W = int(H), int(W)
    corners = []
    for p in np.asarray(ds.poses):
        ro, rd = get_rays(H, W, focal, torch.from_numpy(np.ascontiguousarray(p)), cx, cy)
        ro = ro.reshape(-1, 3)[[0, W - 1, -W, -1]]
        rd = rd.reshape(-1, 3)[[0, W - 1, -W, -1]]
        corners += [ro + rd * float(ds.near), ro + rd * float(ds.far)]
    corners = torch.cat(corners)
    return corners.min(0).values, corners.max(0).values


class TrainStep:
    """The step of one experiment over one dataset (reference :103):
    ``step(state, data, generator) -> (state, metrics)``, the state updated
    in place. ``data`` is dataset_to_device's; ``generator`` a CPU
    ``torch.Generator``.

    With ``sparsity_lambda > 0`` the loss adds the serving-bake density
    prior (reference :103-249), an opt-in pass that clears density in space
    no target supervises; no recipe of the repository runs it. Its modes:
    'points', the Cauchy prior log(1 + 2 sigma^2) at ``sparsity_points``
    uniform points in the frustum box; 'deadzone', the same gated to raw
    densities under ``sparsity_cutoff``; 'visibility', the prior at the
    samples of max(sparsity_points // n_samples, 16) full-frame rays whose
    weight is under 1e-4 in both stacks. Any other mode acts as 'points',
    as the reference's does."""

    def __init__(self, cfg: ExperimentConfig, ds: FrameDataset, sparsity_lambda: float = 0.0,
                 sparsity_points: int = 4096, sparsity_mode: str = "points",
                 sparsity_cutoff: float = 10.0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.hwfcxy = ds.hwfcxy
        self.H, self.W, self.focal, self.cx, self.cy = ds.hwfcxy
        self.H, self.W = int(self.H), int(self.W)
        self.i_train = np.asarray(speaking_i_train(ds))
        self.n_train = len(self.i_train)
        self.near, self.far = float(ds.near), float(ds.far)
        self.rects = (np.asarray(ds.sample_rects) if ds.sample_rects is not None
                      else np.zeros((ds.n_frames, 4), np.int32))
        self.sparsity_lambda = sparsity_lambda
        self.sparsity_points = sparsity_points
        self.sparsity_mode = sparsity_mode if sparsity_mode in SPARSITY_MODES else "points"
        self.sparsity_cutoff = sparsity_cutoff
        if sparsity_lambda > 0.0:
            self.aabb = tuple(t.to(self.device) for t in frustum_aabb(ds))
            self.down = torch.tensor([0.0, 0.0, -1.0], device=self.device)

    def __call__(self, state: TrainState, data: Dict, generator: torch.Generator):
        return self.step_on_batch(state, data, self.draw_batch(generator))

    def draw_batch(self, generator: torch.Generator) -> Dict:
        """{"img_i": host int, "coords": [n_rand, 2] long, "z_vals":
        [n_rand, n_samples]} for one step, drawn from the host generator;
        with the sparsity prior also its draws (sparse_draws)."""
        tcfg = self.cfg.train
        with span(STAGES[0]):
            img_i = int(self.i_train[int(torch.randint(self.n_train, (), generator=generator))])
            g = device_generator(generator, self.device)
            coords = sample_pixel_coords(g, self.H, self.W, tcfg.n_rand, tcfg.sample_rate,
                                         self.rects[img_i], device=self.device)
            z_vals = stratified_z_vals(self.near, self.far, tcfg.n_rand,
                                       self.cfg.render.n_samples,
                                       generator=g if tcfg.perturb else None,
                                       device=self.device)
            batch = {"img_i": img_i, "coords": coords, "z_vals": z_vals}
            if self.sparsity_lambda > 0.0:
                batch.update(self.sparse_draws(generator, g))
        return batch

    def sparse_draws(self, generator: torch.Generator, g: torch.Generator) -> Dict:
        """The prior's draws (the reference's 4th key, :350): 'sparse_u'
        [sparsity_points, 3] uniform, the points' place in the box; for
        'visibility' instead its frame 'sparse_img_i' (host) and the pixels
        'sparse_coords' of its rays."""
        if self.sparsity_mode != "visibility":
            return {"sparse_u": torch.rand((self.sparsity_points, 3), generator=g,
                                           device=self.device)}
        img_i = int(self.i_train[int(torch.randint(self.n_train, (), generator=generator))])
        return {"sparse_img_i": img_i,
                "sparse_coords": sample_pixel_coords(g, self.H, self.W, self.visibility_rays(),
                                                     0.0, None, device=self.device)}

    def visibility_rays(self) -> int:
        return max(self.sparsity_points // self.cfg.render.n_samples, 16)

    def signals(self, params, data: Dict, img_i: int, use_smo: bool):
        """(signal, signal_torso) of frame img_i over the step's n_train frames."""
        scfg = self.cfg.signal
        signal = encode_signal(params, data["auds"], data["exps"], img_i, self.n_train,
                               scfg.smo_size, use_smo, scfg.audio_net, scfg.win_size)
        signal_torso = encode_signal_torso(params, data["poses"], img_i, self.n_train,
                                           scfg.smo_torso_size, use_smo, scfg.et_multires)
        return signal, signal_torso

    def loss(self, params, state: TrainState, data: Dict, batch: Dict, use_smo: bool,
             dist_on: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(loss, loss_head, loss_com) of one batch (reference :272)."""
        tcfg = self.cfg.train
        img_i, coords, z_vals = batch["img_i"], batch["coords"], batch["z_vals"]
        signal, signal_torso = self.signals(params, data, img_i, use_smo)
        # the distortion term is 0 * dist before distortion_from: skipping it
        # leaves the loss and every gradient the same
        want_w = tcfg.distortion_lambda > 0.0 and dist_on
        outs, target_head, target_com = render_pixels(
            params, self.cfg.render, data, self.hwfcxy, img_i, coords, z_vals, signal,
            signal_torso, state["z_shape"], state["z_app"], return_weights=want_w)
        rgb_head, rgb_com = outs[0], outs[1]
        loss_head = torch.mean((rgb_head - target_head) ** 2)
        loss_com = torch.mean((rgb_com - target_com) ** 2)
        if tcfg.use_l1 and tcfg.train_together:
            loss = torch.mean(torch.abs(rgb_com - target_com))
        else:
            loss = loss_head + loss_com
        if want_w:
            dist = distortion_loss(outs[3], z_vals, self.near, self.far)
            if tcfg.distortion_stacks == "both":
                dist = dist + distortion_loss(outs[2], z_vals, self.near, self.far)
            loss = loss + tcfg.distortion_lambda * dist
        if self.sparsity_lambda > 0.0:
            if self.sparsity_mode == "visibility":
                prior = self.visibility_prior(params, state, data, batch)
            else:
                prior = self.points_prior(params, state, signal, signal_torso,
                                          batch["sparse_u"])
            loss = loss + self.sparsity_lambda * prior
        return loss, loss_head, loss_com

    def _cauchy(self, sigma: torch.Tensor) -> torch.Tensor:
        """log(1 + 2 act(sigma)^2), the density activation applied to its
        input (reference :160-162)."""
        return torch.log1p(2.0 * density_act(sigma, self.cfg.decoder.density_activation) ** 2)

    def points_prior(self, params, state: TrainState, signal, signal_torso,
                     u: torch.Tensor) -> torch.Tensor:
        """The prior at the points lo + u (hi - lo) of the frustum box, both
        fields in float32 looking down -z (reference :164-186); 'deadzone'
        gates each field's penalty to raw densities under the cutoff."""
        lo, hi = self.aabb
        pts = lo + u * (hi - lo)
        dirs = self.down.expand(pts.shape)
        _, sig_h = params.decoder(pts, dirs, state["z_shape"][0], state["z_app"][0], signal,
                                  "head")
        _, sig_t = params.decoder(pts, dirs, state["z_shape"][1], state["z_app"][1],
                                  signal_torso, "torso")
        if self.sparsity_mode == "deadzone":
            gate_h = (sig_h < self.sparsity_cutoff).float().detach()
            gate_t = (sig_t < self.sparsity_cutoff).float().detach()
            return (torch.mean(self._cauchy(sig_h) * gate_h)
                    + torch.mean(self._cauchy(sig_t) * gate_t))
        return torch.mean(self._cauchy(sig_h)) + torch.mean(self._cauchy(sig_t))

    def visibility_prior(self, params, state: TrainState, data: Dict,
                         batch: Dict) -> torch.Tensor:
        """The prior at the samples no serving render sees (reference
        :188-245): along full-frame rays of the drawn frame at linspace
        depths, each sample's penalty gated on its compositing weight being
        under 1e-4 in the head-only and the composite stack (no gradient
        through the gate), averaged over the gated samples. The signals are
        the unsmoothed ones; the penalty takes the activated densities."""
        scfg, rcfg = self.cfg.signal, self.cfg.render
        act = self.cfg.decoder.density_activation
        img_i, coords = batch["sparse_img_i"], batch["sparse_coords"]
        n_rays, S = coords.shape[0], rcfg.n_samples
        rays_o, rays_d = rays_for_pixels(coords, self.focal, data["poses"][img_i], self.cx,
                                         self.cy)
        rays_o_t, rays_d_t = rays_for_pixels(coords, self.focal, data["poses"][0], self.cx,
                                             self.cy)
        z = linspace(self.near, self.far, S, device=coords.device)

        def field_sigma(ro, rd, obj, sig, branch):
            pts = ro[:, None] + rd[:, None] * z[None, :, None]
            dirs = rd[:, None].expand(pts.shape)
            _, s = params.decoder(pts.reshape(-1, 3), dirs.reshape(-1, 3),
                                  state["z_shape"][obj], state["z_app"][obj], sig, branch)
            return density_act(s.reshape(n_rays, S), act)

        signal = encode_signal(params, data["auds"], data["exps"], img_i, self.n_train,
                               scfg.smo_size, False, scfg.audio_net, scfg.win_size)
        signal_torso = encode_signal_torso(params, data["poses"], img_i, self.n_train,
                                           scfg.smo_torso_size, False, scfg.et_multires)
        sig_h = field_sigma(rays_o, rays_d, 0, signal, "head")
        sig_t = field_sigma(rays_o_t, rays_d_t, 1, signal_torso, "torso")
        gaps = torch.cat([z[1:] - z[:-1], z.new_full((1,), rcfg.last_dist)])

        def weights(sigma, rd):
            dists = gaps[None, :] * torch.linalg.norm(rd, dim=-1, keepdim=True)
            alpha = 1.0 - torch.exp(-(sigma + 1e-6) * dists)
            trans = _PositiveCumprod.apply(torch.cat(
                [torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], dim=1))[:, :-1]
            return alpha * trans

        w_head = weights(sig_h, rays_d)
        w_com = weights(sig_h + sig_t, rays_d_t)
        unseen = (torch.maximum(w_head, w_com) < 1e-4).float().detach()
        denom = torch.clamp_min(unseen.sum(), 1.0)
        return (torch.sum(self._cauchy(sig_h) * unseen)
                + torch.sum(self._cauchy(sig_t) * unseen)) / denom

    def step_on_batch(self, state: TrainState, data: Dict, batch: Dict):
        """One step on a drawn batch: the state is updated in place (params,
        moments, step) and returned with the metrics (device tensors, and the
        host lr and img_i)."""
        scfg, tcfg = self.cfg.signal, self.cfg.train
        params, step = state["params"], state["step"]
        use_smo, use_exp = step >= scfg.nosmo_iters, step >= scfg.noexp_iters
        for p in params.parameters():
            p.grad = None
        with span(STAGES[1]):
            loss, loss_head, loss_com = self.loss(params, state, data, batch, use_smo,
                                                  step >= tcfg.distortion_from)
        with span(STAGES[2]):
            loss.backward()
            grads = [p.grad for p in params.parameters() if p.grad is not None]
            grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            if tcfg.grad_clip > 0.0:
                scale = torch.clamp_max(tcfg.grad_clip / (grad_norm + 1e-12), 1.0)
                torch._foreach_mul_(grads, scale)

        with span(STAGES[3]):
            lr = staged_adam(self.cfg, state, use_smo, use_exp)
            state["step"] = step + 1
            loss_head, loss_com = loss_head.detach(), loss_com.detach()
            metrics = {
                "loss": loss.detach(),
                "loss_head": loss_head,
                "loss_com": loss_com,
                "psnr_head": psnr(loss_head),
                "psnr_com": psnr(loss_com),
                "lr": float(lr),
                "img_i": batch["img_i"],
                # before clipping, so spikes stay visible with grad_clip on
                "grad_norm": grad_norm,
            }
        return state, metrics


def make_train_step(cfg: ExperimentConfig, ds: FrameDataset, sparsity_lambda: float = 0.0,
                    sparsity_points: int = 4096, sparsity_mode: str = "points",
                    sparsity_cutoff: float = 10.0, device=None) -> TrainStep:
    """The train step of ``cfg`` over ``ds`` on ``device`` (default CUDA),
    with the serving-bake sparsity prior when ``sparsity_lambda > 0``
    (TrainStep)."""
    return TrainStep(cfg, ds, sparsity_lambda=sparsity_lambda, sparsity_points=sparsity_points,
                     sparsity_mode=sparsity_mode, sparsity_cutoff=sparsity_cutoff, device=device)
