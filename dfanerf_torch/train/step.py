"""The training step (port of dfanerf_tpu/train/step.py).

One step is one reference train iteration (run_nerf_com_trainExpLater.py:
738-931): draw a training frame and ``n_rand`` of its pixels, render their
rays through both fields (render/fields.py render_ray_batch), take the MSE
of the head-only and the composite render against their targets (plus the
opt-in distortion term), backpropagate, optionally clip, and step the
staged Adam groups whose stage has begun.

The step is split in two:
- ``TrainStep.draw_batch(generator)``: the random draws, from a host
  ``torch.Generator``. The frame index is drawn on the host, so the face
  rect and the signal window need no device read; the pixel scores and
  depth jitter are drawn on the device from a generator seeded by it.
- ``TrainStep.step_on_batch(state, data, batch)``: everything else. The
  tests feed it the reference package's own draws.
Nothing in a step reads a device value on the host: the stage gates come
from the host step counter, the clip scale stays a tensor, and the metrics
are returned as tensors.
The stages are torch.profiler ranges (STAGES): the draws, the loss (the
signals and both fields' forward render), the backward with the gradient
norm and clip, and the staged Adam update with the metrics. The backward's
kernels are launched from autograd's device thread, outside its range.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from dfanerf_torch.config import ExperimentConfig
from dfanerf_torch.core.rays import rays_for_pixels
from dfanerf_torch.core.sampling import stratified_z_vals
from dfanerf_torch.data.dataset import FrameDataset, speaking_i_train
from dfanerf_torch.device import resolve_device
from dfanerf_torch.render.fields import render_ray_batch
from dfanerf_torch.train.optim import adam_update, exp_decay_lr
from dfanerf_torch.train.signals import encode_signal, encode_signal_torso
from dfanerf_torch.train.state import OPT_GROUPS, TrainState

STAGES = ("train.draws", "train.loss", "train.backward", "train.adam")


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


class TrainStep:
    """The step of one experiment over one dataset (reference :103):
    ``step(state, data, generator) -> (state, metrics)``, the state updated
    in place. ``data`` is dataset_to_device's; ``generator`` a CPU
    ``torch.Generator``."""

    def __init__(self, cfg: ExperimentConfig, ds: FrameDataset, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.H, self.W, self.focal, self.cx, self.cy = ds.hwfcxy
        self.H, self.W = int(self.H), int(self.W)
        self.i_train = np.asarray(speaking_i_train(ds))
        self.n_train = len(self.i_train)
        self.near, self.far = float(ds.near), float(ds.far)
        self.rects = (np.asarray(ds.sample_rects) if ds.sample_rects is not None
                      else np.zeros((ds.n_frames, 4), np.int32))

    def __call__(self, state: TrainState, data: Dict, generator: torch.Generator):
        return self.step_on_batch(state, data, self.draw_batch(generator))

    def draw_batch(self, generator: torch.Generator) -> Dict:
        """{"img_i": host int, "coords": [n_rand, 2] long, "z_vals":
        [n_rand, n_samples]} for one step, drawn from the host generator."""
        tcfg = self.cfg.train
        with record_function(STAGES[0]):
            img_i = int(self.i_train[int(torch.randint(self.n_train, (), generator=generator))])
            g = generator
            if self.device.type != "cpu":
                seed = int(torch.randint(2 ** 62, (), generator=generator))
                g = torch.Generator(device=self.device).manual_seed(seed)
            coords = sample_pixel_coords(g, self.H, self.W, tcfg.n_rand, tcfg.sample_rate,
                                         self.rects[img_i], device=self.device)
            z_vals = stratified_z_vals(self.near, self.far, tcfg.n_rand,
                                       self.cfg.render.n_samples,
                                       generator=g if tcfg.perturb else None,
                                       device=self.device)
        return {"img_i": img_i, "coords": coords, "z_vals": z_vals}

    def loss(self, params, state: TrainState, data: Dict, batch: Dict, use_smo: bool,
             dist_on: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(loss, loss_head, loss_com) of one batch (reference :272)."""
        scfg, tcfg, rcfg = self.cfg.signal, self.cfg.train, self.cfg.render
        img_i, coords, z_vals = batch["img_i"], batch["coords"], batch["z_vals"]
        signal = encode_signal(params, data["auds"], data["exps"], img_i, self.n_train,
                               scfg.smo_size, use_smo, scfg.audio_net, scfg.win_size)
        signal_torso = encode_signal_torso(params, data["poses"], img_i, self.n_train,
                                           scfg.smo_torso_size, use_smo, scfg.et_multires)
        ys, xs = coords[:, 0], coords[:, 1]
        target_head = data["imgs_head"][img_i, ys, xs].float() / 255.0
        target_com = data["imgs_com"][img_i, ys, xs].float() / 255.0
        bc_rgb = data["bc_img"][ys, xs].float() / 255.0
        rays_o, rays_d = rays_for_pixels(coords, self.focal, data["poses"][img_i], self.cx,
                                         self.cy)
        rays_o_t, rays_d_t = rays_for_pixels(coords, self.focal, data["poses"][0], self.cx,
                                             self.cy)
        # the distortion term is 0 * dist before distortion_from: skipping it
        # leaves the loss and every gradient the same
        want_w = tcfg.distortion_lambda > 0.0 and dist_on
        outs = render_ray_batch(
            params.decoder, rcfg, rays_o, rays_d, rays_o_t, rays_d_t, z_vals, signal,
            signal_torso, state["z_shape"][0], state["z_app"][0], state["z_shape"][1],
            state["z_app"][1], bc_rgb, return_weights=want_w)
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
        return loss, loss_head, loss_com

    def step_on_batch(self, state: TrainState, data: Dict, batch: Dict):
        """One step on a drawn batch: the state is updated in place (params,
        moments, step) and returned with the metrics (device tensors, and the
        host lr and img_i)."""
        scfg, tcfg = self.cfg.signal, self.cfg.train
        params, step = state["params"], state["step"]
        use_smo, use_exp = step >= scfg.nosmo_iters, step >= scfg.noexp_iters
        for p in params.parameters():
            p.grad = None
        with record_function(STAGES[1]):
            loss, loss_head, loss_com = self.loss(params, state, data, batch, use_smo,
                                                  step >= tcfg.distortion_from)
        with record_function(STAGES[2]):
            loss.backward()
            grads = [p.grad for p in params.parameters() if p.grad is not None]
            grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            if tcfg.grad_clip > 0.0:
                scale = torch.clamp_max(tcfg.grad_clip / (grad_norm + 1e-12), 1.0)
                torch._foreach_mul_(grads, scale)

        with record_function(STAGES[3]):
            lr = exp_decay_lr(step, tcfg.lrate, tcfg.lrate_decay)
            gates = {"always": True, "smo": use_smo, "exp": use_exp}
            for name, lr_mult, gate_kind in OPT_GROUPS:
                group = dict(getattr(params, name).named_parameters())
                adam_update(state["opt"][name], {n: p.grad for n, p in group.items()}, group,
                            np.float32(lr * np.float32(lr_mult)), gates[gate_kind],
                            tcfg.adam_b1, tcfg.adam_b2, tcfg.adam_eps)
            for p in params.parameters():
                p.grad = None
            state["step"] = step + 1
            loss_head, loss_com = loss_head.detach(), loss_com.detach()
            metrics = {
                "loss": loss.detach(),
                "loss_head": loss_head,
                "loss_com": loss_com,
                "psnr_head": -10.0 * torch.log(loss_head) / math.log(10.0),
                "psnr_com": -10.0 * torch.log(loss_com) / math.log(10.0),
                "lr": float(lr),
                "img_i": batch["img_i"],
                # before clipping, so spikes stay visible with grad_clip on
                "grad_norm": grad_norm,
            }
        return state, metrics


def make_train_step(cfg: ExperimentConfig, ds: FrameDataset, sparsity_lambda: float = 0.0,
                    sparsity_mode: str = "points", device=None) -> TrainStep:
    """The train step of ``cfg`` over ``ds`` on ``device`` (default CUDA).
    The serving-bake sparsity prior (``sparsity_lambda > 0``, modes 'points',
    'visibility', 'deadzone') is not ported."""
    if sparsity_lambda > 0.0:
        raise NotImplementedError(
            f"sparsity_lambda > 0 (the {sparsity_mode!r} serving-bake prior) is not ported yet "
            "(ROADMAP.md queue 1, item 2)")
    return TrainStep(cfg, ds, device=device)
