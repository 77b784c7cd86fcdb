"""Landmark-model training tools (port of
dfanerf_tpu/pipeline/landmark_training.py): heatmap targets, losses, NME,
the learning-rate schedule and range test, validation, and a train step for
the face and eye heatmap nets.

Re-designs of the face-alignment training stack (lib/core/loss.py,
function.py train_face/validate_face, evaluate.py, tools/train*.py). The
port's heatmaps are NCHW, [N, K, h, w] (models/perception), where the
reference package's are [N, h, w, K]: ``gaussian_targets`` returns that
layout and the losses reduce over every element, as the reference's do.

The train step updates every floating-point tensor of the net's state
dict by its gradient with Adam, BatchNorm's running mean and variance
included: the reference package keeps them as parameters of its tree and
differentiates through its inference-mode BatchNorm, gamma * (x - mean) /
sqrt(var + eps) + beta, so its step moves them too. torch's batch_norm
takes no gradient for the running statistics, so the step runs a copy of
the net whose BatchNorm layers compute that expression; nothing updates
the statistics by momentum.
"""

from __future__ import annotations

import copy
import math
import types
from typing import Dict, Tuple

import numpy as np
import torch
from torch.func import functional_call

from dfanerf_torch.train.optim import adam_state, adam_update


def gaussian_targets(joints: torch.Tensor, heatmap_hw: Tuple[int, int], sigma: float = 1.5
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """joints [N, K, 2] (x, y) in heatmap coordinates -> targets [N, K, H, W]
    and weights [N, K] (0 for a joint outside the map, whose map is 0)."""
    H, W = heatmap_hw
    dev = joints.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, None, :]
    jx, jy = joints[..., 0][..., None, None], joints[..., 1][..., None, None]
    g = torch.exp(-((xs - jx) ** 2 + (ys - jy) ** 2) / (2.0 * sigma ** 2))
    inside = ((joints[..., 0] >= 0) & (joints[..., 0] < W) & (joints[..., 1] >= 0)
              & (joints[..., 1] < H))
    return g * inside[..., None, None], inside.to(torch.float32)


def joints_mse_loss(pred: torch.Tensor, target: torch.Tensor, target_weight=None) -> torch.Tensor:
    """0.5 * the mean squared error over every element (JointsMSELoss),
    joints weighted by target_weight [N, K]."""
    diff = pred - target
    if target_weight is not None:
        diff = diff * target_weight[..., None, None]
    return 0.5 * (diff ** 2).mean()


def wing_loss(pred: torch.Tensor, target: torch.Tensor, omega: float = 10.0,
              epsilon: float = 2.0) -> torch.Tensor:
    """WingLoss (loss.py:86-102): log region below omega, linear above."""
    d = (target - pred).abs()
    c = omega - omega * math.log(1 + omega / epsilon)
    return torch.where(d < omega, omega * torch.log(1 + d / epsilon), d - c).mean()


def adaptive_wing_loss(pred: torch.Tensor, target: torch.Tensor, omega: float = 14.0,
                       theta: float = 0.5, epsilon: float = 1.0, alpha: float = 2.1
                       ) -> torch.Tensor:
    """AWingLoss (loss.py:105-122)."""
    y = target
    d = (y - pred).abs()
    t_eps = theta / epsilon
    a = (omega * (1.0 / (1.0 + t_eps ** (alpha - y))) * (alpha - y)
         * (t_eps ** (alpha - y - 1.0)) / epsilon)
    c = theta * a - omega * torch.log(1.0 + t_eps ** (alpha - y))
    small = omega * torch.log(1.0 + (d / epsilon) ** (alpha - y))
    large = a * d - c
    return torch.where(d < theta, small, large).mean()


def compute_nme(preds, targets, box_size=None) -> np.ndarray:
    """Normalised mean error per sample (evaluate.py:99-123): 68 points by
    the inter-ocular 36/45, 98 by 60/72, 29 by 8/9, 19 by the box size,
    otherwise by the landmarks' extent. preds, targets [N, L, 2] (numpy)."""
    preds, targets = np.asarray(preds), np.asarray(targets)
    n, L = preds.shape[:2]
    out = np.zeros(n)
    for i in range(n):
        gt = targets[i]
        if L == 19:
            norm = box_size[i]
        elif L == 29:
            norm = np.linalg.norm(gt[8] - gt[9])
        elif L == 68:
            norm = np.linalg.norm(gt[36] - gt[45])
        elif L == 98:
            norm = np.linalg.norm(gt[60] - gt[72])
        else:
            norm = np.linalg.norm(gt.max(0) - gt.min(0))
        out[i] = np.mean(np.linalg.norm(preds[i] - gt, axis=1)) / max(norm, 1e-8)
    return out


def multistep_lr(base_lr: float, epoch, milestones=(90, 110), factor: float = 0.1) -> float:
    """MultiStepLR (tools/train.py:177-179; LR_STEP [90, 110], LR_FACTOR
    0.1): base_lr * factor ** (milestones passed)."""
    return base_lr * factor ** sum(float(epoch >= m) for m in milestones)


@torch.no_grad()
def validate_landmarks(net, images: torch.Tensor, gt_joints, sigma: float = 1.5,
                       modulate: bool = True, failure_threshold: float = 0.1) -> Dict:
    """validate_face (lib/core/function.py + evaluate.py): the net's heatmaps
    [N, K, h, w] decoded (Gaussian modulation, argmax, quarter refine), the
    per-sample NME in heatmap coordinates and the failure rate at
    ``failure_threshold``. ``net`` is a callable on images."""
    from dfanerf_torch.pipeline.heatmaps import decode_heatmaps

    coords, _ = decode_heatmaps(net(images), sigma=sigma, modulate=modulate)
    preds = coords.cpu().numpy()
    nme = compute_nme(preds, np.asarray(gt_joints))
    return {"nme_mean": float(nme.mean()), "nme": nme,
            "failure_rate": float((nme > failure_threshold).mean()), "preds": preds}


def trainable_tensors(net: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The tensors a step trains: every floating-point entry of the state
    dict, parameters and BatchNorm statistics (see the module note), as
    detached leaves on the net's device."""
    return {k: v.detach().clone() for k, v in net.state_dict().items()
            if v.is_floating_point()}


_LOSSES = {"mse": joints_mse_loss,
           "awing": lambda p, t, w=None: adaptive_wing_loss(p, t),
           "wing": lambda p, t, w=None: wing_loss(p, t)}


def _reference_batchnorm(bn, x):
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return (bn.weight.view(shape) * (x - bn.running_mean.view(shape))
            / torch.sqrt(bn.running_var.view(shape) + bn.eps) + bn.bias.view(shape))


def differentiable_copy(net: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``net`` in eval mode whose BatchNorm layers compute the
    reference package's expression, differentiable in every tensor."""
    net = copy.deepcopy(net).eval()
    for m in net.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.forward = types.MethodType(_reference_batchnorm, m)
    return net


def _heatmap_objective(net, tensors, images, joints, sigma, loss_fn):
    for p in tensors.values():
        p.requires_grad_(True)
    pred = functional_call(net, tensors, (images,))
    target, weight = gaussian_targets(joints, tuple(pred.shape[2:]), sigma)
    loss = loss_fn(pred, target, weight)
    grads = torch.autograd.grad(loss, list(tensors.values()))
    for p in tensors.values():
        p.requires_grad_(False)
    return loss.detach(), dict(zip(tensors, grads))


def lr_range_test(net, tensors: Dict[str, torch.Tensor], opt: Dict, batches,
                  lr_min: float = 1e-6, lr_max: float = 1.0, sigma: float = 1.5):
    """The find_best_lr sweep (tools/find_best_lr.py): the learning rate
    ramps exponentially over the (images, joints) batches, one Adam step
    each; returns (lrs, losses), losses taken before each step. Updates
    ``tensors`` and ``opt`` in place."""
    net = differentiable_copy(net)
    n = len(batches)
    gamma = (lr_max / lr_min) ** (1.0 / max(n - 1, 1))
    lrs, losses = [], []
    lr = lr_min
    for images, joints in batches:
        loss, grads = _heatmap_objective(net, tensors, images, joints, sigma, joints_mse_loss)
        adam_update(opt, grads, tensors, lr, True)
        lrs.append(lr)
        losses.append(float(loss))
        lr *= gamma
    return np.asarray(lrs), np.asarray(losses)


def make_heatmap_train_step(net: torch.nn.Module, loss: str = "mse", lr: float = 1e-3,
                            sigma: float = 1.5):
    """The heatmap-regression train step of a net mapping images to
    heatmaps [N, K, h, w] (HRNet, the eye net; the step runs its
    ``differentiable_copy``). Returns
    (init_opt, step): ``init_opt(tensors)`` gives Adam's state for
    ``trainable_tensors(net)``, and ``step(tensors, opt, images, joints)``
    takes one Adam step in place and returns the loss before it; joints
    [N, K, 2] in heatmap coordinates. Load the trained tensors back with
    ``net.load_state_dict(tensors, strict=False)``."""
    loss_fn = _LOSSES[loss]
    net = differentiable_copy(net)

    def step(tensors, opt, images, joints):
        value, grads = _heatmap_objective(net, tensors, images, joints, sigma, loss_fn)
        adam_update(opt, grads, tensors, lr, True)
        return value

    return adam_state, step
