"""Per-identity 3DMM landmark fitting and bundle adjustment (port of
dfanerf_tpu/pipeline/tracking.py), on the device with autograd and the
port's Adam (train/optim.py, over named tensors).

- ``fit_landmarks``: the focal sweep fits every candidate at once, as one
  batch of independent fits (the reference vmaps them; face_tracker.py ran
  20 fits one after another), then refits the whole sequence at the
  winning focal. Landmark MSE on the last 51 landmarks, id regulariser x8,
  exp x0.5, Adam lr 0.3; the id and exp groups step only once the
  iteration exceeds ``id_exp_after`` (1000), and advance nothing before
  (face_tracker.py:61-141).
- ``bundle_adjust``: 200 steps of the 3D points alone from zero (lr 1e-2),
  then 1000 joint steps of points and poses (lr 1e-4)
  (bundle_adjustment.py:39-60).

A step issues no host work that depends on the iteration (the Adam step
count lives on the device: train/optim.py DeviceAdam), so on a CUDA device
each kind of step (the id/exp gate off or on; each bundle adjustment
phase) is captured once in a CUDA graph and replayed: an eager step is a
few hundred launches, and the loop of thousands of them would be bound by
their issue on the host. On the CPU the same steps run eagerly. The only
reads are the final losses.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from dfanerf_torch.core.geometry import forward_transform
from dfanerf_torch.pipeline.face3dmm import Face3DMM, sub_columns
from dfanerf_torch.train.optim import DeviceAdam


class TrackParams(NamedTuple):
    """Contents of track_params_ba.pt (face_tracker.py:144-146)."""

    id: torch.Tensor      # [1, id_dim]
    exp: torch.Tensor     # [N, exp_dim]
    euler: torch.Tensor   # [N, 3]
    trans: torch.Tensor   # [N, 3]
    focal: torch.Tensor   # [1]


def lan_loss(proj: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared landmark error (util.py cal_lan_loss)."""
    return ((proj - target) ** 2).mean()


def _run_steps(step, kinds, state) -> None:
    """``step(kind)`` for each kind in ``kinds``, in order. On a CUDA device
    each distinct kind is captured once in a CUDA graph, after three
    warm-up steps on a side stream whose changes to ``state`` (every tensor
    a step changes) are undone, and the graphs are replayed."""
    if state[0].device.type != "cuda":
        for kind in kinds:
            step(kind)
        return
    with torch.no_grad():
        snapshot = [t.clone() for t in state]
    graphs = {}
    for kind in dict.fromkeys(kinds):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                step(kind)
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():
            for t, v in zip(state, snapshot):
                t.copy_(v)
        graphs[kind] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[kind]):
            step(kind)
    for kind in kinds:
        graphs[kind].replay()


@torch.enable_grad()
def _fit_batch(model: Face3DMM, lms: torch.Tensor, lands_idx, focals: torch.Tensor,
               cxy: torch.Tensor, n_iters: int, id_dim: int, exp_dim: int,
               id_exp_after: int = 1000, lr: float = 0.3):
    """One landmark fit per focal in ``focals`` [F], all at once: the fits
    share nothing but the targets, so the gradient of the sum of their
    losses is each fit's own gradient. lms: [N, 51, 2]. Returns the
    parameters ([F, ...] each) and each fit's landmark loss at its last
    gradient evaluation (before the last update), [F]."""
    n_fit, n = focals.shape[0], lms.shape[0]
    dev = lms.device
    cols = sub_columns(lands_idx).to(dev)
    k = cols.shape[0] // 3
    base_id = (model.base_id[:, cols]).contiguous()
    base_exp = (model.base_exp[:, cols]).contiguous()
    mu = model.mu[cols]
    trans = torch.zeros((n_fit, n, 3), device=dev)
    trans[..., 2] = -600.0
    p = {"id": torch.zeros((n_fit, 1, id_dim), device=dev),
         "exp": torch.zeros((n_fit, n, exp_dim), device=dev),
         "euler": torch.zeros((n_fit, n, 3), device=dev), "trans": trans}
    for t in p.values():
        t.requires_grad_(True)
    # three optimizers like the reference: id, exp, frame (euler + trans)
    groups = {"id": ("id",), "exp": ("exp",), "frame": ("euler", "trans")}
    opt = {g: DeviceAdam({k_: p[k_] for k_ in names}, lr, n_iters) for g, names in groups.items()}
    focal_rows = focals.repeat_interleave(n)
    l_lan_out = torch.zeros(n_fit, device=dev)

    def step(gate_idexp: bool) -> None:
        geo = (torch.matmul(p["id"] * model.sig_id, base_id)
               + torch.matmul(p["exp"] * model.sig_exp, base_exp) + mu)
        proj = forward_transform(geo.reshape(n_fit * n, k, 3), p["euler"].reshape(-1, 3),
                                 p["trans"].reshape(-1, 3), focal_rows, cxy)
        l_lan = ((proj[..., :2].reshape(n_fit, n, k, 2) - lms) ** 2).mean(dim=(1, 2, 3))
        l_reg = (p["id"] ** 2).mean(dim=(1, 2)) * 8.0 + (p["exp"] ** 2).mean(dim=(1, 2)) * 0.5
        live = [g for g in groups if gate_idexp or g == "frame"]
        names = [k_ for g in live for k_ in groups[g]]
        grads = dict(zip(names, torch.autograd.grad((l_lan + l_reg).sum(),
                                                    [p[k_] for k_ in names])))
        for g in live:
            opt[g].step(grads)
        with torch.no_grad():
            l_lan_out.copy_(l_lan)

    state = [t for o in opt.values() for t in o.state()] + [l_lan_out]
    _run_steps(step, [i > id_exp_after for i in range(n_iters)], state)
    return {k_: v.detach() for k_, v in p.items()}, l_lan_out


def _fit_once(model: Face3DMM, lms: torch.Tensor, lands_idx, focal, cxy: torch.Tensor,
              n_iters: int, id_dim: int, exp_dim: int, id_exp_after: int = 1000,
              lr: float = 0.3):
    """One full landmark fit at a fixed focal; returns params and the final
    landmark loss (a 0-d tensor)."""
    focals = torch.as_tensor(focal, dtype=torch.float32, device=lms.device).reshape(1)
    p, l_lan = _fit_batch(model, lms, lands_idx, focals, cxy, n_iters, id_dim, exp_dim,
                          id_exp_after, lr)
    return {k: v[0] for k, v in p.items()}, l_lan[0]


def fit_landmarks(model: Face3DMM, lms, cxy, focal_candidates=tuple(range(500, 1500, 50)),
                  sweep_stride: int = 10, n_iters: int = 2000, id_dim: int = 100,
                  exp_dim: int = 79) -> Tuple[TrackParams, float]:
    """The full tracker: the focal sweep on every ``sweep_stride``-th frame,
    then a fit of the whole sequence at the winning focal.

    lms: [N, 68, 2] detected landmarks (the fit uses the last 51), numpy or
    a tensor; the fit runs on the model's device.
    Returns (TrackParams, final landmark loss)."""
    dev = model.mu.device
    cxy = torch.as_tensor(np.asarray(cxy, np.float32), device=dev)
    lands_idx = model.lands_info[-51:]
    target = torch.as_tensor(lms, dtype=torch.float32).to(dev)[:, -51:, :]
    focals = torch.tensor(focal_candidates, dtype=torch.float32, device=dev)
    _, losses = _fit_batch(model, target[::sweep_stride].contiguous(), lands_idx, focals, cxy,
                           n_iters, id_dim, exp_dim)
    best_focal = torch.tensor(float(focal_candidates[int(torch.argmin(losses))]),
                              dtype=torch.float32, device=dev)
    params, final_lan = _fit_once(model, target, lands_idx, best_focal, cxy, n_iters, id_dim,
                                  exp_dim)
    return (TrackParams(id=params["id"], exp=params["exp"], euler=params["euler"],
                        trans=params["trans"], focal=best_focal[None]), float(final_lan))


@torch.enable_grad()
def bundle_adjust(track_xys, euler: torch.Tensor, trans: torch.Tensor, focal: torch.Tensor, cxy,
                  iters_pts: int = 200, iters_joint: int = 1000) -> Dict:
    """Two-phase bundle adjustment on the device of ``euler``. track_xys
    [N, K, 2] flow-tracked keypoints; euler, trans [N, 3] from the tracker
    (the caller divides trans by 1000 like the reference,
    bundle_adjustment.py:26); focal a scalar. Returns {'euler', 'trans',
    'focal', 'pts', 'loss'} (the bundle_adjustment.pt contract and the
    final loss) and 'loss_pts', the loss after the points-only phase."""
    dev = euler.device
    cxy = torch.as_tensor(np.asarray(cxy, np.float32), device=dev)
    track = torch.as_tensor(np.asarray(track_xys, np.float32)).to(dev)
    focal = torch.as_tensor(focal, dtype=torch.float32).to(dev)
    n, k = track.shape[0], track.shape[1]

    def proj_loss(pts, eul, tr):
        proj = forward_transform(pts[None].expand(n, k, 3), eul, tr, focal, cxy)
        return lan_loss(proj[..., :2], track)

    # phase 1: the 3D points alone, lr 1e-2; phase 2: points and poses, lr 1e-4
    pts = torch.zeros((k, 3), device=dev, requires_grad=True)
    joint = {"pts": torch.zeros((k, 3), device=dev), "euler": euler.detach().clone(),
             "trans": trans.detach().clone()}
    for t in joint.values():
        t.requires_grad_(True)
    opt1 = DeviceAdam({"pts": pts}, 1e-2, iters_pts)
    opt2 = DeviceAdam(joint, 1e-4, iters_joint)
    names = list(joint)

    def step(phase: int) -> None:
        if phase == 1:
            (g,) = torch.autograd.grad(proj_loss(pts, euler, trans), [pts])
            opt1.step({"pts": g})
        else:
            grads = torch.autograd.grad(proj_loss(joint["pts"], joint["euler"], joint["trans"]),
                                        [joint[k_] for k_ in names])
            opt2.step(dict(zip(names, grads)))

    _run_steps(step, [1] * iters_pts, opt1.state())
    with torch.no_grad():
        loss_pts = proj_loss(pts, euler, trans)
        joint["pts"].copy_(pts)
    _run_steps(step, [2] * iters_joint, opt2.state())
    with torch.no_grad():
        loss = proj_loss(joint["pts"], joint["euler"], joint["trans"])
    return {"euler": joint["euler"].detach(), "trans": joint["trans"].detach(), "focal": focal,
            "pts": joint["pts"].detach(), "loss": float(loss), "loss_pts": float(loss_pts)}
