"""Temporal (time-SE) landmark loops (port of
dfanerf_tpu/pipeline/landmark_temporal.py).

The reference's time-SE variants (lib/core/function.py train_face_time_se /
validate_face_time_se, :2993-3996) feed each frame's landmark model the
previous frame's predicted heatmaps in ``IMG_CHANNEL - 3`` extra input
channels: a rolling buffer zeroed at every video boundary (a change of
``vid_idx``, :3052-3054), refilled from the model's output after each
frame. The reference package scans the frames with ``lax.scan``; here the
frames run in a loop with the buffer carried. Frames and heatmaps are
channel-first, as the port's nets are: a frame [3, H, W], its heatmaps
[C, h, w], the model's input their concatenation [3 + C, H, W].
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch


def _same_video(vid_idx) -> list:
    """Per frame, whether it continues the previous frame's video."""
    v = np.asarray(vid_idx.cpu() if torch.is_tensor(vid_idx) else vid_idx)
    return [False] + [bool(a == b) for a, b in zip(v[1:], v[:-1])]


def run_temporal_sequence(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                          frames: torch.Tensor, vid_idx, n_hm_channels: int,
                          hm_to_input: Optional[Callable] = None) -> torch.Tensor:
    """The model over a frame sequence with heatmap feedback.

    apply_fn: [3 + n_hm_channels, H, W] -> heatmaps [n_hm_channels, h, w].
    frames [F, 3, H, W]; vid_idx [F] (the feedback resets where it changes).
    hm_to_input maps a heatmap to the input's resolution (identity by
    default: the reference writes its heatmaps at IMAGE_SIZE). Returns every
    frame's heatmaps [F, n_hm_channels, h, w]."""
    if hm_to_input is None:
        hm_to_input = lambda hm: hm  # noqa: E731
    H, W = frames.shape[2:]
    prev = None
    hms = []
    for frame, keep in zip(frames, _same_video(vid_idx)):
        if not keep:
            if prev is None:  # the heatmap's shape, as the reference's eval_shape gives it
                zero_in = torch.zeros((3 + n_hm_channels, H, W), dtype=frames.dtype,
                                      device=frames.device)
                prev = apply_fn(zero_in)
            prev = torch.zeros_like(prev, dtype=torch.float32)
        prev = apply_fn(torch.cat([frame, hm_to_input(prev).to(frame.dtype)], dim=0))
        hms.append(prev)
    return torch.stack(hms)


def temporal_validate(apply_fn, frames: torch.Tensor, vid_idx, gt_landmarks,
                      n_hm_channels: int, decode_fn: Callable[[torch.Tensor], np.ndarray],
                      failure_threshold: float = 0.10) -> Dict[str, object]:
    """validate_face_time_se's metrics (function.py:3019-3027): the sequence
    with predicted-heatmap feedback, landmarks decoded by ``decode_fn``
    (one frame's heatmaps -> [L, 2]), NME and failure rate."""
    from dfanerf_torch.pipeline.landmark_eval import compute_nme_benchmark

    with torch.no_grad():
        hms = run_temporal_sequence(apply_fn, frames, vid_idx, n_hm_channels)
    preds = np.stack([np.asarray(decode_fn(h)) for h in hms])
    nme = compute_nme_benchmark(preds, np.asarray(gt_landmarks))
    return {"nme_mean": float(nme.mean()), "nme": nme,
            "failure_rate": float((nme > failure_threshold).mean()), "heatmaps": hms}


def make_temporal_train_step(apply_fn_with_params, loss_fn, optimizer_update,
                             n_hm_channels: int, teacher_forcing: bool = True):
    """train_face_time_se's contract: each frame's input carries the
    previous frame's heatmaps, the ground truth's with ``teacher_forcing``
    (stable gradients), else the model's own detached prediction (as at
    inference). The loss is the mean of the frames' losses.

    apply_fn_with_params(params, x [3 + C, H, W]) -> [C, h, w];
    loss_fn(hm, gt) -> scalar; optimizer_update(opt, grads, params) ->
    (params, opt), over dicts of tensors. Returns step(params, opt, frames
    [F, 3, H, W], gt_hms [F, C, h, w], vid_idx [F]) -> (params, opt, loss)."""

    def step(params, opt, frames, gt_hms, vid_idx):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        prev = torch.zeros_like(gt_hms[0])
        losses = []
        for frame, gt, keep in zip(frames, gt_hms, _same_video(vid_idx)):
            if not keep:
                prev = torch.zeros_like(prev)
            hm = apply_fn_with_params(leaves, torch.cat([frame, prev], dim=0))
            losses.append(loss_fn(hm, gt))
            prev = gt if teacher_forcing else hm.detach()
        loss = torch.stack(losses).mean()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            params, opt = optimizer_update(opt, dict(zip(leaves, grads)),
                                           {k: v.detach() for k, v in leaves.items()})
        return params, opt, loss.detach()

    return step
