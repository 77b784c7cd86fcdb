"""The host training loop (port of dfanerf_tpu/train/loop.py): drives the
train step, writes structured metrics, checkpoints every ``i_weights``
steps, resumes from the newest checkpoint and renders held-out frames.

Metrics go to ``metrics.jsonl`` in the run directory, one JSON object per
log event (every ``i_print`` steps and the first); the config is written
once as ``config.json``. Reading a metric waits for the device, so the loop
does so only at those steps.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from dfanerf_torch.config import ExperimentConfig
from dfanerf_torch.data.dataset import FrameDataset
from dfanerf_torch.device import resolve_device
from dfanerf_torch.train.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from dfanerf_torch.train.state import init_train_state
from dfanerf_torch.train.step import dataset_to_device, make_train_step


def train_loop(
    cfg: ExperimentConfig,
    ds: FrameDataset,
    n_iters: Optional[int] = None,
    resume: Optional[str] = "auto",
    run_dir: Optional[str] = None,
    on_metrics: Optional[Callable[[int, Dict[str, float]], None]] = None,
    profile_dir: Optional[str] = None,
    debug_nans: bool = False,
    val_render: bool = True,
    device=None,
):
    """Train on ``device`` (default CUDA) up to ``n_iters`` steps (default
    cfg.train.n_iters); returns the final state.

    resume: a checkpoint path, "auto" (the newest in run_dir) or None.
    profile_dir: write a torch.profiler trace of steps 10..20 of this run
        there (``trace.json``, Chrome trace format).
    debug_nans: run under torch.autograd.set_detect_anomaly (expensive).
    val_render: every i_test_person steps render every 100th held-out frame
        and log its PSNR (prediction | target side by side, a binary PPM).
    """
    dev = resolve_device(device)
    run_dir = run_dir or os.path.join(cfg.basedir, cfg.expname)
    os.makedirs(run_dir, exist_ok=True)
    cfg.save(os.path.join(run_dir, "config.json"))

    state = init_train_state(cfg, seed=cfg.train.seed, device=dev)
    if resume == "auto":
        resume = latest_checkpoint(run_dir)
    if resume:
        state = load_checkpoint(resume, state)
        print(f"[resume] {resume} at step {state['step']}")

    data = dataset_to_device(ds, dev)
    step_fn = make_train_step(cfg, ds, device=dev)
    n_iters = n_iters or cfg.train.n_iters
    generator = torch.Generator().manual_seed(cfg.train.seed + 1)
    start = state["step"]
    prof = None
    t0 = time.time()
    with open(os.path.join(run_dir, "metrics.jsonl"), "a") as mf, \
            torch.autograd.set_detect_anomaly(debug_nans):
        for i in range(start, n_iters):
            if profile_dir and i == start + 10:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if dev.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=activities)
                prof.start()
            state, metrics = step_fn(state, data, generator)
            if prof is not None and i == start + 20:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                prof.stop()
                os.makedirs(profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
                prof = None
                print(f"[profile] trace written to {profile_dir}")
            if (i + 1) % cfg.train.i_print == 0 or i == start:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=i + 1, wall=round(time.time() - t0, 2))
                mf.write(json.dumps(m) + "\n")
                mf.flush()
                print(f"[train] step {i + 1} loss {m['loss']:.5f} psnr_head "
                      f"{m['psnr_head']:.2f} psnr_com {m['psnr_com']:.2f}")
                if on_metrics:
                    on_metrics(i + 1, m)
            if val_render and (i + 1) % cfg.train.i_test_person == 0 and len(ds.i_val):
                _render_val(cfg, ds, data, state, run_dir, i + 1, mf, dev)
            if (i + 1) % cfg.train.i_weights == 0:
                path = os.path.join(run_dir, f"{i + 1:06d}.npz")
                save_checkpoint(path, state)
                print(f"[ckpt] {path}")
    return state


def _render_val(cfg, ds, data, state, run_dir, step, mf, dev):
    """Every 100th held-out frame: prediction | target images and the mean
    PSNR into metrics.jsonl (the reference's [TEST] lines). The images are
    PPM, not the reference's JPEG: numpy alone writes them."""
    from dfanerf_torch.render.audio_video import write_ppm
    from dfanerf_torch.render.renderer import render_video_frames

    out_dir = os.path.join(run_dir, f"test_{step}")
    os.makedirs(out_dir, exist_ok=True)
    idx = list(ds.i_val[::100]) or [int(ds.i_val[0])]
    frames, _ = render_video_frames(state, data, cfg, ds.hwfcxy, ds.near, ds.far, idx,
                                    pose_body=data["poses"][0],
                                    use_smoothing=state["step"] >= cfg.signal.nosmo_iters,
                                    device=dev)
    psnrs = []
    for k, fi in enumerate(idx):
        gt = np.asarray(ds.imgs_com[fi])
        pred = frames[k]
        write_ppm(os.path.join(out_dir, f"test_{k:03d}.ppm"), np.concatenate([pred, gt], axis=1))
        mse = float(np.mean((pred.astype(np.float32) / 255 - gt.astype(np.float32) / 255) ** 2))
        psnrs.append(-10.0 * np.log10(max(mse, 1e-10)))
    m = {"step": step, "val_psnr": float(np.mean(psnrs)), "n_val": len(idx)}
    mf.write(json.dumps(m) + "\n")
    mf.flush()
    print(f"[val] step {step} psnr {m['val_psnr']:.2f} ({len(idx)} frames)")
