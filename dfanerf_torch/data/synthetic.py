"""The asset-free synthetic talking-head scene (port of
dfanerf_tpu/data/synthetic.py).

From the same seed this builds the same arrays as the reference package:
orbiting head poses, the audio/expression features of a scalar driving
state, the background image, intrinsics and face rects
(``make_synthetic_scene``), and with ``make_synthetic_dataset`` the
ground-truth frames: an analytic head sphere whose colour pulses with the
driving state, over a torso box and the background, volume-rendered with
the port's compositing and stored as uint8.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from dfanerf_torch.core.compositing import volume_render
from dfanerf_torch.core.rays import get_rays
from dfanerf_torch.core.sampling import stratified_z_vals
from dfanerf_torch.data.dataset import FrameDataset
from dfanerf_torch.device import resolve_device


def _lookat_pose(eye: np.ndarray, target: np.ndarray, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    z = eye - target
    z = z / np.linalg.norm(z)  # camera +z points away from the scene (looks down -z)
    x = np.cross(np.asarray(up, np.float64), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
    return c2w


def featurize_audio_state(audio_state: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Scalar driving state [N] -> (auds [N, 512], exps [N, 64]) wav2exp-style
    features, deterministic."""
    audio_state = np.asarray(audio_state, np.float32)
    freqs = np.linspace(0.5, 3.0, 256, dtype=np.float32)
    auds = np.concatenate(
        [np.sin(np.outer(audio_state, freqs)), np.cos(np.outer(audio_state, freqs))],
        axis=1,
    ).astype(np.float32)
    exps = np.sin(np.outer(audio_state, np.linspace(1.0, 2.0, 64))).astype(np.float32)
    return auds, exps


def _audio_state(n_frames: int) -> np.ndarray:
    t = np.arange(n_frames, dtype=np.float32)
    return np.sin(0.5 * t) * np.cos(0.13 * t)


def _background(H: int, W: int) -> np.ndarray:
    """The soft vertical gradient [H, W, 3] float32 in [0.585, 0.85]."""
    yy = np.linspace(0.85, 0.65, H, dtype=np.float32)[:, None]
    return np.broadcast_to(np.stack([yy, yy * 0.95, yy * 0.9], axis=-1), (H, W, 3)).copy()


def make_synthetic_scene(
    n_frames: int = 40,
    H: int = 64,
    W: int = 64,
    near: float = 0.3,
    far: float = 0.9,
    seed: int = 0,
    val_every: int = 10,
) -> FrameDataset:
    """The scene arrays of make_synthetic_dataset(n_frames, H, W, near=near,
    far=far, seed=seed, val_every=val_every), without the ground-truth frames
    (imgs_head and imgs_com are None)."""
    rng = np.random.RandomState(seed)
    focal = 1.1 * max(H, W)
    auds, exps = featurize_audio_state(_audio_state(n_frames))

    poses = np.zeros((n_frames, 4, 4), np.float32)
    for i in range(n_frames):
        ang = 0.25 * np.sin(0.3 * i) + 0.02 * rng.randn()
        el = 0.1 * np.cos(0.2 * i)
        eye = 0.6 * np.array([np.sin(ang), np.sin(el) * 0.3, np.cos(ang)])
        poses[i] = _lookat_pose(eye.astype(np.float32), np.zeros(3))

    rects = np.tile(np.array([[H // 4, W // 4, H // 2, W // 2]], np.int32), (n_frames, 1))
    idx = np.arange(n_frames, dtype=np.int32)
    i_val = idx[:: max(val_every, 1)][1:] if n_frames > val_every else idx[-2:]
    i_train = np.setdiff1d(idx, i_val)
    return FrameDataset(
        poses=poses, auds=auds, exps=exps, imgs_head=None, imgs_com=None,
        bc_img=(_background(H, W) * 255).astype(np.uint8), sample_rects=rects,
        hwfcxy=(H, W, float(focal), W * 0.5, H * 0.5), i_train=i_train, i_val=i_val,
        near=near, far=far,
    )


def analytic_field(pts: torch.Tensor, audio_state: torch.Tensor, include_torso: bool = True):
    """The analytic radiance field (reference :38): a head sphere (r 0.10 at
    the origin) whose mouth band pulses with the scalar ``audio_state``
    (a float32 tensor), and with ``include_torso`` a box below it.
    pts [N, 3] -> rgb [N, 3] in [0, 1], sigma [N] >= 0."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    d_head = torch.linalg.norm(pts, dim=-1) - 0.10
    sigma_head = 80.0 * torch.sigmoid(-d_head / 0.008)
    mouth = torch.exp(-(((y + 0.04) / 0.02) ** 2)) * (torch.abs(x) < 0.05)
    head_rgb = torch.stack([
        0.8 + 0.15 * torch.sin(12.0 * x),
        0.55 + 0.3 * audio_state * mouth,
        0.45 + 0.1 * torch.cos(9.0 * z),
    ], dim=-1)
    if not include_torso:
        return torch.clamp(head_rgb, 0.0, 1.0), sigma_head
    centre = pts.new_tensor([0.0, -0.22, 0.0])
    half = pts.new_tensor([0.13, 0.11, 0.06])
    q = torch.abs(pts - centre) - half
    d_torso = (torch.linalg.norm(torch.clamp_min(q, 0.0), dim=-1)
               + torch.clamp_max(q.max(dim=-1).values, 0.0))
    sigma_torso = 80.0 * torch.sigmoid(-d_torso / 0.008)
    torso_rgb = pts.new_tensor([0.2, 0.25, 0.6]).expand(pts.shape)
    sigma = torch.maximum(sigma_head, sigma_torso)
    w = sigma_head / torch.clamp_min(sigma_head + sigma_torso, 1e-6)
    rgb = w[..., None] * head_rgb + (1 - w[..., None]) * torso_rgb
    return torch.clamp(rgb, 0.0, 1.0), sigma


def render_gt_frame(c2w: torch.Tensor, H: int, W: int, focal: float, audio_state: torch.Tensor,
                    bc: torch.Tensor, n_samples: int, near: float, far: float,
                    include_torso: bool = True) -> torch.Tensor:
    """One ground-truth frame [H, W, 3] float32 (reference :82): the analytic
    field at ``n_samples`` uniform depths, the last sample replaced by the
    background bc [H, W, 3] at density 1e6."""
    rays_o, rays_d = get_rays(H, W, focal, c2w)
    rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    z_vals = stratified_z_vals(near, far, H * W, n_samples, device=c2w.device)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    rgb, sigma = analytic_field(pts.reshape(-1, 3), audio_state, include_torso)
    rgb = torch.cat([rgb.reshape(H * W, n_samples, 3)[:, :-1], bc.reshape(H * W, 1, 3)], dim=1)
    sigma = sigma.reshape(H * W, n_samples)
    sigma = torch.cat([sigma[:, :-1], torch.full_like(sigma[:, -1:], 1e6)], dim=1)
    out, _ = volume_render(z_vals, rays_d, sigma[None], rgb[None])
    return out.reshape(H, W, 3)


def gt_frame_uint8(frame: torch.Tensor) -> np.ndarray:
    """A rendered float frame -> uint8, clipped and truncated on the host in
    float32 as the reference does."""
    return (np.clip(frame.cpu().numpy(), 0, 1) * 255).astype(np.uint8)


@torch.no_grad()
def make_synthetic_dataset(
    n_frames: int = 40,
    H: int = 64,
    W: int = 64,
    n_samples_gt: int = 128,
    near: float = 0.3,
    far: float = 0.9,
    seed: int = 0,
    val_every: int = 10,
    device=None,
) -> FrameDataset:
    """The self-contained synthetic dataset (reference :121): the scene of
    make_synthetic_scene and its ground-truth frames, rendered on ``device``
    (default CUDA). ``imgs_com`` is the head+torso composite, ``imgs_head``
    the head alone, each over the background."""
    dev = resolve_device(device)
    scene = make_synthetic_scene(n_frames, H, W, near=near, far=far, seed=seed,
                                 val_every=val_every)
    focal = scene.hwfcxy[2]
    audio_state = _audio_state(n_frames)
    bc = torch.from_numpy(_background(H, W)).to(dev)
    imgs = np.zeros((n_frames, H, W, 3), np.uint8)
    imgs_head = np.zeros((n_frames, H, W, 3), np.uint8)
    for i in range(n_frames):
        c2w = torch.from_numpy(scene.poses[i]).to(dev)
        a = torch.tensor(audio_state[i], dtype=torch.float32, device=dev)
        for out, torso in ((imgs, True), (imgs_head, False)):
            out[i] = gt_frame_uint8(render_gt_frame(c2w, H, W, focal, a, bc, n_samples_gt, near,
                                                    far, torso))
    return dataclasses.replace(scene, imgs_com=imgs, imgs_head=imgs_head)
