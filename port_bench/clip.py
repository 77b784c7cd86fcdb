"""The seeded inputs of a cell, frozen here from dfanerf_torch/data/synthetic.py:
a driving clip (poses drifting on an orbit around the head, the per-frame
audio and expression features of a scalar driving state, the background)
and, for training, its ground-truth frames of an analytic head and torso.

The clip is periodic: the orbit and the driving state repeat every clip
length, so the loop a run plays is smooth across its wrap. Every seed gets
the same clip; the seed picks the frame the loop starts at (``Clip.start``),
a multiple of ``step`` frames (the renderers' refresh cadence), so every
seed plays the same frames under the same refreshes in another order and a
window that loops over the clip does the same work.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Clip:
    poses: np.ndarray    # [N, 4, 4] float32 camera-to-world
    auds: np.ndarray     # [N, 512] float32 wav2exp-style features
    exps: np.ndarray     # [N, 64] float32 expression codes
    state: np.ndarray    # [N] float32 scalar driving state
    bc_img: np.ndarray   # [H, W, 3] uint8 background
    H: int
    W: int
    focal: float
    near: float
    far: float
    start: int = 0       # the frame a run's loop starts at

    @property
    def n_frames(self) -> int:
        return self.poses.shape[0]

    @property
    def hwfcxy(self):
        return (self.H, self.W, self.focal, self.W * 0.5, self.H * 0.5)


def _lookat(eye: np.ndarray) -> np.ndarray:
    z = eye / np.linalg.norm(eye)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
    return c2w


def features(state: np.ndarray):
    """Scalar driving state [N] -> (auds [N, 512], exps [N, 64])."""
    freqs = np.linspace(0.5, 3.0, 256, dtype=np.float32)
    auds = np.concatenate([np.sin(np.outer(state, freqs)), np.cos(np.outer(state, freqs))],
                          axis=1).astype(np.float32)
    exps = np.sin(np.outer(state, np.linspace(1.0, 2.0, 64))).astype(np.float32)
    return auds, exps


def background(H: int, W: int) -> np.ndarray:
    yy = np.linspace(0.85, 0.65, H, dtype=np.float32)[:, None]
    img = np.broadcast_to(np.stack([yy, yy * 0.95, yy * 0.9], axis=-1), (H, W, 3))
    return (img * 255).astype(np.uint8)


def make_clip(seed: int, n_frames: int, H: int, W: int, near: float = 0.3,
              far: float = 0.9, step: int = 4) -> Clip:
    """The periodic clip, its loop started on a multiple of ``step`` frames
    drawn from the seed."""
    t = 2.0 * np.pi * np.arange(n_frames, dtype=np.float64) / n_frames
    ang = 0.25 * np.sin(t)
    el = 0.1 * np.cos(2.0 * t)
    eyes = 0.6 * np.stack([np.sin(ang), 0.3 * np.sin(el), np.cos(ang)], axis=-1)
    poses = np.stack([_lookat(e.astype(np.float32)) for e in eyes])
    state = (np.sin(3.0 * t) * np.cos(5.0 * t)).astype(np.float32)
    auds, exps = features(state)
    start = step * int(np.random.default_rng([seed, 1]).integers(n_frames // step))
    return Clip(poses=poses, auds=auds, exps=exps, state=state, bc_img=background(H, W),
                H=H, W=W, focal=1.1 * max(H, W), near=near, far=far, start=start)


def analytic_field(pts: torch.Tensor, state: torch.Tensor, torso: bool = True):
    """The ground truth's radiance field: a head sphere (r 0.10) whose mouth
    band pulses with the driving state, and with ``torso`` a box below it.
    pts [N, 3] -> rgb [N, 3] in [0, 1], sigma [N]."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    sigma_head = 80.0 * torch.sigmoid(-(torch.linalg.norm(pts, dim=-1) - 0.10) / 0.008)
    mouth = torch.exp(-(((y + 0.04) / 0.02) ** 2)) * (torch.abs(x) < 0.05)
    head_rgb = torch.stack([0.8 + 0.15 * torch.sin(12.0 * x), 0.55 + 0.3 * state * mouth,
                            0.45 + 0.1 * torch.cos(9.0 * z)], dim=-1)
    if not torso:
        return torch.clamp(head_rgb, 0.0, 1.0), sigma_head
    q = torch.abs(pts - pts.new_tensor([0.0, -0.22, 0.0])) - pts.new_tensor([0.13, 0.11, 0.06])
    d_torso = (torch.linalg.norm(torch.clamp_min(q, 0.0), dim=-1)
               + torch.clamp_max(q.max(dim=-1).values, 0.0))
    sigma_torso = 80.0 * torch.sigmoid(-d_torso / 0.008)
    torso_rgb = pts.new_tensor([0.2, 0.25, 0.6]).expand(pts.shape)
    w = (sigma_head / torch.clamp_min(sigma_head + sigma_torso, 1e-6))[..., None]
    rgb = torch.clamp(w * head_rgb + (1 - w) * torso_rgb, 0.0, 1.0)
    return rgb, torch.maximum(sigma_head, sigma_torso)


@torch.no_grad()
def truth_frames(clip: Clip, n_samples: int, device):
    """The identity's ground truth: each clip frame volume-rendered from the
    analytic field at n_samples uniform depths, the last sample the
    background at density 1e6; with and without the torso. (imgs_head,
    imgs_com) uint8 [N, H, W, 3] on the device."""
    H, W = clip.H, clip.W
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    dirs = torch.stack([(i - W * 0.5) / clip.focal, -(j - H * 0.5) / clip.focal,
                        -torch.ones_like(i)], -1).reshape(-1, 3)
    z = torch.linspace(clip.near, clip.far, n_samples, device=device)
    bc = torch.from_numpy(clip.bc_img).to(device).reshape(-1, 3).float() / 255.0
    dists = torch.cat([z[1:] - z[:-1], z.new_tensor([1e10])])
    outs = {True: [], False: []}
    for k in range(clip.n_frames):
        c2w = torch.from_numpy(clip.poses[k]).to(device)
        rd = dirs @ c2w[:3, :3].t()
        state = torch.tensor(float(clip.state[k]), device=device)
        for torso in (True, False):
            frame = []
            for a in range(0, H * W, 16384):
                d = rd[a:a + 16384]
                pts = c2w[:3, 3] + d[:, None, :] * z[:, None]
                rgb, sigma = analytic_field(pts.reshape(-1, 3), state, torso)
                rgb = torch.cat([rgb.reshape(-1, n_samples, 3)[:, :-1], bc[a:a + 16384, None]], 1)
                sigma = torch.cat([sigma.reshape(-1, n_samples)[:, :-1],
                                   torch.full_like(sigma.reshape(-1, n_samples)[:, -1:], 1e6)], 1)
                alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists * torch.linalg.norm(d, dim=-1,
                                                                                      keepdim=True))
                trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                                 1.0 - alpha + 1e-10], 1), 1)[:, :-1]
                frame.append(((alpha * trans)[..., None] * rgb).sum(1))
            img = torch.cat(frame).reshape(H, W, 3)
            outs[torso].append((img.clamp(0, 1) * 255).to(torch.uint8))
    return torch.stack(outs[False]), torch.stack(outs[True])
