"""The asset-free synthetic talking-head scene (port of the numpy part of
dfanerf_tpu/data/synthetic.py make_synthetic_dataset).

From the same seed this builds the same arrays as the reference package:
orbiting head poses, the audio/expression features of a scalar driving
state, the background image, intrinsics and face rects. The ground-truth
frames need the volume renderer of the training slice and are not built
here (ROADMAP.md queue 1, item 2).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


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


@dataclasses.dataclass
class SyntheticScene:
    poses: np.ndarray        # [N, 4, 4] f32 head camera-to-world
    auds: np.ndarray         # [N, 512] f32
    exps: np.ndarray         # [N, 64] f32
    bc_img: np.ndarray       # [H, W, 3] uint8 background
    sample_rects: np.ndarray  # [N, 4] int32
    hwfcxy: Tuple[int, int, float, float, float]
    i_train: np.ndarray
    i_val: np.ndarray
    near: float
    far: float

    @property
    def n_frames(self) -> int:
        return self.poses.shape[0]


def make_synthetic_scene(
    n_frames: int = 40,
    H: int = 64,
    W: int = 64,
    near: float = 0.3,
    far: float = 0.9,
    seed: int = 0,
    val_every: int = 10,
) -> SyntheticScene:
    """The scene arrays of make_synthetic_dataset(n_frames, H, W, near=near,
    far=far, seed=seed, val_every=val_every), without the ground-truth frames."""
    rng = np.random.RandomState(seed)
    focal = 1.1 * max(H, W)
    t = np.arange(n_frames, dtype=np.float32)
    audio_state = np.sin(0.5 * t) * np.cos(0.13 * t)
    auds, exps = featurize_audio_state(audio_state)

    poses = np.zeros((n_frames, 4, 4), np.float32)
    for i in range(n_frames):
        ang = 0.25 * np.sin(0.3 * i) + 0.02 * rng.randn()
        el = 0.1 * np.cos(0.2 * i)
        eye = 0.6 * np.array([np.sin(ang), np.sin(el) * 0.3, np.cos(ang)])
        poses[i] = _lookat_pose(eye.astype(np.float32), np.zeros(3))

    yy = np.linspace(0.85, 0.65, H, dtype=np.float32)[:, None]
    bc = np.broadcast_to(np.stack([yy, yy * 0.95, yy * 0.9], axis=-1), (H, W, 3)).copy()

    rects = np.tile(np.array([[H // 4, W // 4, H // 2, W // 2]], np.int32), (n_frames, 1))
    idx = np.arange(n_frames, dtype=np.int32)
    i_val = idx[:: max(val_every, 1)][1:] if n_frames > val_every else idx[-2:]
    i_train = np.setdiff1d(idx, i_val)
    return SyntheticScene(
        poses=poses, auds=auds, exps=exps, bc_img=(bc * 255).astype(np.uint8),
        sample_rects=rects, hwfcxy=(H, W, float(focal), W * 0.5, H * 0.5),
        i_train=i_train, i_val=i_val, near=near, far=far,
    )
