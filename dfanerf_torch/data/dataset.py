"""The array-resident training data of one identity (port of
dfanerf_tpu/data/dataset.py FrameDataset and speaking_i_train).

Host numpy arrays, as the reference package keeps them; train/step.py
dataset_to_device moves what a step reads to the device. Reading an
identity directory (``load_audface_dataset``: JPEG frames through imageio)
is not ported yet (ROADMAP.md queue 1, item 2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class FrameDataset:
    """All per-identity training data: uint8 image stacks and float32
    conditioning, the reference loader's dict with the images decoded."""

    poses: np.ndarray            # [N, 4, 4] float32 camera-to-world
    auds: np.ndarray             # [N, 512] wav2exp features or [N, 16, 29] DeepSpeech windows
    exps: Optional[np.ndarray]   # [N, 64] expression codes
    imgs_head: Optional[np.ndarray]  # [N, H, W, 3] uint8 head+neck targets
    imgs_com: Optional[np.ndarray]   # [N, H, W, 3] uint8 composite targets
    bc_img: np.ndarray           # [H, W, 3] uint8 background
    sample_rects: Optional[np.ndarray]  # [N, 4] int32 face rects (row, col, h, w)
    hwfcxy: Tuple[int, int, float, float, float]
    i_train: np.ndarray          # int32 frame indices
    i_val: np.ndarray
    speak_frames: Optional[np.ndarray] = None
    near: float = 0.3
    far: float = 0.9

    @property
    def n_frames(self) -> int:
        return self.poses.shape[0]


def speaking_i_train(ds: FrameDataset) -> np.ndarray:
    """The training frames inside speaking intervals (the reference's
    ``np.intersect1d(i_train, np.where(speak_frames > 0))``); every training
    frame when the dataset has no speaking data."""
    if ds.speak_frames is None:
        return np.asarray(ds.i_train)
    return np.intersect1d(np.asarray(ds.i_train),
                          np.nonzero(np.asarray(ds.speak_frames) > 0)[0]).astype(np.int32)
