"""Temporal filters and landmark-stabilization utilities from the
face-alignment third_party tree
(numpy and OpenCV on the host; a copy of dfanerf_tpu/pipeline/filters.py, which the
port does not import).

- ``OneEuroFilter`` (third_party/useful_codes/filters/common_filters.py):
  adaptive low-pass for landmark jitter.
- ``lk_stabilize``: the demo script's Lucas-Kanade temporal stabilization
  rule (demo_face_eye_detectPerframe_save.py:823-850): track last-frame
  landmarks into the current frame with pyramidal LK and accept the
  tracked point when it lies within ``accept_dist`` px of the fresh
  detection.
- ``map_98_to_68``: WFLW 98-landmark -> 68-landmark index map
  (third_party/useful_codes/pose_utils/draw_keypoints.py).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


class LowPassFilter:
    def __init__(self):
        self.y: Optional[np.ndarray] = None
        self.s: Optional[np.ndarray] = None

    def __call__(self, value, alpha):
        value = np.asarray(value, np.float64)
        if self.y is None:
            s = value
        else:
            s = alpha * value + (1.0 - alpha) * self.s
        self.y, self.s = value, s
        return s


class OneEuroFilter:
    """min_cutoff/beta parameterization (standard 1-euro)."""

    def __init__(self, freq: float = 30.0, min_cutoff: float = 1.0,
                 beta: float = 0.0, d_cutoff: float = 1.0):
        self.freq = freq
        self.min_cutoff = min_cutoff
        self.beta = beta
        self.d_cutoff = d_cutoff
        self.x_filt = LowPassFilter()
        self.dx_filt = LowPassFilter()

    def _alpha(self, cutoff):
        te = 1.0 / self.freq
        tau = 1.0 / (2 * math.pi * cutoff)
        return 1.0 / (1.0 + tau / te)

    def __call__(self, x):
        x = np.asarray(x, np.float64)
        prev = self.x_filt.y
        dx = np.zeros_like(x) if prev is None else (x - prev) * self.freq
        edx = self.dx_filt(dx, self._alpha(self.d_cutoff))
        cutoff = self.min_cutoff + self.beta * np.abs(edx)
        return self.x_filt(x, self._alpha(cutoff))


def lk_stabilize(
    prev_gray: np.ndarray,
    curr_gray: np.ndarray,
    prev_lms: np.ndarray,
    detected_lms: np.ndarray,
    accept_dist: float = 4.0,
) -> np.ndarray:
    """Blend freshly-detected landmarks with LK-tracked previous landmarks:
    where the tracked point is within ``accept_dist`` px of the detection,
    prefer the tracked (temporally stable) point. Matches the demo's rule
    exactly (cv2 default LK params; ``good_new[norm < 4] = lmk_aft_flow``,
    demo_face_eye_detectPerframe_save.py:833-846 — the status flags are
    ignored there; a failed track lands far from the detection and the
    distance rule rejects it)."""
    import cv2

    prev_pts = prev_lms.astype(np.float32).reshape(-1, 1, 2)
    tracked, _status, _ = cv2.calcOpticalFlowPyrLK(
        prev_gray, curr_gray, prev_pts, None,
    )
    tracked = np.nan_to_num(tracked.reshape(-1, 2), nan=np.inf)
    dist = np.linalg.norm(tracked - detected_lms, axis=1)
    use_tracked = dist < accept_dist
    out = detected_lms.astype(np.float32).copy()
    out[use_tracked] = tracked[use_tracked]
    return out


# WFLW(98) -> 68 mapping: jaw every other point, brows/eyes resampled
_98_TO_68 = (
    list(range(0, 33, 2))            # jaw 17
    + [33, 34, 35, 36, 37]           # right brow
    + [42, 43, 44, 45, 46]           # left brow
    + list(range(51, 60))            # nose 9
    + [60, 61, 63, 64, 65, 67]       # right eye 6
    + [68, 69, 71, 72, 73, 75]       # left eye 6
    + list(range(76, 96))            # mouth 20
)


def map_98_to_68(lms98: np.ndarray) -> np.ndarray:
    """[.., 98, 2] WFLW landmarks -> [.., 68, 2] iBUG-68 landmarks."""
    return lms98[..., _98_TO_68, :]
