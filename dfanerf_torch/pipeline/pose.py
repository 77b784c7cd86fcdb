"""Head-pose estimation from 68 landmarks + temporal Kalman stabilization
(numpy and OpenCV on the host; a copy of dfanerf_tpu/pipeline/pose.py, which the
port does not import).

Re-design of third_party/head-pose-estimation:

- ``PoseEstimator``: cv2.solvePnP on the 68-point 3D reference face
  (pose_estimator.py:91-112 — first solve cold, then with the previous
  extrinsics as the initial guess). PnP is a tiny host-side solve per
  frame, exactly where the reference runs it; the camera matrix uses the
  image-size heuristic focal = width.
- ``KalmanStabilizer``: the constant-velocity scalar/point Kalman filter
  (stabilizer.py:9-100) implemented directly (predict/correct in numpy —
  no cv2.KalmanFilter dependency), with the same default covariances and
  ``set_q_r`` override hook.
- The 3D reference model ships with the reference as assets/model.txt; a
  procedural fallback (synthetic face-like point set) keeps the module
  testable without the asset.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class KalmanStabilizer:
    """Constant-velocity Kalman filter over a scalar or 2D point."""

    def __init__(self, state_num=4, measure_num=2, cov_process=1e-4,
                 cov_measure=0.1):
        assert state_num in (2, 4)
        self.n, self.m = state_num, measure_num
        if measure_num == 1:
            self.F = np.array([[1, 1], [0, 1]], np.float32)
            self.H = np.array([[1, 1]], np.float32)  # reference quirk: H=[1,1]
        else:
            self.F = np.array(
                [[1, 0, 1, 0], [0, 1, 0, 1], [0, 0, 1, 0], [0, 0, 0, 1]],
                np.float32,
            )
            self.H = np.array([[1, 0, 0, 0], [0, 1, 0, 0]], np.float32)
        self.set_q_r(cov_process, cov_measure)
        self.x = np.zeros((self.n, 1), np.float32)
        self.P = np.eye(self.n, dtype=np.float32)
        self.state = self.x

    def set_q_r(self, cov_process=0.1, cov_measure=0.001):
        self.Q = np.eye(self.n, dtype=np.float32) * cov_process
        self.R = np.eye(self.m, dtype=np.float32) * cov_measure

    def update(self, measurement):
        # predict
        self.x = self.F @ self.x
        self.P = self.F @ self.P @ self.F.T + self.Q
        # correct
        z = np.asarray(measurement, np.float32).reshape(self.m, 1)
        S = self.H @ self.P @ self.H.T + self.R
        K = self.P @ self.H.T @ np.linalg.inv(S)
        self.x = self.x + K @ (z - self.H @ self.x)
        self.P = (np.eye(self.n, dtype=np.float32) - K @ self.H) @ self.P
        self.state = self.x


def synthetic_model_points() -> np.ndarray:
    """Procedural 68-point 3D face stand-in (the real assets/model.txt is an
    external asset like the reference's)."""
    rng = np.random.RandomState(42)
    t = np.linspace(-1, 1, 17)
    jaw = np.stack([75 * t, -60 + 25 * t ** 2, -20 * (1 - t ** 2)], 1)
    brow = np.stack([np.linspace(-55, 55, 10), np.full(10, 40.0), np.full(10, 5.0)], 1)
    nose = np.stack([np.zeros(9), np.linspace(30, -10, 9), np.linspace(10, 25, 9)], 1)
    eyes = np.stack(
        [np.concatenate([np.linspace(-45, -20, 6), np.linspace(20, 45, 6)]),
         np.full(12, 25.0), np.full(12, 5.0)], 1)
    # iBUG-68 layout: jaw 17 + brows 10 + nose 9 + eyes 12 + mouth 20 = 68
    mouth = np.stack(
        [35 * np.cos(np.linspace(0, 2 * np.pi, 20, endpoint=False)),
         -35 + 12 * np.sin(np.linspace(0, 2 * np.pi, 20, endpoint=False)),
         np.full(20, 10.0)], 1)
    pts = np.concatenate([jaw, brow, nose, eyes, mouth]).astype(np.float32)
    pts += rng.randn(*pts.shape).astype(np.float32) * 0.5
    assert pts.shape == (68, 3)
    return pts


def load_model_points(path: Optional[str] = None) -> np.ndarray:
    """assets/model.txt layout: 204 floats, reshape (3, 68).T, z negated
    (pose_estimator.py _get_full_model_points)."""
    if path is None:
        return synthetic_model_points()
    raw = np.loadtxt(path, dtype=np.float32)
    pts = raw.reshape(3, -1).T
    pts[:, 2] *= -1
    return pts


class PoseEstimator:
    """EPnP head pose from 68 2D landmarks, warm-started per sequence."""

    def __init__(self, img_size: Tuple[int, int] = (512, 512),
                 model_path: Optional[str] = None):
        self.size = img_size
        self.model_points_68 = load_model_points(model_path)
        focal = img_size[1]
        center = (img_size[1] / 2, img_size[0] / 2)
        self.camera_matrix = np.array(
            [[focal, 0, center[0]], [0, focal, center[1]], [0, 0, 1]],
            dtype=np.float64,
        )
        self.dist_coeffs = np.zeros((4, 1))
        self.r_vec = None
        self.t_vec = None

    def solve_pose_by_68_points(self, image_points: np.ndarray):
        import cv2

        image_points = np.ascontiguousarray(image_points, np.float64)
        if self.r_vec is None:
            _, r, t = cv2.solvePnP(
                self.model_points_68, image_points, self.camera_matrix,
                self.dist_coeffs,
            )
            self.r_vec, self.t_vec = r, t
        _, r, t = cv2.solvePnP(
            self.model_points_68, image_points, self.camera_matrix,
            self.dist_coeffs, rvec=self.r_vec, tvec=self.t_vec,
            useExtrinsicGuess=True,
        )
        self.r_vec, self.t_vec = r, t
        return r, t

    def pose_to_matrix(self, r_vec, t_vec) -> np.ndarray:
        import cv2

        rot, _ = cv2.Rodrigues(r_vec)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = rot
        m[:3, 3] = t_vec.reshape(3)
        return m
