"""Pure-array implementations of the preprocessing pipeline steps (port of
dfanerf_tpu/pipeline/steps.py: numpy and scipy on the host, the rotations of
step 9 through the port's core/geometry.py euler2rot).

Each function is the array-in/array-out core of one process_data_ba.py
step; pipeline/driver.py wires them to the on-disk dataset contract.

- extract_background (step 4, :219-267): per-pixel max distance to
  foreground over every 20th frame; pixels farther than 5 take the color
  of their argmax frame; holes fill from the nearest background pixel.
  The reference runs a per-frame sklearn KD-tree; an exact Euclidean
  distance transform (scipy.ndimage) computes the same distances orders
  of magnitude faster.
- compose_training_images (step 5, :270-286): bg-replaced composite,
  head-only image, and binary head mask from the parsing color map;
  compose_head_neck_image, parse_head_neck.py's variant that keeps the
  head and neck classes over the background.
- mine_rigid_keypoints / track_keypoints (step 6, :306-372): temporal
  flow-Laplacian stability map over head pixels, greedy 5x5-window
  minimum selection with spacing suppression, then keypoint tracks
  read out of dense flow.
- build_transforms (step 9, :392-444): c2w = inverse of the fitted w2c
  per frame, face_rect from the 68 landmarks, 10/11 train split,
  near/far = mean_z -0.2/+0.4.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

import torch

from dfanerf_torch.core.geometry import euler2rot

HEAD_COLOR = (255, 0, 0)
BG_COLOR = (255, 255, 255)


def _is_color(img: np.ndarray, color) -> np.ndarray:
    return (
        (img[..., 0] == color[0])
        & (img[..., 1] == color[1])
        & (img[..., 2] == color[2])
    )


def extract_background(
    parsing_imgs: np.ndarray,
    ori_imgs: np.ndarray,
    dist_thresh: float = 5.0,
) -> np.ndarray:
    """parsing/ori: [S, H, W, 3] uint8 (every-20th-frame selection done by
    the caller) -> bc_img [H, W, 3] uint8."""
    from scipy.ndimage import distance_transform_edt

    s, h, w, _ = parsing_imgs.shape
    dists = np.zeros((s, h, w), np.float32)
    for i in range(s):
        bg = _is_color(parsing_imgs[i], BG_COLOR)
        # distance from every pixel to the nearest foreground pixel
        dists[i] = distance_transform_edt(bg)
    max_dist = dists.max(0)
    max_id = dists.argmax(0)
    bc_img = np.zeros((h, w, 3), np.uint8)
    bc_pixs = max_dist > dist_thresh
    ys, xs = np.nonzero(bc_pixs)
    bc_img[ys, xs] = ori_imgs[max_id[ys, xs], ys, xs]
    # fill holes from the nearest confident-background pixel
    _, (iy, ix) = distance_transform_edt(~bc_pixs, return_indices=True)
    hole_ys, hole_xs = np.nonzero(~bc_pixs)
    bc_img[hole_ys, hole_xs] = bc_img[iy[hole_ys, hole_xs], ix[hole_ys, hole_xs]]
    return bc_img


def compose_training_images(
    ori_img: np.ndarray, parsing_img: np.ndarray, bc_img: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (com_img, head_img, face_mask) uint8, the step-5 contract."""
    head_part = _is_color(parsing_img, HEAD_COLOR)
    bc_part = _is_color(parsing_img, BG_COLOR)
    com = ori_img.copy()
    com[bc_part] = bc_img[bc_part]
    head = com.copy()
    head[~head_part] = bc_img[~head_part]
    mask = np.zeros_like(ori_img)
    mask[head_part] = 255
    return com, head, mask


def compose_head_neck_image(
    ori_img: np.ndarray, parsing_img: np.ndarray, bc_img: np.ndarray,
    neck_color=(0, 255, 0),
) -> np.ndarray:
    """parse_head_neck.py:68-80: the head and neck classes kept (the
    reference's BGR-read masks are head (255, 0, 0) | neck (0, 255, 0) in
    RGB), every other pixel and the background class from bc_img."""
    keep = _is_color(parsing_img, HEAD_COLOR) | _is_color(parsing_img, neck_color)
    bc_part = _is_color(parsing_img, BG_COLOR)
    img = ori_img.copy()
    img[bc_part] = bc_img[bc_part]
    img[~keep] = bc_img[~keep]
    return img


def flow_stability_map(
    rigid_flows: np.ndarray, rigid_mask: np.ndarray, h: int, w: int
) -> np.ndarray:
    """Temporal Laplacian stability of per-pixel flow tracks.

    Args:
        rigid_flows: [F, 2, K] flow at the K masked pixels over F frames.
        rigid_mask: [H, W] bool of the K pixels.
    Returns:
        [H, W, 1] uint8 map — 255 outside the mask, low = stable.
    """
    # [K, 2, F]
    tracks = rigid_flows.transpose(2, 1, 0).astype(np.float32)
    kern = np.array([-0.5, 1.0, -0.5], np.float32)
    # temporal second difference per (pixel, component)
    lap = np.apply_along_axis(
        lambda v: np.convolve(v, kern[::-1], mode="valid"), 2, tracks
    )
    lap = np.linalg.norm(lap, axis=1)  # [K, F-2]
    valid_frame = lap.mean(0) < lap.mean() * 3
    lap = lap[:, valid_frame]
    mean_per_pixel = lap.mean(1)
    lo, hi = mean_per_pixel.min(), mean_per_pixel.max()
    show = ((mean_per_pixel - lo) / max(hi - lo, 1e-10) * 255).astype(np.uint8)
    out = np.full((h, w, 1), 255, np.uint8)
    out[rigid_mask, 0] = show
    return out


def mine_rigid_keypoints(
    stability_img: np.ndarray, win_size: int = 5, d_size: int = 5,
    min_value: int = 40,
) -> np.ndarray:
    """Greedy per-window minimum selection with spacing suppression
    (process_data_ba.py:337-357) -> [K, 2] int (x, y)."""
    h, w = stability_img.shape[:2]
    sel = np.zeros((h, w), np.int32)
    xys = []
    for y in range(0, h - win_size, win_size):
        for x in range(0, w - win_size, win_size):
            patch = stability_img[y : y + win_size, x : x + win_size, 0]
            dy, dx = np.unravel_index(np.argmin(patch), patch.shape)
            if patch[dy, dx] >= min_value:
                continue
            iy, ix = y + dy, x + dx
            if sel[max(iy - d_size, 0) : iy + d_size + 1,
                   max(ix - d_size, 0) : ix + d_size + 1].sum() == 0:
                xys.append((ix, iy))
                sel[iy, ix] = 1
    return np.array(xys, np.int32).reshape(-1, 2)


def track_keypoints(flows: Sequence[np.ndarray], key_xys: np.ndarray) -> np.ndarray:
    """flows: per-frame [2, H, W] dense flow (ref frame -> frame i);
    key_xys [K, 2] (x, y) -> track_xys [N, K, 2]."""
    n, k = len(flows), key_xys.shape[0]
    out = np.zeros((n, k, 2), np.float32)
    xs, ys = key_xys[:, 0], key_xys[:, 1]
    for i, flow in enumerate(flows):
        out[i, :, 0] = xs + flow[0, ys, xs]
        out[i, :, 1] = ys + flow[1, ys, xs]
    return out


def face_rect_from_landmarks(lms: np.ndarray, h: int, w: int) -> np.ndarray:
    """[68, 2] landmarks -> (x, y, rect_w, rect_h) int32 — the json
    face_rect (process_data_ba.py:425-441; x is the COLUMN origin here;
    note the trainer reads rect[0] against row coordinates — a reference
    quirk that only matters when rect-biased sampling is on)."""
    min_x, max_x = lms[:, 0].min(), lms[:, 0].max()
    cx = int((min_x + max_x) / 2.0)
    cy = int(lms[27, 1])
    h_w = int((max_x - cx) * 1.5)
    h_h = int((lms[8, 1] - cy) * 1.15)
    rect_x = max(cx - h_w, 0)
    rect_y = max(cy - h_h, 0)
    rect_w = min(w - 1 - rect_x, 2 * h_w)
    rect_h = min(h - 1 - rect_y, 2 * h_h)
    return np.array((rect_x, rect_y, rect_w, rect_h), np.int32)


def build_transforms(
    euler: np.ndarray,
    trans: np.ndarray,
    focal: float,
    lms_per_frame: Sequence[np.ndarray],
    valid_img_ids: Sequence[int],
    h: int,
    w: int,
) -> Tuple[Dict, Dict, float, float]:
    """Step 9: fitted per-frame w2c (euler, trans) -> c2w transform dicts.

    Returns (transforms_train, transforms_val, near, far)."""

    n = euler.shape[0]
    split = int(n * 10 / 11)
    rot = euler2rot(torch.as_tensor(np.asarray(euler, np.float32))).numpy()
    rot_inv = rot.transpose(0, 2, 1)
    trans_inv = -np.einsum("nij,nj->ni", rot_inv, trans)
    mean_z = -float(trans[:, 2].mean())

    def frames_for(ids):
        frames = []
        for i in ids:
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = rot_inv[i]
            pose[:3, 3] = trans_inv[i]
            frames.append(
                {
                    "img_id": int(valid_img_ids[i]),
                    "aud_id": int(valid_img_ids[i]),
                    "transform_matrix": pose.tolist(),
                    "face_rect": face_rect_from_landmarks(
                        np.asarray(lms_per_frame[i]), h, w
                    ).tolist(),
                }
            )
        return frames

    def manifest(ids):
        return {
            "focal_len": float(focal),
            "cx": float(w / 2.0),
            "cy": float(h / 2.0),
            "frames": frames_for(ids),
        }

    return (
        manifest(range(split)),
        manifest(range(split, n)),
        mean_z - 0.2,
        mean_z + 0.4,
    )


def landmark_gaussian_smooth(
    lms_seq: np.ndarray, sigma: float = 1.5, area: str = "only_jaw"
) -> np.ndarray:
    """Temporal Gaussian smoothing of landmark tracks (step 2's
    --smooth_lms; landmark_smooth_2d at process_data_ba.py:49-67):
    area in {'all', 'wo_mouth' (landmarks 0:47), 'only_jaw' (0:16)}."""
    from scipy.ndimage import gaussian_filter1d

    out = lms_seq.astype(np.float32).copy()
    n_lms = {"all": out.shape[1], "wo_mouth": 47, "only_jaw": 16}[area]
    out[:, :n_lms] = gaussian_filter1d(out[:, :n_lms], sigma, axis=0)
    return out
