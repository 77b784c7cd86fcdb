"""Center/scale affine crop geometry from the face-alignment tree
(numpy and OpenCV on the host; a copy of dfanerf_tpu/pipeline/affine.py, which the
port does not import).

Exact reimplementation of the reference crop contract used by the landmark
demo (all citations into /root/reference/data_util/face-alignment/):

- ``bbox2cs`` — third_party/useful_codes/pose_utils/transform.py:167-182:
  bbox -> (center, scale) with floor/ceil quantization, pixel_std=200 and
  the 1.25 padding factor.
- ``pts2cs`` — transform.py:149-164: keypoints -> (center, scale), NO
  padding factor (the eye path multiplies by 1.35 at the call site,
  demo_face_eye_detectPerframe_save.py:287-288).
- ``get_affine_transform`` — transform.py:58-91: 3-point similarity
  transform between the scale*200 source box and the output rect; the
  third point construction (rotate the center->top vector by 90deg) is
  reproduced exactly.
- ``crop_affine`` — transform.py:114-122: warpAffine with INTER_LINEAR.
- ``affine_transform_pts`` — transform.py:93-96 vectorized over points.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np


def bbox2cs(bbox_ltrb: Sequence[float], pixel_std: float = 200.0,
            padding: float = 1.25) -> Tuple[np.ndarray, np.ndarray]:
    xmin, ymin, xmax, ymax = bbox_ltrb
    center = np.array(
        [(math.floor(xmin) + math.ceil(xmax)) / 2.0,
         (math.floor(ymin) + math.ceil(ymax)) / 2.0], np.float32
    )
    scale = max(
        math.ceil(xmax) - math.floor(xmin), math.ceil(ymax) - math.floor(ymin)
    ) / pixel_std
    scale = np.array([scale * padding, scale * padding], np.float32)
    return center, scale


def pts2cs(pts: np.ndarray, pixel_std: float = 200.0) -> Tuple[np.ndarray, np.ndarray]:
    xmin, xmax = float(pts[:, 0].min()), float(pts[:, 0].max())
    ymin, ymax = float(pts[:, 1].min()), float(pts[:, 1].max())
    center = np.array(
        [(math.floor(xmin) + math.ceil(xmax)) / 2.0,
         (math.floor(ymin) + math.ceil(ymax)) / 2.0], np.float32
    )
    scale = max(
        math.ceil(xmax) - math.floor(xmin), math.ceil(ymax) - math.floor(ymin)
    ) / pixel_std
    return center, np.array([scale, scale], np.float32)


def _get_3rd_point(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    direct = a - b
    return b + np.array([-direct[1], direct[0]], np.float32)


def get_affine_transform(
    center: np.ndarray,
    scale,
    rot: float,
    output_size: Sequence[int],
    shift=(0.0, 0.0),
    inv: bool = False,
) -> np.ndarray:
    """2x3 similarity transform mapping the scale*200 box at ``center`` onto
    ``output_size`` (W, H) — or its inverse."""
    import cv2

    scale = np.asarray(scale, np.float32)
    if scale.ndim == 0:
        scale = np.array([scale, scale], np.float32)
    shift = np.asarray(shift, np.float32)

    scale_tmp = scale * 200.0
    src_w = scale_tmp[0]
    dst_w, dst_h = output_size

    rot_rad = np.pi * rot / 180.0
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    src_point = np.array([0.0, src_w * -0.5], np.float32)
    src_dir = np.array(
        [src_point[0] * cs - src_point[1] * sn,
         src_point[0] * sn + src_point[1] * cs], np.float32
    )
    dst_dir = np.array([0.0, dst_w * -0.5], np.float32)

    src = np.zeros((3, 2), np.float32)
    dst = np.zeros((3, 2), np.float32)
    src[0] = center + scale_tmp * shift
    src[1] = center + src_dir + scale_tmp * shift
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = np.array([dst_w * 0.5, dst_h * 0.5], np.float32) + dst_dir
    src[2] = _get_3rd_point(src[0], src[1])
    dst[2] = _get_3rd_point(dst[0], dst[1])

    if inv:
        return cv2.getAffineTransform(np.float32(dst), np.float32(src))
    return cv2.getAffineTransform(np.float32(src), np.float32(dst))


def crop_affine(img: np.ndarray, center, scale, output_size, rot: float = 0.0):
    """Warp the center/scale box to ``output_size`` (W, H)."""
    import cv2

    trans = get_affine_transform(center, scale, rot, output_size)
    return cv2.warpAffine(
        img, trans, (int(output_size[0]), int(output_size[1])),
        flags=cv2.INTER_LINEAR,
    )


def affine_transform_pts(pts: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Apply a 2x3 transform to [N, 2] points."""
    ones = np.ones((pts.shape[0], 1), pts.dtype)
    return np.concatenate([pts, ones], axis=1) @ t.T
