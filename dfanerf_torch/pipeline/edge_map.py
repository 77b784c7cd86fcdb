"""Edge-map and train/val export for the external neural-render post-process
(port of dfanerf_tpu/pipeline/edge_map.py): numpy, OpenCV and file IO on the
host.

Port of data_util/generate_edge_map.py:37-98: copies rendered inputs and
ground-truth frames into trainsets/valsets directories and writes a binary
segmentation map of the BODY_LABEL pixels of the parsing image after a PIL
grayscale conversion.

Label quirk kept: the numeric labels (BG 255, HEAD 29, NECK 150, BODY 76)
are the ITU-R 601 luma values of the parsing COLOURS as PIL reads the png,
e.g. 76 = the luma of pure red, which is the parsing's head colour as
written, so ``BODY_LABEL`` selects head-coloured pixels when the channel
order matches the reference's write path. The numbers are reproduced, not
the names.

Loop quirk kept (opt-out): the reference's train_val loop ``continue``s for
every i < val_idx before its train/val branch, so its train-set export is
dead code and only the val rows are written (generate_edge_map.py:62-64).
``skip_below_val_idx=False`` makes the train branch reachable.
"""

from __future__ import annotations

import os
import shutil
from glob import glob

import numpy as np

BG_LABEL = 255
HEAD_LABEL = 29
NECK_LABEL = 150
BODY_LABEL = 76


def _grayscale(img_rgb: np.ndarray) -> np.ndarray:
    """PIL Image.convert('L'): ITU-R 601 luma, truncated to uint8."""
    l = (
        img_rgb[..., 0].astype(np.float64) * 299 / 1000
        + img_rgb[..., 1].astype(np.float64) * 587 / 1000
        + img_rgb[..., 2].astype(np.float64) * 114 / 1000
    )
    return l.astype(np.uint8)


def body_seg_map(parse_rgb: np.ndarray, input_size: int = 512) -> np.ndarray:
    """Binary map (255 where the grayscale parsing equals BODY_LABEL)."""
    gray = _grayscale(parse_rgb)
    out = np.zeros((input_size, input_size, 1), np.uint8)
    ys, xs = np.nonzero(gray == BODY_LABEL)
    out[ys, xs, 0] = 255
    return out


def export_edge_maps(
    input_img_path: str,
    gt_img_path: str,
    parse_path: str,
    save_path: str,
    input_val_img_path: str = "",
    mode: str = "test",
    val_idx: int = 7111,
    input_size: int = 512,
    skip_below_val_idx: bool = True,
) -> int:
    """Run the export; returns the number of rows written."""
    import cv2

    if mode != "train_val":
        os.makedirs(save_path, exist_ok=True)
        n = 0
        for i, _ in enumerate(sorted(os.listdir(input_img_path))):
            src = os.path.join(input_img_path, f"{i:06d}.jpg")
            shutil.copy(src, save_path)
            n += 1
        return n

    dirs = {}
    for split in ("train", "val"):
        dirs[f"input_{split}"] = os.path.join(save_path, f"{split}sets", "input")
        dirs[f"gt_{split}"] = os.path.join(save_path, f"{split}sets", "gt")
        dirs[f"parse_{split}"] = os.path.join(save_path, f"seg_map_{split}")
        for k in (f"input_{split}", f"gt_{split}", f"parse_{split}"):
            os.makedirs(dirs[k], exist_ok=True)

    gt_paths = sorted(glob(os.path.join(gt_img_path, "*.jpg")))
    cnt = 0
    written = 0
    for i, _ in enumerate(gt_paths):
        if skip_below_val_idx and i < val_idx:
            continue  # reference quirk: train rows are never exported
        parse_src = os.path.join(parse_path, f"{i:06d}.png")
        gt_src = os.path.join(gt_img_path, f"{i:06d}.jpg")
        parse_rgb = cv2.imread(parse_src)[..., ::-1]
        seg = body_seg_map(parse_rgb, input_size)
        if i < val_idx:
            input_src = os.path.join(input_img_path, f"{i:06d}.jpg")
            input_dst = dirs["input_train"]
            gt_dst = dirs["gt_train"]
            parse_dst = os.path.join(dirs["parse_train"], f"{i:06d}.png")
        else:
            input_src = os.path.join(input_val_img_path, f"{cnt:06d}.jpg")
            input_dst = dirs["input_val"]
            gt_dst = os.path.join(dirs["gt_val"], f"{cnt:06d}.jpg")
            parse_dst = os.path.join(dirs["parse_val"], f"{cnt:06d}.png")
            cnt += 1
        shutil.copy(input_src, input_dst)
        shutil.copy(gt_src, gt_dst)
        cv2.imwrite(parse_dst, seg)
        written += 1
    return written
