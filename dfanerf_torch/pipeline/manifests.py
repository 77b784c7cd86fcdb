"""Novel-audio driving manifests (port of dfanerf_tpu/pipeline/manifests.py):
numpy and JSON-ready dicts on the host.

Re-designs of the reference's data_util/generate_test_jsons.py:51-84 (the
training pose deltas re-integrated at a scale, and a static-pose variant)
and generate_multi_hps_json.py (random fixed-length windows of the training
trajectory, concatenated). The windows are drawn from
``np.random.RandomState(seed)``, so they are the reference package's. The
port's ``cli render --test-file`` reads either manifest.
"""

from __future__ import annotations

import copy
from typing import Dict, Tuple

import numpy as np


def driving_manifest(transforms: Dict, n_frames: int, param_scale: float = 1.0,
                     static_pose_idx: int = 0) -> Tuple[Dict, Dict]:
    """(driving, static) manifests for a new audio of ``n_frames``: the
    driving one re-integrates the training pose deltas scaled by
    ``param_scale`` (damping or amplifying the head motion), the static one
    repeats the pose of frame ``static_pose_idx``. img_id == aud_id == the
    frame's index into the new features."""
    frames = transforms["frames"]
    data_len = min(n_frames, len(frames))
    arr = np.array([frames[i]["transform_matrix"] for i in range(data_len)], np.float32)
    diff = (arr[1:] - arr[:-1]) * param_scale
    out = arr.copy()
    for i in range(data_len - 1):
        out[i + 1] = out[i] + diff[i]

    drive = {k: v for k, v in transforms.items() if k != "frames"}
    static = copy.deepcopy(drive)
    drive["frames"], static["frames"] = [], []
    for i in range(data_len):
        f = copy.deepcopy(frames[i])
        f["transform_matrix"] = out[i].tolist()
        f["img_id"] = f["aud_id"] = i
        drive["frames"].append(f)
        fs = copy.deepcopy(frames[static_pose_idx])
        fs["img_id"] = fs["aud_id"] = i
        static["frames"].append(fs)
    return drive, static


def multi_window_manifest(transforms: Dict, n_frames: int, window: int = 100,
                          seed: int = 0) -> Dict:
    """``n_frames`` driving poses stitched from random ``window``-frame
    stretches of the training trajectory (generate_multi_hps_json.py:54-73),
    which keeps the motion natural over a long novel audio."""
    rng = np.random.RandomState(seed)
    frames = transforms["frames"]
    out = {k: v for k, v in transforms.items() if k != "frames"}
    out["frames"] = []
    i = 0
    while i < n_frames:
        start = rng.randint(0, max(len(frames) - window, 1))
        for j in range(start, min(start + window, len(frames))):
            if i >= n_frames:
                break
            f = copy.deepcopy(frames[j])
            f["img_id"] = f["aud_id"] = i
            out["frames"].append(f)
            i += 1
    return out
