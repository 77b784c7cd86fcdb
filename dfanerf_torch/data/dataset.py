"""The array-resident training data of one identity (port of
dfanerf_tpu/data/dataset.py).

Host numpy arrays, as the reference package keeps them; train/step.py
dataset_to_device moves what a step reads to the device.

``load_audface_dataset`` reads an identity directory, the preprocessing
pipeline's contract (reference process_data_ba.py:392-444, load_audface.py:
11-176):

    <id>/transforms_{train,val}[_ba].json  {focal_len, cx, cy, frames: [{img_id,
                                             aud_id, transform_matrix, face_rect}]}
    <id>/head_imgs/{img_id:06d}.jpg        head and neck over the background
    <id>/com_imgs/{img_id:06d}.jpg         the composite target
    <id>/bc.jpg                            the static background
    <id>/<aud_file>   [N, 512] wav2exp features (.pt) or [N, 16, 29] (.npy)
    <id>/<exp_file>   {'exp_o': [N, 64], ...} (.pt)
    <id>/speak_time.npy                    speaking intervals in seconds

Every frame is decoded once into uint8 arrays. JPEGs decode with OpenCV
(BGR turned to RGB), where the reference uses imageio.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

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


def _load_pt_or_npy(path: str, key: Optional[str] = None) -> np.ndarray:
    """A feature file as float32: .npy, .npz (``key`` or its first array),
    or a torch .pt (``key`` of a dict); a .pt path that is missing falls
    back to its '.pt.npz' sibling, which the pipeline writes without torch."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if path.endswith(".npz"):
        data = np.load(path)
        return data[key if key else list(data.keys())[0]].astype(np.float32)
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        return _load_pt_or_npy(path + ".npz", key)
    import torch

    obj = torch.load(path, map_location="cpu")
    if key is not None and isinstance(obj, dict):
        obj = obj[key]
    return obj.detach().cpu().numpy().astype(np.float32)


def _imread(path: str) -> np.ndarray:
    """An image file as [H, W, 3] uint8 RGB."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("reading an identity's JPEG frames needs OpenCV (the cv2 module of "
                          "opencv-python)") from e
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"cannot read image {path}")
    return np.ascontiguousarray(img[..., ::-1])


def load_audface_dataset(
    basedir: str,
    aud_file: str,
    exp_file: Optional[str] = None,
    use_ba: bool = True,
    testskip: int = 1,
    all_speaker: bool = True,
    test_file: Optional[str] = None,
    load_images: bool = True,
    max_frames: Optional[int] = None,
) -> FrameDataset:
    """An identity directory (the module's contract) as a FrameDataset: the
    train frames, then every ``testskip``-th val frame (``max_frames``
    cuts the list); the ``_ba`` manifests with ``use_ba``; speaking frames
    from speak_time.npy unless ``all_speaker``. With ``test_file``, a
    driving manifest for novel-audio rendering instead: poses and features
    only, no targets (the reference's test-file mode, load_audface.py:14-47)."""
    aud_features = _load_pt_or_npy(os.path.join(basedir, aud_file))
    exp_features = (_load_pt_or_npy(os.path.join(basedir, exp_file), key="exp_o")
                    if exp_file else None)
    bc_img = _imread(os.path.join(basedir, "bc.jpg"))
    H, W = int(bc_img.shape[0]), int(bc_img.shape[1])

    def read_manifest(name):
        with open(os.path.join(basedir, name)) as f:
            return json.load(f)

    def camera(meta):
        return (H, W, float(meta["focal_len"]), float(meta["cx"]), float(meta["cy"]))

    if test_file:
        meta = read_manifest(test_file)
        frames = meta["frames"][::testskip] if testskip > 1 else meta["frames"]
        poses = [np.array(fr["transform_matrix"], np.float32) for fr in frames]
        auds = [aud_features[min(fr["img_id"], len(aud_features) - 1)] for fr in frames]
        exps = ([] if exp_features is None else
                [exp_features[min(fr["img_id"], len(exp_features) - 1)] for fr in frames])
        return FrameDataset(
            poses=np.stack(poses), auds=np.stack(auds), exps=np.stack(exps) if exps else None,
            imgs_head=None, imgs_com=None, bc_img=bc_img, sample_rects=None,
            hwfcxy=camera(meta), i_train=np.arange(0, dtype=np.int32),
            i_val=np.arange(len(poses), dtype=np.int32))

    suffix = "_ba" if use_ba else ""
    metas = {s: read_manifest(f"transforms_{s}{suffix}.json") for s in ("train", "val")}
    all_frames: List[dict] = []
    counts = [0]
    for s in ("train", "val"):
        skip = 1 if s == "train" or testskip == 0 else testskip
        frames = metas[s]["frames"][::skip]
        all_frames.extend(frames)
        counts.append(counts[-1] + len(frames))
    if max_frames is not None:
        all_frames = all_frames[:max_frames]
        counts = [min(c, max_frames) for c in counts]

    n = len(all_frames)
    poses = np.zeros((n, 4, 4), np.float32)
    auds = np.zeros((n,) + aud_features.shape[1:], np.float32)
    exps = (np.zeros((n,) + exp_features.shape[1:], np.float32)
            if exp_features is not None else None)
    rects = np.zeros((n, 4), np.int32)
    imgs_head = imgs_com = None
    if load_images:
        imgs_head = np.zeros((n, H, W, 3), np.uint8)
        imgs_com = np.zeros((n, H, W, 3), np.uint8)
    for i, fr in enumerate(all_frames):
        poses[i] = np.array(fr["transform_matrix"], np.float32)
        auds[i] = aud_features[min(fr["aud_id"], len(aud_features) - 1)]
        if exps is not None:
            exps[i] = exp_features[min(fr["img_id"], len(exp_features) - 1)]
        rects[i] = np.array(fr["face_rect"], np.int32)
        if load_images:
            imgs_head[i] = _imread(os.path.join(basedir, "head_imgs", f"{fr['img_id']:06d}.jpg"))
            imgs_com[i] = _imread(os.path.join(basedir, "com_imgs", f"{fr['img_id']:06d}.jpg"))

    speak = np.ones(n, np.int32)
    if not all_speaker:
        # speaking intervals in seconds at 30 fps, one frame trimmed at each end
        st = np.load(os.path.join(basedir, "speak_time.npy"))
        speak = np.zeros(n, np.int32)
        for k in range(st.shape[0]):
            speak[int(st[k, 0] * 30) + 1:int(st[k, 1] * 30) - 1] = 1

    return FrameDataset(
        poses=poses, auds=auds, exps=exps, imgs_head=imgs_head, imgs_com=imgs_com,
        bc_img=bc_img, sample_rects=rects, hwfcxy=camera(metas["val"]),
        i_train=np.arange(counts[0], counts[1], dtype=np.int32),
        i_val=np.arange(counts[1], min(counts[2], n), dtype=np.int32),
        speak_frames=speak)
