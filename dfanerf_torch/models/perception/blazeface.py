"""BlazeFace, the 128x128 anchor-based face detector (port of
dfanerf_tpu/models/perception/blazeface.py; the module tree and its keys
are third_party/BlazeFace-PyTorch/blazeface.py's, so ``blazeface.pth``
loads as it is).

A 5x5 stem and 16 depthwise-separable BlazeBlocks over two scales (16x16
with 2 anchors a cell, 8x8 with 6), channel-padded residuals, and the
TFLite-style (0, 2, 0, 2) padding and 2x2 max-pooled skip of a stride-2
block. The decode and the weighted-blend NMS are the reference's, with its
quirk of thresholding the RAW scores at 0.75 (the sigmoid is commented out
at blazeface.py:253-256). The NMS runs on the host in numpy.
"""

from __future__ import annotations

from typing import List, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dfanerf_torch.models.perception.common import StateDict, load_net, put_conv

# (in, out, stride) per BlazeBlock, backbone1 then backbone2
BACKBONE1 = [
    (24, 24, 1), (24, 28, 1), (28, 32, 2), (32, 36, 1), (36, 42, 1),
    (42, 48, 2), (48, 56, 1), (56, 64, 1), (64, 72, 1), (72, 80, 1),
    (80, 88, 1),
]
BACKBONE2 = [(88, 96, 2), (96, 96, 1), (96, 96, 1), (96, 96, 1), (96, 96, 1)]

MIN_SCORE_THRESH = 0.75
MIN_SUPPRESSION_THRESHOLD = 0.3
SCALE = 128.0


class BlazeBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.stride, self.channel_pad = stride, cout - cin
        self.convs = nn.Sequential(
            nn.Conv2d(cin, cin, 3, stride, 0 if stride == 2 else 1, groups=cin),
            nn.Conv2d(cin, cout, 1))

    def forward(self, x):
        if self.stride == 2:
            h = F.pad(x, (0, 2, 0, 2))
            x = F.max_pool2d(x, 2, 2)
        else:
            h = x
        if self.channel_pad > 0:
            x = F.pad(x, (0, 0, 0, 0, 0, self.channel_pad))
        return F.relu(self.convs(h) + x)


class BlazeFace(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone1 = nn.Sequential(nn.Conv2d(3, 24, 5, 2, 0), nn.ReLU(),
                                       *[BlazeBlock(*b) for b in BACKBONE1])
        self.backbone2 = nn.Sequential(*[BlazeBlock(*b) for b in BACKBONE2])
        self.classifier_8 = nn.Conv2d(88, 2, 1)
        self.classifier_16 = nn.Conv2d(96, 6, 1)
        self.regressor_8 = nn.Conv2d(88, 32, 1)
        self.regressor_16 = nn.Conv2d(96, 96, 1)

    def forward(self, x):
        """x: [B, 3, 128, 128] in [-1, 1] -> (raw_boxes [B, 896, 16],
        raw_scores [B, 896])."""
        b = x.shape[0]
        x = self.backbone1(F.pad(x, (1, 2, 1, 2)))  # TFLite stem padding
        h = self.backbone2(x)

        def flat(conv, feat, k):
            return conv(feat).permute(0, 2, 3, 1).reshape(b, -1, k)

        boxes = torch.cat([flat(self.regressor_8, x, 16), flat(self.regressor_16, h, 16)], 1)
        scores = torch.cat([flat(self.classifier_8, x, 1), flat(self.classifier_16, h, 1)], 1)
        return boxes, scores[..., 0]


def generate_anchors() -> np.ndarray:
    """The 896 SSD anchors of the MediaPipe front-camera model
    ((x_center, y_center, w, h), w = h = 1): 16x16 cells x2, then 8x8 x6."""
    anchors = []
    for grid, per_cell in ((16, 2), (8, 6)):
        for y in range(grid):
            for x in range(grid):
                anchors.extend([[(x + 0.5) / grid, (y + 0.5) / grid, 1.0, 1.0]] * per_cell)
    return np.asarray(anchors, np.float32)


def decode_boxes(raw_boxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """[.., 896, 16] raw regressions -> [ymin, xmin, ymax, xmax, 6 x (kx, ky)]."""
    ax, ay, aw, ah = anchors[:, 0], anchors[:, 1], anchors[:, 2], anchors[:, 3]
    xc = raw_boxes[..., 0] / SCALE * aw + ax
    yc = raw_boxes[..., 1] / SCALE * ah + ay
    w = raw_boxes[..., 2] / SCALE * aw
    h = raw_boxes[..., 3] / SCALE * ah
    out = [yc - h / 2, xc - w / 2, yc + h / 2, xc + w / 2]
    for k in range(6):
        out.append(raw_boxes[..., 4 + 2 * k] / SCALE * aw + ax)
        out.append(raw_boxes[..., 5 + 2 * k] / SCALE * ah + ay)
    return torch.stack(out, dim=-1)


def _iou(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """IoU of one [4] (ymin, xmin, ymax, xmax) box against [N, 4] (no +1)."""
    ymin = np.maximum(box[0], boxes[:, 0])
    xmin = np.maximum(box[1], boxes[:, 1])
    ymax = np.minimum(box[2], boxes[:, 2])
    xmax = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(ymax - ymin, 0, None) * np.clip(xmax - xmin, 0, None)
    area = (box[2] - box[0]) * (box[3] - box[1])
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(area + areas - inter, 1e-10)


def weighted_nms(detections: np.ndarray, thresh=MIN_SUPPRESSION_THRESHOLD):
    """Blend-style NMS (blazeface.py:309-354), ordered by a stable argsort:
    overlapping detections are averaged weighted by score, and a cluster's
    score is its mean."""
    if len(detections) == 0:
        return []
    out = []
    remaining = np.argsort(-detections[:, 16], kind="stable")
    while len(remaining) > 0:
        det = detections[remaining[0]].copy()
        mask = _iou(det[:4], detections[remaining, :4]) > thresh
        overlapping = remaining[mask]
        remaining = remaining[~mask]
        if len(overlapping) > 1:
            coords = detections[overlapping, :16]
            scores = detections[overlapping, 16:17]
            det[:16] = (coords * scores).sum(0) / scores.sum()
            det[16] = scores.sum() / len(overlapping)
        out.append(det)
    return out


@torch.no_grad()
def detect_faces(net: BlazeFace, anchors: np.ndarray, images_u8: np.ndarray) -> List[np.ndarray]:
    """The predict_on_batch path: [B, 128, 128, 3] uint8 -> per image an
    array [n, 17] (ymin, xmin, ymax, xmax, 6 keypoints, score), normalised.
    The net and the decode run on the net's device, the NMS on the host."""
    dev = next(net.parameters()).device
    x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(dev).to(torch.float32)
    x = (x / 127.5 - 1.0).permute(0, 3, 1, 2)
    raw_boxes, raw_scores = net(x)
    boxes = decode_boxes(raw_boxes, torch.from_numpy(anchors).to(dev)).cpu().numpy()
    scores = raw_scores.cpu().numpy()
    results = []
    for i in range(x.shape[0]):
        mask = scores[i] >= MIN_SCORE_THRESH
        faces = weighted_nms(np.concatenate([boxes[i, mask], scores[i, mask, None]], axis=-1))
        results.append(np.stack(faces) if faces else np.zeros((0, 17), np.float32))
    return results


def load_blazeface(spec: str, device=None) -> BlazeFace:
    """``blazeface.pth`` or ``random:<seed>``, in eval mode on ``device``
    (default CUDA)."""
    return load_net(spec, lambda sd: BlazeFace(), device)


def blazeface_state_dict_from_jax(params: Mapping) -> StateDict:
    """The reference's parameter tree (numpy leaves) -> this module's state
    dict: the inverse of ``blazeface_from_torch``."""
    sd: StateDict = {}
    put_conv(sd, "backbone1.0", params["stem"])
    for prefix, blocks, first in (("backbone1", params["backbone1"], 2),
                                  ("backbone2", params["backbone2"], 0)):
        for i, p in enumerate(blocks):
            put_conv(sd, f"{prefix}.{i + first}.convs.0", p["conv1"])
            put_conv(sd, f"{prefix}.{i + first}.convs.1", p["conv2"])
    for k in ("classifier_8", "classifier_16", "regressor_8", "regressor_16"):
        put_conv(sd, k, params[k])
    return sd
