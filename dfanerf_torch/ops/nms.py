"""Non-maximum suppression (port of dfanerf_tpu/ops/nms.py): a masked NMS in
PyTorch on the caller's device, and the C++ host NMS (native/nms.cpp).

The reference ships a Cython CPU NMS and a CUDA bitmask kernel
(lib/nms/{cpu_nms.pyx, nms_kernel.cu}) for its face detector. Both paths
here keep its semantics: greedy suppression in descending score order,
ties in index order (a stable sort), at IoU >= thresh with +1
pixel-inclusive areas. Detection counts are a handful to a few hundred
boxes, so the masked form builds one [N, N] IoU matrix and walks the
sorted boxes once, each step a few tensor ops with no host read.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """[N, 4] (x1, y1, x2, y2) -> [N, N] pairwise IoU, +1-inclusive areas."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    xx1 = torch.maximum(x1[:, None], x1[None, :])
    yy1 = torch.maximum(y1[:, None], y1[None, :])
    xx2 = torch.minimum(x2[:, None], x2[None, :])
    yy2 = torch.minimum(y2[:, None], y2[None, :])
    w = torch.clamp_min(xx2 - xx1 + 1.0, 0.0)
    h = torch.clamp_min(yy2 - yy1 + 1.0, 0.0)
    inter = w * h
    return inter / (area[:, None] + area[None, :] - inter)


def nms_mask(dets: torch.Tensor, thresh: float) -> torch.Tensor:
    """dets [N, 5] -> keep mask [N] (bool, in the input's order), computed on
    dets' device: a box is kept iff no kept box of higher rank overlaps it
    at IoU >= thresh."""
    n = dets.shape[0]
    order = torch.argsort(-dets[:, 4], stable=True)
    over = iou_matrix(dets[order, :4]) >= thresh
    # only boxes of higher rank can suppress: the strict lower triangle
    over &= torch.ones((n, n), dtype=torch.bool, device=dets.device).tril(-1)
    keep_sorted = torch.zeros((n,), dtype=torch.bool, device=dets.device)
    for i in range(n):
        keep_sorted[i] = ~(over[i] & keep_sorted).any()
    keep = torch.zeros_like(keep_sorted)
    keep[order] = keep_sorted
    return keep


def nms(dets, thresh: float) -> list:
    """The reference's API (lib/nms/nms.py:14-32): kept indices in score
    order. dets [N, 5], a tensor (its device runs the masked NMS) or an
    array (the CPU does)."""
    dets = torch.as_tensor(dets, dtype=torch.float32)
    keep = nms_mask(dets, thresh).cpu().numpy()
    order = np.argsort(-dets[:, 4].cpu().numpy(), kind="stable")
    return [int(i) for i in order if keep[i]]


def nms_native(dets, thresh: float) -> list:
    """The C++ host NMS (native/nms.cpp), built with g++ at first use; the
    contract of ``nms``."""
    from dfanerf_torch.native import load_library

    lib = load_library("nms")
    lib.nms_cpu.restype = ctypes.c_int32
    dets = np.ascontiguousarray(dets, np.float32)
    n = dets.shape[0]
    keep = np.zeros((max(n, 1),), np.int32)
    n_keep = lib.nms_cpu(dets.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.c_int32(n),
                         ctypes.c_float(thresh), keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return keep[:n_keep].tolist()
