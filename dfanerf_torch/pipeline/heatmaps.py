"""Heatmap decoding for the landmark networks (port of
dfanerf_tpu/pipeline/heatmaps.py) on [N, K, H, W] tensors, the nets' own
NCHW layout.

Re-design of lib/core/inference.py: argmax decode with the quarter-pixel
gradient-sign refinement (predToKeypoints) and the Gaussian-modulation
smoothing pass (gaussian_modulation_torch), batched over maps.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def get_max_preds(heatmaps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, K, H, W] -> coords [N, K, 2] (x, y) and maxvals [N, K, 1]; the
    first maximum wins, and coords are zeroed where the max is <= 0
    (inference.py:20-49)."""
    n, k, h, w = heatmaps.shape
    flat = heatmaps.reshape(n, k, h * w)
    maxvals = flat.amax(dim=2, keepdim=True)
    idx = flat.argmax(dim=2)
    x = (idx % w).to(torch.float32)
    y = torch.floor(idx.to(torch.float32) / w)
    preds = torch.stack([x, y], dim=-1)
    return preds * (maxvals > 0.0).to(torch.float32), maxvals


def quarter_offset_refine(heatmaps: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Quarter-pixel step toward the local gradient's sign (predToKeypoints
    post_process, inference.py:93-113); sign(0) = 0, and only points with
    1 < px < W - 1 and 1 < py < H - 1 move."""
    n, k, h, w = heatmaps.shape
    px = torch.floor(coords[..., 0] + 0.5).to(torch.int64)
    py = torch.floor(coords[..., 1] + 0.5).to(torch.int64)
    pxc = px.clamp(1, w - 2)
    pyc = py.clamp(1, h - 2)
    flat = heatmaps.reshape(n, k, h * w)

    def gather(dy, dx):
        return torch.gather(flat, 2, ((pyc + dy) * w + (pxc + dx))[..., None])[..., 0]

    diff_x = gather(0, 1) - gather(0, -1)
    diff_y = gather(1, 0) - gather(-1, 0)
    valid = ((px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)).to(torch.float32)
    offset = torch.stack([torch.sign(diff_x), torch.sign(diff_y)], dim=-1) * 0.25
    return coords + offset * valid[..., None]


def gaussian_modulation(heatmaps: torch.Tensor, sigma: float, eps: float = 1e-8) -> torch.Tensor:
    """Depthwise Gaussian blur (an int(6 sigma + 1) kernel), then each map
    rescaled to its own original peak and negatives clamped
    (inference.py:52-89). heatmaps: [N, K, H, W]."""
    size = int(2 * (sigma * 3) + 1)
    x = torch.arange(size, dtype=heatmaps.dtype, device=heatmaps.device)
    x0 = size // 2
    g1 = torch.exp(-((x - x0) ** 2 + (x[:, None] - x0) ** 2) / (2 * sigma ** 2))
    k = heatmaps.shape[1]
    kernel = g1.expand(k, 1, size, size)
    lo = size // 2
    hi = size // 2 - 1 if size % 2 == 0 else size // 2
    orig_max = heatmaps.amax(dim=(2, 3), keepdim=True)
    out = F.conv2d(F.pad(heatmaps, (lo, hi, lo, hi)), kernel, groups=k)
    mx = out.amax(dim=(2, 3), keepdim=True)
    mn = out.amin(dim=(2, 3), keepdim=True)
    out = (out - mn) / (mx - mn + eps) * orig_max
    return out.clamp_min(0.0)


def decode_heatmaps(heatmaps: torch.Tensor, sigma: float = 1.5, modulate: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full decode (modulate -> argmax -> quarter refine) in heatmap pixel
    coordinates: [N, K, H, W] -> coords [N, K, 2] and scores [N, K, 1]."""
    if modulate:
        heatmaps = gaussian_modulation(heatmaps, sigma)
    coords, maxvals = get_max_preds(heatmaps)
    return quarter_offset_refine(heatmaps, coords), maxvals
