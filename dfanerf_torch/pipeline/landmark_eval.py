"""Landmark benchmark evaluation (port of dfanerf_tpu/pipeline/landmark_eval.py):
numpy and CSV on the host.

The reference's offline model-evaluation surface (lib/core/evaluate.py,
the validate loops' failure counters, lib/utils/output_csv_log.py's run
log), as the reference package reports it on 300W/COFW/AFLW/WFLW:

- ``compute_nme_benchmark``: normalised mean error with the reference's
  dispatch on the landmark count (evaluate.py:99-123: 19 -> AFLW box size,
  29 -> COFW 8-9, 68 -> 300W 36-45, 98 -> WFLW 60-72);
- ``pck_accuracy``: heatmap-space PCK with the h/10 normalisation and the
  -1 invalid-landmark convention (evaluate.py:20-76);
- ``benchmark_report``: NME mean, failure rates at 0.08 / 0.10 and the
  AUC@0.10 of the NME's CDF (function.py:650-657) over a dataset;
- ``append_run_log``: the train_status.csv run log (output_csv_log.py:6-64
  field contract, without pandas).
"""

from __future__ import annotations

import csv
import os
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np

_trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy 2 renamed trapz

def compute_nme_benchmark(
    preds: np.ndarray,
    targets: np.ndarray,
    box_size: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Per-image normalized mean error, reference normalization dispatch
    (evaluate.py:99-123). preds/targets [N, L, 2]; box_size [N] required
    for L == 19 (AFLW)."""
    N, L = preds.shape[:2]
    rmse = np.zeros(N)
    for i in range(N):
        pg = targets[i]
        if L == 19:
            if box_size is None:
                raise ValueError("AFLW (19 kpts) needs box_size")
            interocular = box_size[i]
        elif L == 29:
            interocular = np.linalg.norm(pg[8] - pg[9])
        elif L == 68:
            interocular = np.linalg.norm(pg[36] - pg[45])
        elif L == 98:
            interocular = np.linalg.norm(pg[60] - pg[72])
        else:
            raise ValueError("Number of landmarks is wrong")
        rmse[i] = np.sum(
            np.linalg.norm(preds[i] - pg, axis=1)
        ) / (interocular * L)
    return rmse


def _calc_dists(preds, target, normalize):
    """evaluate.py:20-33 — [L, N] normalized distances, -1 where the
    target landmark is invalid (coords <= 1)."""
    dists = np.zeros((preds.shape[1], preds.shape[0]))
    for n in range(preds.shape[0]):
        for c in range(preds.shape[1]):
            if target[n, c, 0] > 1 and target[n, c, 1] > 1:
                dists[c, n] = np.linalg.norm(
                    preds[n, c] / normalize[n] - target[n, c] / normalize[n]
                )
            else:
                dists[c, n] = -1
    return dists


def _dist_acc(dists, thr=0.5):
    valid = dists != -1
    n = valid.sum()
    return float((dists[valid] < thr).sum() / n) if n > 0 else -1.0


def pck_accuracy(pred_coords: np.ndarray, gt_coords: np.ndarray,
                 heatmap_hw, thr: float = 0.5):
    """PCK on heatmap-space coordinates with the reference's h/10, w/10
    normalization (evaluate.py:45-76). Returns (per_joint_acc [L+1]
    with slot 0 = average, avg_acc, n_valid_joints)."""
    h, w = heatmap_hw
    norm = np.ones((pred_coords.shape[0], 2)) * np.array([h, w]) / 10.0
    dists = _calc_dists(pred_coords.astype(np.float32),
                        gt_coords.astype(np.float32), norm)
    L = pred_coords.shape[1]
    acc = np.zeros(L + 1)
    cnt = 0
    for i in range(L):
        acc[i + 1] = _dist_acc(dists[i], thr)
        if acc[i + 1] >= 0:
            acc[0] += acc[i + 1]
            cnt += 1
    acc[0] = acc[0] / cnt if cnt else 0.0
    return acc, float(acc[0]), cnt


def benchmark_report(
    predict_fn: Callable[[np.ndarray], np.ndarray],
    images: np.ndarray,
    gt_landmarks: np.ndarray,
    box_size: Optional[np.ndarray] = None,
    batch: int = 32,
    failure_thresholds: Sequence[float] = (0.08, 0.10),
    auc_at: float = 0.10,
) -> Dict[str, object]:
    """Evaluate a landmark predictor over a benchmark split.

    predict_fn: [B, ...image] -> [B, L, 2] image-space coords (anything
    np.asarray reads: arrays, or tensors on the CPU).
    Returns NME mean/std, per-threshold failure rates (the validate
    loops' count_failure_008/010, function.py:654-657), and AUC@auc_at
    of the NME CDF (standard benchmark summary)."""
    preds = []
    for lo in range(0, images.shape[0], batch):
        preds.append(np.asarray(predict_fn(images[lo:lo + batch])))
    preds = np.concatenate(preds)
    nme = compute_nme_benchmark(preds, np.asarray(gt_landmarks), box_size)
    xs = np.linspace(0.0, auc_at, 201)
    cdf = np.array([(nme <= x).mean() for x in xs])
    return {
        "nme_mean": float(nme.mean()),
        "nme_std": float(nme.std()),
        "nme": nme,
        "failure_rates": {
            f"{t:.2f}": float((nme > t).mean()) for t in failure_thresholds
        },
        f"auc@{auc_at:.2f}": float(_trapezoid(cdf, xs) / auc_at),
        "n_images": int(images.shape[0]),
    }


RUN_LOG_FIELDS = [
    "ID", "Backbone", "Dataset", "Type", "Loss", "Quality", "EN",
    "Input Size", "Batch Size", "GPU Num", "Sigma", "Epoch", "Optim",
    "Scheduler", "Init LR", "Test Perf", "Train Perf", "Test Loss",
    "Train Loss", "GFLOPs",
]


def append_run_log(output_dir: str, row: Dict[str, object],
                   file_name: str = "train_status.csv") -> str:
    """Append one run row to the results CSV with the reference's field
    contract (output_csv_log.py:38-64). Missing fields are blank; the ID
    defaults to the reference's YYYYmmddHHMM stamp."""
    path = os.path.join(output_dir, file_name)
    full = {k: "" for k in RUN_LOG_FIELDS}
    full["ID"] = time.strftime("%Y%m%d%H%M")
    full.update({k: v for k, v in row.items() if k in full})
    exists = os.path.exists(path)
    os.makedirs(output_dir, exist_ok=True)
    with open(path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=RUN_LOG_FIELDS)
        if not exists:
            w.writeheader()
        w.writerow(full)
    return path
