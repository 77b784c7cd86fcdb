"""Per-frame conditioning signals (port of dfanerf_tpu/train/signals.py and
the half-signal image ``get_half_signals``).

The smoothing window [i - w/2, i + w/2) is a clamped gather times a validity
mask (zero outside [0, n_valid)). ``use_smoothing`` selects the attention-
smoothed signal or the per-frame one; only the selected one is computed.
"""

from __future__ import annotations

import torch

from dfanerf_torch.core.geometry import pose_to_euler_trans
from dfanerf_torch.core.posenc import et_embed


def window_gather(arr: torch.Tensor, i: int, size: int, n_valid: int) -> torch.Tensor:
    """[N, ...] -> [size, ...] window centred at i (zero outside [0, n_valid))."""
    idx = i - size // 2 + torch.arange(size, device=arr.device)
    valid = (idx >= 0) & (idx < n_valid)
    idx_c = idx.clamp(0, arr.shape[0] - 1)
    mask = valid.to(arr.dtype).reshape((size,) + (1,) * (arr.ndim - 1))
    return arr[idx_c] * mask


def encode_signal(
    params,
    auds: torch.Tensor,
    exps: torch.Tensor,
    img_i: int,
    n_valid: int,
    smo_size: int,
    use_smoothing: bool,
    audio_net: str = "w2l",
    win_size: int = 16,
) -> torch.Tensor:
    """Audio + expression conditioning of the head field -> [dim_signal].

    params holds ``audnet``, ``expnet`` and ``audattnet`` (train/state.py).
    audio_net 'w2l' runs AudioNetW2L over [N, 512] wav2exp features;
    'deepspeech' runs AudioNet over [N, 16, 29] DeepSpeech windows,
    centre-cropped to ``win_size``."""
    kw = {"win_size": win_size} if audio_net == "deepspeech" else {}
    if not use_smoothing:
        return torch.cat([params.audnet(auds[img_i], **kw), params.expnet(exps[img_i])], dim=-1)
    feat_win = torch.cat(
        [params.audnet(window_gather(auds, img_i, smo_size, n_valid), **kw),
         params.expnet(window_gather(exps, img_i, smo_size, n_valid))],
        dim=-1,
    )
    return params.audattnet(feat_win, feat_win.shape[-1])


def get_half_signals(H: int, W: int, sig_aud: torch.Tensor, sig_eye: torch.Tensor) -> torch.Tensor:
    """Split-screen conditioning image (reference :105): the top H // 2 rows
    carry the eye signal, the next H // 2 the audio signal; [2 * (H // 2), W, D]
    (an odd H drops the last row, as the reference does)."""
    top = sig_eye.expand(H // 2, W, sig_eye.shape[-1])
    bottom = sig_aud.expand(H // 2, W, sig_aud.shape[-1])
    return torch.cat([top, bottom], dim=0)


def encode_signal_torso(
    params,
    poses: torch.Tensor,
    img_i: int,
    n_valid: int,
    smo_torso_size: int,
    use_smoothing: bool,
    et_multires: int = 3,
) -> torch.Tensor:
    """Pose-embedding conditioning of the torso field -> [dim_et_embed].

    Padded window rows are zeroed poses; pose_to_euler_trans of the zero
    matrix (with its signed zeros) matches the reference's zero-padded
    embedding."""
    if not use_smoothing:
        return et_embed(pose_to_euler_trans(poses[img_i][None]), et_multires)[0]
    poses_win = window_gather(poses, img_i, smo_torso_size, n_valid)
    emb_win = et_embed(pose_to_euler_trans(poses_win), et_multires)
    return params.poseattnet(emb_win, emb_win.shape[-1])
