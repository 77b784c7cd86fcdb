"""Audio to video, end to end (BASELINE config 4; port of
``benchmarks/serve_trained.py e2e_audio_video``): a synthesized wav, its
wav2exp features, the scene's driving signals, live frames, a video file.

Frames and video go out in formats that numpy alone writes: binary PPM
frames (``write_ppm``) and YUV4MPEG2 video (``write_y4m``: 4:4:4, BT.601
studio range), which ffmpeg and most players read.
"""

from __future__ import annotations

import os
import tempfile
import time
from collections import deque
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from dfanerf_torch.config import ExperimentConfig
from dfanerf_torch.data.dataset import FrameDataset
from dfanerf_torch.data.synthetic import featurize_audio_state
from dfanerf_torch.device import resolve_device
from dfanerf_torch.pipeline.audio.frontend import Wav2ExpHParams
from dfanerf_torch.pipeline.audio.wav2exp import init_audio_encoder, wav2exp_features
from dfanerf_torch.render.renderer import encode_frame_signals, make_frame_renderer

RING_DEPTH = 8  # frames in flight between the card and the host
# BT.601 RGB [0, 255] -> Y'CbCr, studio range (Y' 16..235, Cb and Cr 16..240)
_BT601 = np.array([[65.481, 128.553, 24.966],
                   [-37.797, -74.203, 112.0],
                   [112.0, -93.786, -18.214]], np.float32) / 255.0
_BT601_OFFSET = np.array([16.0, 128.0, 128.0], np.float32)


def write_ppm(path: str, img: np.ndarray) -> None:
    """One uint8 RGB image [H, W, 3] as a binary PPM (P6)."""
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(img, np.uint8).tobytes())


def write_y4m(path: str, frames: np.ndarray, fps: int = 25) -> None:
    """uint8 RGB frames [N, H, W, 3] as YUV4MPEG2, 4:4:4, BT.601 studio
    range, progressive, square pixels."""
    _, h, w, _ = frames.shape
    with open(path, "wb") as f:
        f.write(b"YUV4MPEG2 W%d H%d F%d:1 Ip A1:1 C444\n" % (w, h, fps))
        for fr in frames:
            yuv = fr.reshape(-1, 3).astype(np.float32) @ _BT601.T + _BT601_OFFSET
            f.write(b"FRAME\n")
            f.write(np.rint(yuv).astype(np.uint8).T.tobytes())  # planes Y', Cb, Cr


def driving_features(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """wav2exp features [n, 512] -> the scene's driving (auds [n, 512],
    exps [n, 64]): the first principal component of the feature trajectory
    (numpy's SVD, on the host), z-scored and squashed with tanh, featurized
    as the training features are (data/synthetic.py featurize_audio_state)."""
    f = feats - feats.mean(0)
    _, _, vt = np.linalg.svd(f, full_matrices=False)
    s = f @ vt[0]
    s = np.tanh(s / max(float(s.std()), 1e-6))
    return featurize_audio_state(s)


def synth_wav(n_frames: int, hp: Wav2ExpHParams = Wav2ExpHParams()) -> np.ndarray:
    """The synthesized utterance: a 220 Hz tone, amplitude-modulated at 3 Hz,
    n_frames / 25 + 0.4 seconds long."""
    dur = n_frames / 25.0 + 0.4
    t = np.arange(int(dur * hp.sample_rate), dtype=np.float32) / hp.sample_rate
    return (0.3 * np.sin(2 * np.pi * 220 * t)
            * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)


def _run(fn):
    return fn()


@torch.no_grad()
def e2e_audio_video(cfg_live: ExperimentConfig, ds: FrameDataset, state, data, n_frames: int = 80,
                    device=None, card: Optional[str] = None,
                    frame_hook: Callable = _run) -> Dict:
    """Audio to video, timed end to end on ``device`` (default CUDA).

    Stages, each timed on the host's clock after the device has finished:
    the features of a same-shape silent wav first (``feature_warm_s``, a
    server's start-up cost); the timed features (``feature_s``: wav2exp,
    the driving signals of ``driving_features``, the cycled poses); a fresh
    ``make_frame_renderer(cfg_live, ...)`` warmed by 2 occ_refresh_every + 1
    live frames; the timed render (``render_s``: each frame's signals and
    render, its uint8 conversion on the device and a non-blocking copy into
    one of RING_DEPTH + 1 pinned host buffers, presented RING_DEPTH frames
    later through the copy's event); the video (``encode_s``: write_y4m).
    ``swaps`` counts the refresh worker's swaps during the timed render
    where ``cfg_live`` serves live (the pair-compacted path with
    ``occ_async_refresh``; else 0); that worker is joined before the
    function returns. ``frame_hook(fn)`` runs each driven frame's work on
    the device and returns ``fn()``: the frame's signals and render, and in
    the timed render also its uint8 conversion, the copy's dispatch and its
    event; never a wait on the host. ``card`` names the device beside the
    times in the result (the card's name and power limit, as the caller
    read them; by default the device's name).
    ``headroom_s`` is None: the reference precompiles a headroom program
    class, which the port does not have (ROADMAP.md queue 2, R10). The
    encoder is the seeded init_audio_encoder(3), as in the reference: the
    trained audio_encoder.pth is an external asset."""
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    hp = Wav2ExpHParams()
    wav = synth_wav(n_frames, hp)
    encoder = init_audio_encoder(3, device=dev)
    tw = time.perf_counter()
    wav2exp_features(encoder, np.zeros_like(wav), hp)
    sync()
    feature_warm_s = time.perf_counter() - tw

    t0 = time.perf_counter()
    feats = wav2exp_features(encoder, wav, hp).cpu().numpy()
    n = int(min(n_frames, feats.shape[0]))
    auds, exps = (torch.from_numpy(x).to(dev) for x in driving_features(feats[:n]))
    poses = data["poses"][torch.arange(n, device=dev) % ds.n_frames]
    sync()
    feature_s = time.perf_counter() - t0

    render = make_frame_renderer(cfg_live, ds.hwfcxy, ds.near, ds.far, device=dev)
    params = state["params"]

    def live_frame(i):
        sig, sig_t = encode_frame_signals(params, auds, exps, poses, i, n, cfg_live, True)
        _, com = render(params, state["z_shape"], state["z_app"], poses[i], poses[0], sig, sig_t,
                        data["bc_img"])
        return com

    for i in range(min(2 * cfg_live.render.occ_refresh_every + 1, n)):
        frame_hook(lambda: live_frame(i))
        sync()

    H, W = int(ds.hwfcxy[0]), int(ds.hwfcxy[1])
    bufs = [torch.empty((H, W, 3), dtype=torch.uint8, pin_memory=dev.type == "cuda")
            for _ in range(RING_DEPTH + 1)]
    frames = np.empty((n, H, W, 3), np.uint8)
    ring = deque()

    def present():
        i, host, done = ring.popleft()
        if done is not None:
            done.synchronize()
        frames[i] = host.numpy()

    def enqueue(i):
        u8 = (live_frame(i).clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        host = bufs[i % len(bufs)]
        host.copy_(u8, non_blocking=True)
        done = None
        if dev.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        ring.append((i, host, done))

    r = cfg_live.render
    live = (r.use_fused_kernel and r.occ_sigma_thresh > 0 and r.occ_pair_compaction
            and r.occ_async_refresh)
    swaps0 = render.cache.get("swaps", 0) if live else 0
    t1 = time.perf_counter()
    for i in range(n):
        frame_hook(lambda: enqueue(i))
        if len(ring) > RING_DEPTH:
            present()
    while ring:
        present()
    render_s = time.perf_counter() - t1
    swaps = render.cache.get("swaps", 0) - swaps0 if live else 0

    t2 = time.perf_counter()
    out = os.path.join(tempfile.mkdtemp(prefix="dfanerf_e2e_"), "driven.y4m")
    write_y4m(out, frames, fps=25)
    encode_s = time.perf_counter() - t2
    if live and render.worker["thread"] is not None:
        render.worker["thread"].join()  # the renderer ends with this call: its worker too
    total = feature_s + render_s + encode_s
    return {
        "fps_e2e": n / total,
        "n_frames": n,
        "headroom_s": None,
        "feature_warm_s": feature_warm_s,
        "feature_s": feature_s,
        "render_s": render_s,
        "encode_s": encode_s,
        "render_fps": n / render_s,
        "video": out,
        "swaps": swaps,
        "card": card or (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
    }
