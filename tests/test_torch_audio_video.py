"""Audio to video in the port (BASELINE config 4) on the CPU: the feature
stage of render/audio_video.py e2e_audio_video against the reference
package's pipeline, the whole function on a synchronous renderer, and
``python -m dfanerf_torch.cli train`` then ``render`` on the synthetic scene.

- The feature stage: the reference's wav2exp_features then its bench's
  driving step (benchmarks/serve_trained.py e2e_audio_video: the SVD's
  first component, z-scored, tanh, featurize_audio_state), against the
  port's wav2exp_features and driving_features, the same encoder weights
  in both. auds and exps within 1e-5 (measured 2.9e-6 and 1.3e-6, from
  features 1.3e-7 apart: the z-scored component is squashed and then
  multiplied by frequencies up to 3). Both packages take numpy's SVD of
  features that agree to ~1e-7; on this input both took the same sign of
  the first component (checked below, not forced: a flip would fail the
  bar, since the featurized sines are odd in it).
- e2e_audio_video on the CPU (8 frames, 24x24, a narrow unfused renderer,
  which is synchronous): the reference's keys plus ``swaps`` and ``card``,
  and the .y4m it writes holds, in order, the frames that
  render_video_frames renders from the same signals: every plane within 1
  of BT.601 studio-range Y'CbCr computed here in float64 (measured at
  most 0.5: the writer rounds float32 products to the nearest integer).
- e2e_audio_video on a live config on the CPU (7 frames, 32x32, the
  pair-compacted path with its async refresh worker, run to its end as it
  starts, so that every swap is fixed): the ``swaps`` it reports are the
  swaps the timed frames saw in the renderer's cache (3 here), the
  worker that the last frame starts is joined before it returns, and
  ``frame_hook`` runs every driven frame.
- The cli: the PPM frames of ``render`` equal the port's
  render_video_frames of the same checkpoint bit for bit, and the .y4m
  parses back to the same frames (each plane within 1 of Y'CbCr computed
  here).
"""

import json
import os
import shutil
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfanerf_tpu.data.synthetic import featurize_audio_state as j_featurize_audio_state
from dfanerf_tpu.pipeline.audio import wav2exp as JW
from dfanerf_torch import cli
from dfanerf_torch.config import ExperimentConfig, RenderConfig, SignalConfig, TrainConfig
from dfanerf_torch.data.synthetic import make_synthetic_scene
from dfanerf_torch.models import DecoderConfig
from dfanerf_torch.pipeline.audio.wav2exp import init_audio_encoder, wav2exp_features
from dfanerf_torch.render import audio_video
from dfanerf_torch.render.audio_video import driving_features, e2e_audio_video, synth_wav
from dfanerf_torch.render.renderer import render_video_frames
from dfanerf_torch.train.checkpoint import load_checkpoint
from dfanerf_torch.train.state import init_train_state

DEC = dict(hidden_size=64, n_blocks=4, skips=(2,), z_dim=32)
NARROW = ExperimentConfig(decoder=DecoderConfig(**DEC), render=RenderConfig(n_samples=8),
                          train=TrainConfig(n_rand=64, z_dim=32, i_print=1, i_weights=2),
                          signal=SignalConfig(nosmo_iters=1))
N_CLI = 6  # frames of the cli's synthetic scene here


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch single-threaded for this module: its frames are tiny, and the
    intra-op threads of six suite workers on a few cores cost more than they
    save (the module took 266 s inside the six-worker suite, 12 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read_y4m(path):
    """(header fields, planes [N, 3, H, W] uint8) of a 4:4:4 YUV4MPEG2 file."""
    with open(path, "rb") as f:
        data = f.read()
    head, _, body = data.partition(b"\n")
    fields = head.split(b" ")
    assert fields[0] == b"YUV4MPEG2"
    tags = {t[:1].decode(): t[1:].decode() for t in fields[1:]}
    w, h = int(tags["W"]), int(tags["H"])
    frame = len(b"FRAME\n") + 3 * h * w
    assert len(body) % frame == 0
    planes = [np.frombuffer(body[i + 6:i + frame], np.uint8).reshape(3, h, w)
              for i in range(0, len(body), frame)]
    assert all(body[i:i + 6] == b"FRAME\n" for i in range(0, len(body), frame))
    return tags, np.stack(planes)


def _ycbcr(frames):
    """BT.601 studio-range Y'CbCr [N, 3, H, W] of uint8 RGB [N, H, W, 3],
    from Kr = 0.299 and Kb = 0.114."""
    rgb = frames.astype(np.float64) / 255.0
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = (b - y) / 1.772
    cr = (r - y) / 1.402
    return np.stack([16 + 219 * y, 128 + 224 * cb, 128 + 224 * cr], axis=1)


def _read_ppm(path):
    with open(path, "rb") as f:
        magic, w, h, maxval, data = f.read().split(maxsplit=4)
    assert magic == b"P6" and maxval == b"255"
    return np.frombuffer(data, np.uint8).reshape(int(h), int(w), 3)


def test_feature_stage_matches_reference():
    n = 8
    enc = init_audio_encoder(3, device="cpu")
    wav = synth_wav(n)
    feats = wav2exp_features(enc, wav).numpy()
    auds, exps = driving_features(feats[:n])
    # the reference's pipeline, on the same weights
    jfeats = np.asarray(JW.wav2exp_features(JW.audio_encoder_from_torch(enc.state_dict()),
                                            jnp.asarray(wav)))
    assert jfeats.shape == feats.shape and feats.shape[0] >= n
    f = jfeats[:n] - jfeats[:n].mean(0)
    _, _, vt = np.linalg.svd(f, full_matrices=False)
    s = f @ vt[0]
    s = np.tanh(s / max(float(s.std()), 1e-6))
    j_auds, j_exps = j_featurize_audio_state(s)
    fp = feats[:n] - feats[:n].mean(0)
    assert float(np.dot(fp @ np.linalg.svd(fp, full_matrices=False)[2][0], f @ vt[0])) > 0, \
        "the packages' SVDs took opposite signs"
    np.testing.assert_allclose(auds, j_auds, rtol=0, atol=1e-5)
    np.testing.assert_allclose(exps, j_exps, rtol=0, atol=1e-5)


def test_e2e_audio_video_on_cpu():
    n, H = 8, 24
    ds = make_synthetic_scene(n_frames=6, H=H, W=H, seed=0)
    state = init_train_state(NARROW, seed=0, device="cpu")
    data = {"poses": torch.from_numpy(ds.poses), "bc_img": torch.from_numpy(ds.bc_img)}
    out = e2e_audio_video(NARROW, ds, state, data, n_frames=n, device="cpu")
    assert set(out) == {"fps_e2e", "n_frames", "headroom_s", "feature_warm_s", "feature_s",
                        "render_s", "encode_s", "render_fps", "video", "swaps", "card"}
    assert out["n_frames"] == n and out["headroom_s"] is None and out["swaps"] == 0
    assert out["card"] == "cpu" and out["video"].endswith(".y4m")
    tags, planes = _read_y4m(out["video"])
    assert (tags["W"], tags["H"], tags["F"], tags["C"]) == (str(H), str(H), "25:1", "444")
    assert planes.shape == (n, 3, H, H)
    # the frames of the same signals, rendered apart
    auds, exps = driving_features(
        wav2exp_features(init_audio_encoder(3, device="cpu"), synth_wav(n)).numpy()[:n])
    frames, _ = render_video_frames(
        state, {"auds": auds, "exps": exps, "poses": ds.poses[np.arange(n) % ds.n_frames],
                "bc_img": ds.bc_img}, NARROW, ds.hwfcxy, ds.near, ds.far, range(n),
        device="cpu")
    assert np.abs(planes - _ycbcr(frames)).max() <= 1.0
    shutil.rmtree(os.path.dirname(out["video"]))


# the pair-compacted live path (cfg2's levers) at 32x32, 16 samples
LIVE = ExperimentConfig(render=RenderConfig(
    n_samples=16, use_fused_kernel=True, spatial_tiles=True, occ_sigma_thresh=0.18,
    occ_grid_res=16, occ_refresh_every=1, occ_pair_compaction=True, occ_prune_budget=1e-2,
    occ_budget_color=True, occ_prune_trans=0.01, occ_prune_carry=0, ert_eps=0.0,
    occ_async_refresh=True, occ_prune_hist_decay=0.8, occ_live_keys=True,
    occ_live_remeasure=3))


class InlineWorker(threading.Thread):
    """The refresh worker, run to its end as it starts; its joins recorded."""

    joined = []

    def start(self):
        super().start()
        super().join()

    def join(self, timeout=None):
        InlineWorker.joined.append(self)
        super().join(timeout)


def test_e2e_audio_video_live_swaps_and_join(monkeypatch):
    n, n_warm = 7, 2 * LIVE.render.occ_refresh_every + 1
    ds = make_synthetic_scene(n_frames=6, H=32, W=32, seed=0)
    state = init_train_state(LIVE, seed=0, device="cpu")
    data = {"poses": torch.from_numpy(ds.poses), "bc_img": torch.from_numpy(ds.bc_img)}
    made, seen, hooked = [], [], []
    real_make = audio_video.make_frame_renderer

    def make_counted(*a, **kw):
        render = real_make(*a, **kw)
        made.append(render)

        def frame(*fa):
            out = render(*fa)
            seen.append(render.cache.get("swaps", 0))
            return out

        frame.cache, frame.worker = render.cache, render.worker
        return frame

    def hook(fn):
        hooked.append(len(seen))
        return fn()

    monkeypatch.setattr(audio_video, "make_frame_renderer", make_counted)
    monkeypatch.setattr(threading, "Thread", InlineWorker)
    InlineWorker.joined.clear()
    out = e2e_audio_video(LIVE, ds, state, data, n_frames=n, device="cpu", frame_hook=hook)
    shutil.rmtree(os.path.dirname(out["video"]))
    (render,) = made
    assert hooked == list(range(n_warm + n)) and len(seen) == n_warm + n
    assert out["swaps"] == seen[-1] - seen[n_warm - 1] > 0, seen
    last = render.worker["thread"]
    assert last is not None and InlineWorker.joined == [last]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """cli train --synthetic (2 steps of a narrow config), then cli render of
    its checkpoint with --video, all on the CPU. The synthetic scene is cut
    from the cli's 40 frames of 128x128 to 6 of 32x32 (the cli's call is
    checked, then answered with the smaller scene)."""
    from dfanerf_torch.data import synthetic

    tmp = tmp_path_factory.mktemp("cli")
    cfg_path = tmp / "narrow.json"
    raw = NARROW.to_dict()
    raw.update(basedir=str(tmp / "runs"), expname="narrow")
    cfg_path.write_text(json.dumps(raw))
    real, calls = synthetic.make_synthetic_dataset, []

    def small(n_frames, H, W, device=None):
        calls.append((n_frames, H, W, str(device)))
        return real(n_frames=N_CLI, H=32, W=32, n_samples_gt=16, device=device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(synthetic, "make_synthetic_dataset", small)
        cli.main(["train", "--synthetic", "--config", str(cfg_path), "--n-iters", "2",
                  "--device", "cpu"])
        ckpt = tmp / "runs" / "narrow" / "000002.npz"
        cli.main(["render", "--synthetic", "--config", str(cfg_path), "--ckpt", str(ckpt),
                  "--out", str(tmp / "out"), "--video", "--device", "cpu"])
    assert calls == [(40, 128, 128, "cpu")] * 2
    return ExperimentConfig.from_json(str(cfg_path)), ckpt, tmp / "out"


def test_cli_render_frames_equal_render_video_frames(cli_run):
    cfg, ckpt, out = cli_run
    state = load_checkpoint(str(ckpt), init_train_state(cfg, seed=0, device="cpu"))
    assert state["step"] == 2
    ds = make_synthetic_scene(n_frames=N_CLI, H=32, W=32)
    data = {k: getattr(ds, k) for k in ("auds", "exps", "poses", "bc_img")}
    com, head = render_video_frames(state, data, cfg, ds.hwfcxy, ds.near, ds.far, range(N_CLI),
                                    use_smoothing=True, device="cpu")
    for i in range(N_CLI):
        np.testing.assert_array_equal(_read_ppm(out / "render_com" / f"test_{i:06d}.ppm"), com[i])
        np.testing.assert_array_equal(_read_ppm(out / "render_head" / f"test_{i:06d}.ppm"),
                                      head[i])
    assert len(list((out / "render_com").iterdir())) == N_CLI
    tags, planes = _read_y4m(out / "narrow.y4m")
    assert planes.shape == (N_CLI, 3, 32, 32) and tags["C"] == "444"
    assert np.abs(planes - _ycbcr(com)).max() <= 1.0
