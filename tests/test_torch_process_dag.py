"""The preprocessing DAG, steps 2-11, run by the port's driver and by the
reference's over the same 5 frames at 128x128 (the synthetic scene), the
same seeded .pth assets (chip_smoke.py write_process_assets, with its two
raised biases) and the same full-size seeded 3DMM in the .bin layout; every
artifact is held against the reference's, and the port's directory loads
through load_audface_dataset.

Test settings: ref_id 0, 64x64 flow crops, score_thresh -1e9, every frame
in the background, 40 tracker iterations, bundle adjustment's two phases
at 50 + 100 steps (both packages' ``bundle_adjust`` handed them), a narrow HRNet (channels 8,
16, 32, 64, one module a stage and one block a branch; the port reads that
configuration off the checkpoint, the reference's converter is handed
it). The reference's nets run jitted, their compiles (and the eager
heatmap decode's, and the reference's step 11, which reads only aud.wav)
started at once in threads while the port runs.

Tolerances, stated where they are used:
- landmarks (.lms, .eye), flows, keypoint tracks: 1e-3 px;
- pose pkls: rtol 1e-3, atol 1e-3 (EPnP on those landmarks);
- parsing classes: equal, except at near-ties of the main head's top two
  logits (gap < 1e-4), which the test counts and shows;
- bc.jpg, com/head images and face masks: equal where the parsing is;
- keypoints.txt: equal; face rects within 1 px (int() of landmark values);
- tracker, bundle adjustment, transforms, near/far: rtol 1e-3, atol 1e-5;
- the 64_32 and audio features: rtol 1e-4, atol 1e-5.
"""

import concurrent.futures
import functools
import json
import os
import pickle
from glob import glob

import numpy as np
import pytest
import torch

import jax

import chip_smoke
from dfanerf_torch.models.perception.hrnet import HRNetConfig

N_FRAMES, SIZE = 5, 128
NARROW = HRNetConfig(stage2=(1, 2, (1, 1), (8, 16)), stage3=(1, 3, (1, 1, 1), (8, 16, 32)),
                     stage4=(1, 4, (1, 1, 1, 1), (8, 16, 32, 64)))
CROP = (64, 64)
TRACK_ITERS = 40
BA_ITERS = dict(iters_pts=50, iters_joint=100)
STEPS = lambda d: [  # noqa: E731
    lambda: d.step_landmarks(score_thresh=-1e9), d.step_parsing,
    lambda: d.step_background(every=1), d.step_compose,
    lambda: d.step_flow(ref_id=0, crop_hw=CROP), lambda: d.step_track(n_iters=TRACK_ITERS),
    d.step_bundle_adjust, d.step_transforms, d.step_disentangle, d.step_wav2exp]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch single-threaded for this module: its inputs are small, and the
    intra-op threads of six suite workers on a few cores cost more than they
    save."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_warm(assets):
    """Jitted reference nets and what warms their compiles: the driver's
    eager applies are swapped for them (numerics of the same functions)."""
    from dfanerf_tpu.models.perception import bisenet, blazeface, ghostnet_eye, hrnet, raft
    from dfanerf_tpu.pipeline.heatmaps import decode_heatmaps

    hr_from_torch = functools.partial(hrnet.hrnet_from_torch, cfg=NARROW)
    jitted = {(hrnet, "apply_hrnet"): jax.jit(hrnet.apply_hrnet),
              (ghostnet_eye, "apply_eye_net"): jax.jit(ghostnet_eye.apply_eye_net),
              (bisenet, "apply_bisenet"): jax.jit(bisenet.apply_bisenet)}
    load = functools.partial(torch.load, map_location="cpu")
    warm = [
        lambda: jitted[(hrnet, "apply_hrnet")](hr_from_torch(load(assets.hrnet_pth)),
                                               np.zeros((1, 256, 256, 3), np.float32)),
        lambda: jitted[(ghostnet_eye, "apply_eye_net")](
            ghostnet_eye.eye_net_from_torch(load(assets.eye_pth)),
            np.zeros((1, 32, 48, 1), np.float32)),
        lambda: jitted[(bisenet, "apply_bisenet")](
            bisenet.bisenet_from_torch(load(assets.bisenet_pth)),
            np.zeros((1, SIZE, SIZE, 3), np.float32)),
        lambda: blazeface.detect_faces(blazeface.blazeface_from_torch(load(assets.blazeface_pth)),
                                       blazeface.generate_anchors(),
                                       np.zeros((1, 128, 128, 3), np.uint8)),
        lambda: raft.flow_on_crops(raft.raft_small_from_torch(load(assets.raft_pth)),
                                   np.zeros((1, *CROP, 3), np.float32),
                                   np.zeros((1, *CROP, 3), np.float32),
                                   np.array([[0, 8, 0, 8, 0, 8, 0, 8]]), (SIZE, SIZE)),
        lambda: decode_heatmaps(np.zeros((1, 64, 64, 68), np.float32), sigma=2.0),
        lambda: decode_heatmaps(np.zeros((1, 16, 24, 6), np.float32), modulate=False),
    ]
    from dfanerf_tpu.pipeline import tracking

    patches = {**jitted, (hrnet, "hrnet_from_torch"): hr_from_torch,
               (tracking, "bundle_adjust"): functools.partial(tracking.bundle_adjust, **BA_ITERS)}
    return patches, warm


@pytest.fixture(scope="module")
def dag(tmp_path_factory):
    from dfanerf_torch.pipeline.driver import PipelineDriver as PortDriver
    from dfanerf_tpu.pipeline.driver import PipelineAssets, PipelineDriver as RefDriver

    root = str(tmp_path_factory.mktemp("dag"))
    port_dir, ref_dir = os.path.join(root, "port", "chain"), os.path.join(root, "ref", "chain")
    chip_smoke.write_process_identity(port_dir, N_FRAMES, SIZE, device="cpu")
    assets, raised = chip_smoke.write_process_assets(os.path.join(root, "assets"), port_dir,
                                                     hrnet_cfg=NARROW, device="cpu")
    os.makedirs(os.path.join(ref_dir, "ori_imgs"))
    for p in glob(os.path.join(port_dir, "ori_imgs", "*.jpg")) + [
            os.path.join(port_dir, "aud.wav")]:
        rel = os.path.relpath(p, port_dir)
        with open(p, "rb") as f, open(os.path.join(ref_dir, rel), "wb") as g:
            g.write(f.read())
    patches, warm = _jax_warm(assets)
    port = PortDriver(port_dir, assets, dst_size=SIZE, device="cpu")
    ref = RefDriver(ref_dir, PipelineAssets(**vars(assets)), dst_size=SIZE)
    import dfanerf_torch.pipeline.tracking as port_tracking

    with concurrent.futures.ThreadPoolExecutor(4) as pool, pytest.MonkeyPatch.context() as mp:
        jobs = [pool.submit(w) for w in warm + [ref.step_wav2exp]]
        mp.setattr(port_tracking, "bundle_adjust",
                   functools.partial(port_tracking.bundle_adjust, **BA_ITERS))
        for step in STEPS(port):
            step()
        for j in jobs:
            j.result()
    with pytest.MonkeyPatch.context() as mp:
        for (mod, name), fn in patches.items():
            mp.setattr(mod, name, fn)
        for step in STEPS(ref)[:-1]:  # step 11 ran above
            step()
    return {"port": port_dir, "ref": ref_dir, "driver": port, "assets": assets, "raised": raised}


def _ids(d):
    return sorted(os.path.basename(p) for p in glob(os.path.join(d, "ori_imgs", "*.lms")))


def _pt(path, key=None):
    obj = torch.load(path, map_location="cpu")
    return (obj[key] if key else obj).numpy()


def test_every_step_did_work(dag):
    """Detections, landmarks and eyes on every frame, head and background
    pixels in the parsing, mined keypoints, a BA that lowers its loss."""
    d = dag["driver"]
    assert d.last_landmarks == {"frames": N_FRAMES, "detected": N_FRAMES, "no_face": 0,
                                "low_score": 0, "with_lms": N_FRAMES, "eyes": N_FRAMES}
    assert all(0 < h < SIZE * SIZE for h in d.last_parsing["head_pixels"])
    assert d.last_ba["keypoints"] > 0 and d.last_ba["loss"] < d.last_ba["loss_pts"]
    assert set(dag["raised"]) == {"blazeface regressor_8.bias[w, h]",
                                  "blazeface regressor_16.bias[w, h]",
                                  "bisenet conv_out.conv_out.bias[0]"}


@pytest.mark.parametrize("ext", [".lms", ".eye"])
def test_landmarks(dag, ext):
    """68 landmarks (jaw-smoothed) and 12 eye landmarks per frame, 1e-3 px."""
    names = sorted(os.path.basename(p) for p in glob(os.path.join(dag["port"], "ori_imgs",
                                                                   f"*{ext}")))
    assert names == sorted(os.path.basename(p) for p in glob(os.path.join(dag["ref"], "ori_imgs",
                                                                          f"*{ext}")))
    assert len(names) == N_FRAMES
    for n in names:
        got = np.loadtxt(os.path.join(dag["port"], "ori_imgs", n))
        want = np.loadtxt(os.path.join(dag["ref"], "ori_imgs", n))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_pose_pkls(dag):
    """EPnP pose, its Kalman-steadied copy and the landmarks it shows."""
    names = sorted(os.listdir(os.path.join(dag["ref"], "pose_pkl")))
    assert names == sorted(os.listdir(os.path.join(dag["port"], "pose_pkl")))
    assert len(names) == N_FRAMES
    for n in names:
        with open(os.path.join(dag["port"], "pose_pkl", n), "rb") as f:
            got = pickle.load(f)
        with open(os.path.join(dag["ref"], "pose_pkl", n), "rb") as f:
            want = pickle.load(f)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-3, err_msg=k)


def _read(path):
    import cv2

    return cv2.imread(path, cv2.IMREAD_UNCHANGED)


@torch.no_grad()
def test_parsing_equal_but_near_ties(dag):
    """The class colours agree except where the main head's two best logits
    are within 1e-4 (recomputed with the port's parser): a near-tie that
    float32 rounding may settle either way. The count of such pixels is
    printed."""
    from dfanerf_torch.models.perception.bisenet import load_bisenet
    from dfanerf_torch.pipeline.driver import IMAGENET_MEAN, IMAGENET_STD, _imread

    net = load_bisenet(dag["assets"].bisenet_pth, device="cpu")
    flips = 0
    for i in range(N_FRAMES):
        got = _read(os.path.join(dag["port"], "parsing", f"{i:06d}.png"))
        want = _read(os.path.join(dag["ref"], "parsing", f"{i:06d}.png"))
        diff = (got != want).any(-1)
        if diff.any():
            img = _imread(os.path.join(dag["port"], "ori_imgs", f"{i:06d}.jpg"))
            x = (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
            logits = net(torch.from_numpy(x[None]).permute(0, 3, 1, 2))[0][0]
            top2 = logits.topk(2, dim=0).values
            gap = (top2[0] - top2[1]).numpy()
            assert (gap[diff] < 1e-4).all(), gap[diff].max()
            flips += int(diff.sum())
    print(f"parsing: {flips} near-tie pixels differ over {N_FRAMES} frames")


def _parsing_equal(dag, i):
    return np.array_equal(_read(os.path.join(dag["port"], "parsing", f"{i:06d}.png")),
                          _read(os.path.join(dag["ref"], "parsing", f"{i:06d}.png")))


def test_background_and_composites(dag):
    """bc.jpg, com_imgs, head_imgs and face_mask equal where the parsing is
    (every frame here: the test requires the parsing to match exactly)."""
    assert all(_parsing_equal(dag, i) for i in range(N_FRAMES))
    np.testing.assert_array_equal(_read(os.path.join(dag["port"], "bc.jpg")),
                                  _read(os.path.join(dag["ref"], "bc.jpg")))
    for sub, ext in (("com_imgs", "jpg"), ("head_imgs", "jpg"), ("face_mask", "png")):
        for i in range(N_FRAMES):
            np.testing.assert_array_equal(
                _read(os.path.join(dag["port"], sub, f"{i:06d}.{ext}")),
                _read(os.path.join(dag["ref"], sub, f"{i:06d}.{ext}")), err_msg=f"{sub} {i}")


def test_flows_keypoints_and_tracks(dag):
    """Dense flows and keypoint tracks at 1e-3 px; the mined keypoints equal."""
    names = sorted(os.listdir(os.path.join(dag["ref"], "flow_result")))
    assert names == sorted(os.listdir(os.path.join(dag["port"], "flow_result")))
    assert len(names) == N_FRAMES
    for n in names:
        got = np.load(os.path.join(dag["port"], "flow_result", n))
        want = np.load(os.path.join(dag["ref"], "flow_result", n))
        assert got.shape == want.shape == (2, SIZE, SIZE)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3, err_msg=n)
    keys = np.loadtxt(os.path.join(dag["port"], "keypoints.txt"))
    np.testing.assert_array_equal(keys, np.loadtxt(os.path.join(dag["ref"], "keypoints.txt")))
    assert len(keys) > 0
    np.testing.assert_allclose(np.load(os.path.join(dag["port"], "track_xys.npy")),
                               np.load(os.path.join(dag["ref"], "track_xys.npy")), rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("name,keys", [
    ("track_params_ba.pt", ("id", "exp", "euler", "trans", "focal")),
    ("bundle_adjustment.pt", ("euler", "trans", "focal"))])
def test_tracker_and_bundle_adjustment(dag, name, keys):
    got = torch.load(os.path.join(dag["port"], name))
    want = torch.load(os.path.join(dag["ref"], name))
    assert set(got) == set(want) == set(keys)
    assert got["focal"].item() == want["focal"].item()
    for k in keys:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("split", ["train", "val"])
def test_transforms(dag, split):
    """The manifests: the same frames and ids, camera, poses at 1e-3 and
    face rects within 1 px."""
    name = f"transforms_{split}_ba.json"
    with open(os.path.join(dag["port"], name)) as f:
        got = json.load(f)
    with open(os.path.join(dag["ref"], name)) as f:
        want = json.load(f)
    assert len(got["frames"]) == len(want["frames"]) == (4 if split == "train" else 1)
    for k in ("cx", "cy"):
        assert got[k] == want[k]
    np.testing.assert_allclose(got["focal_len"], want["focal_len"], rtol=1e-3)
    for fg, fw in zip(got["frames"], want["frames"]):
        assert (fg["img_id"], fg["aud_id"]) == (fw["img_id"], fw["aud_id"])
        np.testing.assert_allclose(fg["transform_matrix"], fw["transform_matrix"], rtol=1e-3,
                                   atol=1e-5)
        np.testing.assert_allclose(fg["face_rect"], fw["face_rect"], rtol=0, atol=1)


@pytest.mark.parametrize("name", ["HeadNeRF_config_ba.txt", "TorsoNeRF_config_ba.txt",
                                  "TorsoNeRFTest_config_ba.txt"])
def test_config_txts(dag, name):
    """The same lines but the directories; near/far at 1e-3, and the port's
    legacy-config reader returns them."""
    from dfanerf_torch.config import parse_legacy_config_file

    with open(os.path.join(dag["port"], name)) as f:
        got = f.read().splitlines()
    with open(os.path.join(dag["ref"], name)) as f:
        want = f.read().splitlines()
    assert [ln.split(" = ")[0] for ln in got] == [ln.split(" = ")[0] for ln in want]
    assert got[0] == want[0] and got[5] == want[5]
    assert got[1] == f"datadir = {os.path.abspath(dag['port'])}"
    near_far = [float(ln.split(" = ")[1]) for ln in got[3:5]]
    np.testing.assert_allclose(near_far, [float(ln.split(" = ")[1]) for ln in want[3:5]],
                               rtol=1e-3, atol=1e-5)
    assert parse_legacy_config_file(os.path.join(dag["port"], name)) == tuple(near_far)


def test_disentangle_and_audio_features(dag):
    got = torch.load(os.path.join(dag["port"], "chain_64_32.pt"))
    want = torch.load(os.path.join(dag["ref"], "chain_64_32.pt"))
    for k in ("exp_o", "exp_m"):
        assert got[k].shape == want[k].shape == (N_FRAMES, 64 if k == "exp_o" else 32)
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5)
    got, want = _pt(os.path.join(dag["port"], "chain_aud.pt")), _pt(
        os.path.join(dag["ref"], "chain_aud.pt"))
    assert got.shape == want.shape and got.shape[1] == 512 and got.shape[0] >= N_FRAMES
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_port_directory_loads(dag):
    """The trainer's contract: the port's directory loads end to end."""
    from dfanerf_torch.data.dataset import load_audface_dataset

    ds = load_audface_dataset(dag["port"], "chain_aud.pt", "chain_64_32.pt", use_ba=True)
    assert ds.n_frames == N_FRAMES
    assert ds.imgs_com.shape == (N_FRAMES, SIZE, SIZE, 3)
    assert np.isfinite(ds.poses).all() and ds.exps.shape == (N_FRAMES, 64)
    assert len(ds.i_train) + len(ds.i_val) == N_FRAMES


def test_cli_process_then_train_legacy_config(dag, monkeypatch, capsys):
    """`cli process --step 9` on the port's directory rewrites the manifests
    and config txts; `cli train --legacy-config` then trains with their
    near/far (the training loop is replaced by a probe of its config)."""
    from dfanerf_torch import cli
    from dfanerf_torch.config import parse_legacy_config_file
    import dfanerf_torch.train.loop as loop

    legacy = os.path.join(dag["port"], "HeadNeRF_config_ba.txt")
    os.remove(legacy)
    cli.main(["process", "--id-dir", dag["port"], "--step", "9", "--dst-size", str(SIZE),
              "--device", "cpu"])
    assert "[process:ba] step 9 done" in capsys.readouterr().out
    near, far = parse_legacy_config_file(legacy)
    seen = {}
    monkeypatch.setattr(loop, "train_loop", lambda cfg, ds, **kw: seen.update(
        near=cfg.render.near, far=cfg.render.far, n=ds.n_frames))
    cli.main(["train", "--datadir", dag["port"], "--aud-file", "chain_aud.pt", "--exp-file",
              "chain_64_32.pt", "--legacy-config", legacy, "--device", "cpu", "--n-iters", "1"])
    assert seen == {"near": near, "far": far, "n": N_FRAMES}
    assert (near, far) != (0.3, 0.9)


def test_nonba_step_6(dag, tmp_path):
    """The non-BA variant's step 6 (track_params.pt, trans / 10,
    transforms_{train,val}.json, testskip len(val) // 7): the port's
    run_nonba(steps=[6]) on a copy of its directory (TRACK_ITERS fit
    steps), and both packages' transforms step on the same
    track_params.pt."""
    import shutil

    from dfanerf_torch.pipeline.driver import PipelineDriver as PortDriver
    from dfanerf_tpu.pipeline.driver import PipelineAssets, PipelineDriver as RefDriver

    dirs = {}
    for name in ("port", "ref"):
        dirs[name] = str(tmp_path / name / "chain")
        shutil.copytree(dag["port"], dirs[name])
    port = PortDriver(dirs["port"], dag["assets"], dst_size=SIZE, device="cpu")
    port.step_track = functools.partial(port.step_track, n_iters=TRACK_ITERS)
    port.run_nonba(None, steps=[6])
    shutil.copy(os.path.join(dirs["port"], "track_params.pt"), dirs["ref"])
    near_far = RefDriver(dirs["ref"], PipelineAssets(**vars(dag["assets"])),
                         dst_size=SIZE).step_transforms_nonba()
    for split in ("train", "val"):
        with open(os.path.join(dirs["port"], f"transforms_{split}.json")) as f:
            got = json.load(f)
        with open(os.path.join(dirs["ref"], f"transforms_{split}.json")) as f:
            want = json.load(f)
        assert [fr["img_id"] for fr in got["frames"]] == [fr["img_id"] for fr in want["frames"]]
        np.testing.assert_allclose([fr["transform_matrix"] for fr in got["frames"]],
                                   [fr["transform_matrix"] for fr in want["frames"]], rtol=1e-5,
                                   atol=1e-6)
    with open(os.path.join(dirs["port"], "HeadNeRF_config.txt")) as f:
        lines = f.read().splitlines()
    np.testing.assert_allclose([float(ln.split(" = ")[1]) for ln in lines[3:5]], near_far,
                               rtol=1e-5)
    assert lines[5] == "testskip = 1"
    trans = _pt(os.path.join(dirs["port"], "track_params.pt"), "trans")
    np.testing.assert_allclose(near_far[0], -(trans[:, 2] / 10.0).mean() - 0.2, rtol=1e-5)


def test_ffmpeg_steps(tmp_path):
    """Steps -1, 0 and 1 shell out to ffmpeg: re-encode a 1 s test video
    to 25 fps, extract its 16 kHz wav and read its frames at dst_size."""
    import shutil
    import subprocess

    if shutil.which("ffmpeg") is None:
        pytest.skip("ffmpeg is not on the PATH: steps -1, 0 and 1 need it")
    from dfanerf_torch.pipeline.driver import PipelineDriver

    src = str(tmp_path / "src.mp4")
    subprocess.run(["ffmpeg", "-y", "-f", "lavfi", "-i", "testsrc=size=96x96:rate=30",
                    "-f", "lavfi", "-i", "sine=frequency=440:sample_rate=44100", "-t", "1",
                    "-pix_fmt", "yuv420p", src], check=True, capture_output=True)
    d = PipelineDriver(str(tmp_path / "vid"), dst_size=64, device="cpu")
    video = d.ba_steps(None, src)[-1]()
    wav = d.step_audio(video)
    assert os.path.getsize(wav) > 16000
    assert d.step_frames(video) == 25
    assert _read(os.path.join(d.id_dir, "ori_imgs", "000000.jpg")).shape == (64, 64, 3)
