"""The port's identity-directory loader (data/dataset.py
load_audface_dataset) against the reference package's, and the cli on an
identity directory: ``train --datadir`` and ``render --test-file``.

The directory is written here with OpenCV from the port's seeded synthetic
scene (12 frames of 24x24: 8 train, 4 val): JPEG head and composite frames
and background, the train and val manifests with and without ``_ba`` (the
plain ones' poses shifted, so the switch shows), wav2exp features as a .pt
tensor and DeepSpeech windows as .npy, expression codes as a .pt dict,
speaking intervals and a driving manifest. Each audio id is its frame's
plus one, so the last clamps. The reference decodes JPEGs with imageio,
the port with OpenCV; JPEG decoders may round differently, so the
reference's ``_imread`` is swapped for an OpenCV reader here (its file is
not touched) and every array must be equal.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import dfanerf_tpu.data.dataset as j_dataset  # noqa: E402
from dfanerf_torch import cli  # noqa: E402
from dfanerf_torch.config import ExperimentConfig, RenderConfig, TrainConfig  # noqa: E402
from dfanerf_torch.data import dataset  # noqa: E402
from dfanerf_torch.data.synthetic import make_synthetic_dataset  # noqa: E402
from dfanerf_torch.models import DecoderConfig  # noqa: E402
from dfanerf_torch.render.renderer import render_video_frames  # noqa: E402
from dfanerf_torch.train.checkpoint import load_checkpoint  # noqa: E402
from dfanerf_torch.train.state import init_train_state  # noqa: E402

N, N_TRAIN, HW = 12, 8, 24
SPEAK_TIME = np.array([[0.0, 0.2], [0.3, 0.5]], np.float32)  # frames 1-4 and 10-11 at 30 fps
NARROW = ExperimentConfig(
    decoder=DecoderConfig(hidden_size=64, n_blocks=4, skips=(2,), z_dim=32),
    render=RenderConfig(n_samples=8),
    train=TrainConfig(n_rand=64, z_dim=32, i_print=1, i_weights=2))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_rgb(path, img):
    assert cv2.imwrite(str(path), np.ascontiguousarray(img[..., ::-1]))


def _frames(ids, poses, rects, shift=0.0):
    return [{"img_id": int(i), "aud_id": int(i) + 1,
             "transform_matrix": (poses[i] + np.float32(shift)).tolist(),
             "face_rect": rects[i].tolist()} for i in ids]


@pytest.fixture(scope="module")
def identity(tmp_path_factory):
    """An identity directory in the preprocessing pipeline's layout."""
    d = tmp_path_factory.mktemp("identity")
    ds = make_synthetic_dataset(n_frames=N, H=HW, W=HW, n_samples_gt=8, device="cpu")
    rng = np.random.RandomState(0)
    (d / "head_imgs").mkdir()
    (d / "com_imgs").mkdir()
    for i in range(N):
        _write_rgb(d / "head_imgs" / f"{i:06d}.jpg", ds.imgs_head[i])
        _write_rgb(d / "com_imgs" / f"{i:06d}.jpg", ds.imgs_com[i])
    _write_rgb(d / "bc.jpg", ds.bc_img)
    rects = rng.randint(0, 12, (N, 4)).astype(np.int32)
    _, _, focal, cx, cy = ds.hwfcxy
    camera = {"focal_len": focal, "cx": cx, "cy": cy}
    for suffix, shift in (("_ba", 0.0), ("", 0.01)):
        for split, ids in (("train", range(N_TRAIN)), ("val", range(N_TRAIN, N))):
            meta = dict(camera, frames=_frames(ids, ds.poses, rects, shift))
            (d / f"transforms_{split}{suffix}.json").write_text(json.dumps(meta))
    (d / "driving.json").write_text(json.dumps(dict(camera, frames=_frames(
        [3, 7, 11, 11, 2], ds.poses, rects))))
    torch.save(torch.from_numpy(rng.randn(N, 512).astype(np.float32)), d / "aud.pt")
    np.save(d / "aud.npy", rng.randn(N, 16, 29).astype(np.float32))
    torch.save({"exp_o": torch.from_numpy(rng.randn(N, 64).astype(np.float32)),
                "exp_m": torch.from_numpy(rng.randn(N, 32).astype(np.float32))}, d / "exp.pt")
    np.save(d / "speak_time.npy", SPEAK_TIME)
    return d


def _cv2_imread(path):
    return np.ascontiguousarray(cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])


MODES = {
    "ba": {},
    "plain_manifests": dict(use_ba=False),
    "testskip": dict(testskip=2),
    "speak_time": dict(all_speaker=False),
    "max_frames": dict(max_frames=5),
    "deepspeech_no_exp": dict(aud_file="aud.npy", exp_file=None),
    "no_images": dict(load_images=False),
    "test_file": dict(test_file="driving.json", testskip=2),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_loader_matches_reference(identity, monkeypatch, mode):
    monkeypatch.setattr(j_dataset, "_imread", _cv2_imread)
    kw = dict({"aud_file": "aud.pt", "exp_file": "exp.pt"}, **MODES[mode])
    got = dataset.load_audface_dataset(str(identity), **kw)
    ref = j_dataset.load_audface_dataset(str(identity), **kw)
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    if mode == "speak_time":
        assert got.speak_frames.tolist() == [0, 1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 1]
    if mode == "test_file":
        assert got.imgs_com is None and got.n_frames == 3 and len(got.i_train) == 0


def test_frames_decode_as_opencv_reads_them(identity):
    ds = dataset.load_audface_dataset(str(identity), "aud.pt", "exp.pt")
    assert ds.imgs_com.shape == (N, HW, HW, 3) and ds.imgs_com.dtype == np.uint8
    for i in (0, N - 1):
        np.testing.assert_array_equal(
            ds.imgs_com[i], _cv2_imread(str(identity / "com_imgs" / f"{i:06d}.jpg")))
    np.testing.assert_array_equal(ds.bc_img, _cv2_imread(str(identity / "bc.jpg")))


def test_imread_names_what_it_needs(identity, monkeypatch):
    with pytest.raises(FileNotFoundError):
        dataset._imread(str(identity / "missing.jpg"))
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    with pytest.raises(ImportError, match="opencv"):
        dataset._imread(str(identity / "bc.jpg"))


def _read_ppm(path):
    raw = path.read_bytes()
    magic, w, h, _, pixels = raw.split(maxsplit=4)
    assert magic == b"P6"
    return np.frombuffer(pixels, np.uint8).reshape(int(h), int(w), 3)


def test_cli_trains_on_and_renders_an_identity(identity, tmp_path):
    """cli train --datadir (2 steps), then cli render --test-file of its
    checkpoint, on the CPU: the driving manifest's frames, equal to
    render_video_frames of the loaded manifest."""
    cfg_path = tmp_path / "narrow.json"
    raw = NARROW.to_dict()
    raw.update(basedir=str(tmp_path / "runs"), expname="id")
    cfg_path.write_text(json.dumps(raw))
    common = ["--config", str(cfg_path), "--datadir", str(identity), "--device", "cpu"]
    cli.main(["train", *common, "--aud-file", "aud.pt", "--exp-file", "exp.pt",
              "--n-iters", "2"])
    ckpt = tmp_path / "runs" / "id" / "000002.npz"
    assert ckpt.exists()
    out = tmp_path / "out"
    cli.main(["render", *common, "--ckpt", str(ckpt), "--test-file", "driving.json",
              "--out", str(out)])
    cfg = dataclasses.replace(ExperimentConfig.from_json(str(cfg_path)), datadir=str(identity))
    state = load_checkpoint(str(ckpt), init_train_state(cfg, seed=0, device="cpu"))
    assert state["step"] == 2
    drive = dataset.load_audface_dataset(str(identity), cfg.aud_file, cfg.exp_file,
                                         test_file="driving.json")
    data = {k: getattr(drive, k) for k in ("auds", "exps", "poses", "bc_img")}
    com, head = render_video_frames(state, data, cfg, drive.hwfcxy, drive.near, drive.far,
                                    range(drive.n_frames), use_smoothing=False, device="cpu")
    assert len(list((out / "render_com").iterdir())) == drive.n_frames == 5
    for i in range(drive.n_frames):
        frame = _read_ppm(out / "render_com" / f"test_{i:06d}.ppm")
        assert frame.shape == (HW, HW, 3)
        np.testing.assert_array_equal(frame, com[i])
        np.testing.assert_array_equal(_read_ppm(out / "render_head" / f"test_{i:06d}.ppm"),
                                      head[i])


def test_cli_refuses_the_legacy_config(identity, monkeypatch, tmp_path):
    """--legacy-config is ported: a legacy config txt without keys gives
    near and far by line position (lines 3 and 4, as the reference reads
    them) to the training config; a missing file is refused."""
    import dfanerf_torch.train.loop as loop

    legacy = tmp_path / "HeadNeRF_config_ba.txt"
    legacy.write_text("obama_head\ndataset/obama\ndataset/obama/logs\n0.41\n1.07\n")
    seen = {}
    monkeypatch.setattr(loop, "train_loop", lambda cfg, ds, **kw: seen.update(
        near=cfg.render.near, far=cfg.render.far))
    cli.main(["train", "--datadir", str(identity), "--legacy-config", str(legacy),
              "--device", "cpu"])
    assert seen == {"near": 0.41, "far": 1.07}
    with pytest.raises(FileNotFoundError):
        cli.main(["train", "--datadir", str(identity), "--legacy-config", "x.txt",
                  "--device", "cpu"])
