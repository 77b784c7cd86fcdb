"""Preprocessing pipeline driver: video -> training-ready identity
directory (port of dfanerf_tpu/pipeline/driver.py).

One in-process DAG over the reference's on-disk contract (SURVEY.md §2.5):

    step -1  re-encode the source video to 25 fps            (ffmpeg)
    step 0   extract 16 kHz wav + DeepSpeech features        (ffmpeg + DeepSpeech)
    step 1   extract frames, resize to dst_size^2            (cv2)
    step 2   detect 68 landmarks + head pose -> .lms files   (BlazeFace + HRNet + eye net)
    step 3   face parsing -> parsing/{:06d}.png              (BiSeNet)
    step 4   background extraction -> bc.jpg
    step 5   head/com/mask composition
    step 6   dense flow + rigid keypoint tracks              (RAFT-small)
    step 7   3DMM landmark fitting -> track_params_ba.pt     (batched focal sweep)
    step 8   bundle adjustment -> bundle_adjustment.pt
    step 9   transforms_{train,val}_ba.json + config txts
    step 10  expression disentanglement -> {id}_64_32.pt
    step 11  wav2exp features -> {id}_aud.pt

The nets, the tracker and bundle adjustment run on the driver's device
(CUDA unless ``device`` says otherwise); image IO, crops, optical-flow
stabilisation, PnP, the Kalman filters, the background and the keypoint
mining run on the host in numpy and OpenCV, as in the reference. Model
weights are external assets (``PipelineAssets``): a checkpoint path, or
``random:<seed>`` for seeded weights. A step whose asset is missing
raises. The ``.pt`` handoffs are ``torch.save`` dicts of tensors, which
data/dataset.py reads.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import subprocess
from glob import glob
from typing import Optional

import numpy as np
import torch

from dfanerf_torch.device import resolve_device

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
# frames a net call in steps 2, 3 and 6 (the reference calls each net per
# frame; each frame's maths is its own)
NET_BATCH = 16
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclasses.dataclass
class PipelineAssets:
    """Paths to external pretrained weights and bases (the reference's
    blobs), or ``random:<seed>`` for a net's seeded weights or a small
    seeded 3DMM."""

    blazeface_pth: Optional[str] = None
    hrnet_pth: Optional[str] = None
    eye_pth: Optional[str] = None
    bisenet_pth: Optional[str] = None
    raft_pth: Optional[str] = None
    deepspeech_npz: Optional[str] = None
    wav2exp_pth: Optional[str] = None
    disentangle_dir: Optional[str] = None  # holds dis_ckpt.pth / cat_ckpt.pth
    face3dmm_dir: Optional[str] = None
    pose_model_txt: Optional[str] = None


def _need(ok, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _imread(path):
    import cv2

    img = cv2.imread(path)
    return img[..., ::-1].copy()  # BGR -> RGB


def _imwrite(path, rgb):
    import cv2

    cv2.imwrite(path, np.asarray(rgb)[..., ::-1])


def _torch_save(obj, path):
    """A dict of arrays (or one array) as a ``torch.save`` of tensors."""
    if isinstance(obj, dict):
        obj = {k: torch.as_tensor(np.asarray(v)) for k, v in obj.items()}
    else:
        obj = torch.as_tensor(np.asarray(obj))
    torch.save(obj, path)


def _valid_img_ids(id_dir):
    lms = sorted(glob(os.path.join(id_dir, "ori_imgs", "*.lms")))
    return [int(os.path.basename(p).split(".")[0]) for p in lms]


class PipelineDriver:
    def __init__(self, id_dir: str, assets: PipelineAssets = PipelineAssets(),
                 dst_size: int = 512, device=None):
        self.device = resolve_device(device)
        self.id_dir = id_dir
        self.id = os.path.basename(os.path.normpath(id_dir))
        self.assets = assets
        self.dst_size = dst_size
        for sub in ("ori_imgs", "parsing", "com_imgs", "head_imgs", "face_mask", "flow_result"):
            os.makedirs(os.path.join(id_dir, sub), exist_ok=True)

    def _path(self, *parts):
        return os.path.join(self.id_dir, *parts)

    # -- steps -------------------------------------------------------------

    def step_reencode(self, src_video: str):
        out = self._path(f"{self.id}_25fps.mp4")
        subprocess.run(["ffmpeg", "-y", "-i", src_video, "-r", "25", out],
                       check=True, capture_output=True)
        return out

    def step_audio(self, video: str, video_fps: float = 25.0):
        wav_path = self._path("aud.wav")
        subprocess.run(["ffmpeg", "-y", "-i", video, "-f", "wav", "-ar", "16000", wav_path],
                       check=True, capture_output=True)
        if self.assets.deepspeech_npz:
            from scipy.io import wavfile

            from dfanerf_torch.pipeline.audio.deepspeech import (
                deepspeech_features_from_wav, load_deepspeech_npz,
            )

            sr, wav = wavfile.read(wav_path)
            net = load_deepspeech_npz(self.assets.deepspeech_npz, self.device)
            windows = deepspeech_features_from_wav(net, wav.astype(np.float32), sr, video_fps)
            np.save(self._path("aud.npy"), windows)
        return wav_path

    def step_frames(self, video: str):
        import cv2

        cap = cv2.VideoCapture(video)
        i = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frame = cv2.resize(frame, (self.dst_size, self.dst_size))
            cv2.imwrite(self._path("ori_imgs", f"{i:06d}.jpg"), frame)
            i += 1
        cap.release()
        return i

    @torch.no_grad()
    def step_landmarks(self, smooth_lms: bool = True, score_thresh: float = 0.3,
                       use_optical_flow: bool = True):
        """The shipped step-2 stack (demo_face_eye_detectPerframe_save.py
        with process_data_ba.py:166-177's flags --face_type 300W
        --eye_heatmap_decode --use_optical_flow):

        BlazeFace detect (128x128 input) -> bbox2cs affine crop 256x256 ->
        HRNet heatmaps -> gaussian-modulated decode (:770-775, sigma 2.0) ->
        landmark-score QA (:777-779: a low-score frame gets NO .lms and is
        listed) -> inverse affine to frame coords -> LK optical-flow
        stabilisation (:823-850, a tracked point kept at ||d|| < 4 px) ->
        GhostNet eye landmarks on pts2cs eye crops (:854-943) with their own
        LK pass -> EPnP head pose + per-scalar Kalman stabilisers (:965-977)
        -> {:06d}.lms + pose pkl dicts (:1059-1076). A frame without a
        detection gets a zero-landmark placeholder so frame ids stay dense
        (:660-690). Jaw-only Gaussian smoothing then runs over ALL written
        .lms files, placeholders included (process_data_ba.py:186-199).
        The counts are in ``self.last_landmarks``.
        """
        import cv2

        from dfanerf_torch.models.perception.blazeface import generate_anchors, load_blazeface
        from dfanerf_torch.models.perception.hrnet import load_hrnet
        from dfanerf_torch.pipeline.affine import affine_transform_pts
        from dfanerf_torch.pipeline.filters import lk_stabilize
        from dfanerf_torch.pipeline.pose import KalmanStabilizer, PoseEstimator
        from dfanerf_torch.pipeline.steps import landmark_gaussian_smooth

        _need(self.assets.blazeface_pth and self.assets.hrnet_pth,
              "step 2 needs blazeface_pth and hrnet_pth assets")
        bf = load_blazeface(self.assets.blazeface_pth, device=self.device)
        anchors = generate_anchors()
        hr = load_hrnet(self.assets.hrnet_pth, device=self.device)
        eye = None
        if self.assets.eye_pth:
            from dfanerf_torch.models.perception.ghostnet_eye import load_eye_net

            eye = load_eye_net(self.assets.eye_pth, device=self.device)
        paths = sorted(glob(self._path("ori_imgs", "*.jpg")))
        est = PoseEstimator((self.dst_size, self.dst_size), self.assets.pose_model_txt)
        # 6 scalar Kalman stabilisers over [r_vec, t_vec]
        # (demo...save.py:596-601: state 2, measure 1, q=0.3, r=18.1)
        stabs = [KalmanStabilizer(state_num=2, measure_num=1, cov_process=0.3, cov_measure=18.1)
                 for _ in range(6)]
        pkl_dir = self._path("pose_pkl")
        os.makedirs(pkl_dir, exist_ok=True)
        prev_gray = prev_lms = prev_eyes = None
        low_score = []
        no_face = []
        poses = {}
        for counter, img, hit in self._detect_and_landmark(paths, bf, anchors, hr):
            if hit is None:
                # dense-frame contract: zero-landmark placeholder (:660-690)
                np.savetxt(self._path("ori_imgs", f"{counter:06d}.lms"),
                           np.zeros((68, 2), np.float32), "%f")
                no_face.append(counter)
                continue  # LK chain resumes from the last good frame
            preds, trans_inv, score = hit
            if score < score_thresh:
                # low-score QA (:777-793): record, no .lms for this frame
                low_score.append([counter, score])
                continue
            lms = affine_transform_pts(preds, trans_inv)
            gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
            if use_optical_flow and prev_gray is not None:
                lms = lk_stabilize(prev_gray, gray, prev_lms, lms)
            lms = lms.astype(np.float32)
            eye_lms = None
            if eye is not None:
                eye_lms = self._eye_landmarks(eye, img, lms)
                if use_optical_flow and prev_gray is not None and prev_eyes is not None:
                    eye_lms = lk_stabilize(prev_gray, gray, prev_eyes, eye_lms)
                np.savetxt(self._path("ori_imgs", f"{counter:06d}.eye"), eye_lms, "%f")
            # EPnP pose on the stabilised 68 + Kalman smoothing (:952-977)
            r_vec, t_vec = est.solve_pose_by_68_points(lms)
            rot, _ = cv2.Rodrigues(r_vec)
            pose_mat = np.hstack([rot, t_vec.reshape(3, 1)])
            pose_np = np.concatenate([r_vec.reshape(-1), t_vec.reshape(-1)])
            steady = []
            for v, s in zip(pose_np, stabs):
                s.update([v])
                steady.append(float(s.state[0, 0]))
            steady_pose = np.reshape(np.asarray(steady, np.float64), (-1, 3))
            with open(os.path.join(pkl_dir, f"{counter:06d}.pkl"), "wb") as f:
                pickle.dump({"pose_mat": pose_mat, "pose_np": pose_np, "steady_pose": steady_pose,
                             "face_landmarks_show": np.vstack([lms[:36], lms[48:]])}, f)
            poses[counter] = est.pose_to_matrix(r_vec, t_vec)
            np.savetxt(self._path("ori_imgs", f"{counter:06d}.lms"), lms, "%f")
            prev_gray, prev_lms, prev_eyes = gray, lms, eye_lms
        if low_score:
            np.savetxt(self._path("low_score_frames.txt"), np.asarray(low_score), "%f")
        if smooth_lms:
            # jaw-only Gaussian smoothing over every written .lms file,
            # zero placeholders included (process_data_ba.py:186-199)
            lms_paths = sorted(glob(self._path("ori_imgs", "*.lms")))
            arr = np.stack([np.loadtxt(q).astype(np.float32) for q in lms_paths])
            arr = landmark_gaussian_smooth(arr, 1.5, area="only_jaw")
            for q, sm in zip(lms_paths, arr):
                np.savetxt(q, sm, "%f")
        self.last_landmarks = {"frames": len(paths), "detected": len(paths) - len(no_face),
                               "no_face": len(no_face), "low_score": len(low_score),
                               "with_lms": len(poses), "eyes": len(poses) if eye else 0}
        return poses

    def _detect_and_landmark(self, paths, bf, anchors, hr):
        """Per frame, in order: (counter, RGB image, None) where BlazeFace
        finds no face, else (counter, image, (68 HRNet landmarks in the
        256x256 crop's pixels, the crop's inverse affine, the landmark
        score)). BlazeFace (128x128 input), the bbox2cs crops, HRNet and
        the gaussian-modulated decode (:770-775, sigma 2.0) run on
        NET_BATCH frames a call."""
        import cv2

        from dfanerf_torch.models.perception.blazeface import detect_faces
        from dfanerf_torch.pipeline.affine import bbox2cs, crop_affine, get_affine_transform
        from dfanerf_torch.pipeline.heatmaps import decode_heatmaps

        for start in range(0, len(paths), NET_BATCH):
            chunk = paths[start:start + NET_BATCH]
            imgs = [_imread(p) for p in chunk]
            dets = detect_faces(bf, anchors, np.stack([cv2.resize(im, (128, 128)) for im in imgs]))
            crops, invs, found = [], [], {}
            for k, (img, det) in enumerate(zip(imgs, dets)):
                if len(det):
                    y0, x0, y1, x1 = det[0, :4] * 128.0
                    scale_ratio = max(img.shape[:2]) / 128.0
                    center, scale = bbox2cs(np.array([x0, y0, x1, y1]) * scale_ratio)
                    crop = crop_affine(img, center, scale, (256, 256))
                    crops.append((crop.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD)
                    invs.append((k, get_affine_transform(center, scale, 0, (256, 256), inv=1)))
            if crops:
                hm = hr(torch.from_numpy(np.stack(crops)).to(self.device).permute(0, 3, 1, 2))
                coords, maxvals = decode_heatmaps(hm, sigma=2.0)
                coords = coords.cpu().numpy().astype(np.float64) * 4.0  # heatmap 64 -> 256
                scores = maxvals.mean(dim=(1, 2)).cpu().numpy()
                found = {k: (coords[j], inv, float(scores[j])) for j, (k, inv) in enumerate(invs)}
            for k, p in enumerate(chunk):
                yield int(os.path.basename(p).split(".")[0]), imgs[k], found.get(k)

    def _eye_landmarks(self, eye_net, img, lms):
        """GhostNet 6-keypoint eye landmarks on pts2cs crops, 300W indices
        (demo...save.py:264-330, 854-943): the left eye from lms 42:48, the
        right from 36:42, scale x1.35, 48x32 grey crops, heatmap decode
        without Gaussian modulation (the eye cfg's HEATMAP_DM is false), x2
        to crop coords, inverse affine back. Returns [12, 2] (left 6, then
        right 6)."""
        import cv2

        from dfanerf_torch.pipeline.affine import (
            affine_transform_pts, crop_affine, get_affine_transform, pts2cs,
        )
        from dfanerf_torch.pipeline.heatmaps import decode_heatmaps

        out = []
        for sl in (slice(42, 48), slice(36, 42)):
            center, scale = pts2cs(lms[sl])
            scale = scale * 1.35
            crop = crop_affine(img, center, scale, (48, 32))
            gray = cv2.cvtColor(crop, cv2.COLOR_RGB2GRAY).astype(np.float32) / 255.0
            hmap = eye_net(torch.from_numpy(gray[None, None]).to(self.device))
            coords, _ = decode_heatmaps(hmap, modulate=False)
            pts = coords[0].cpu().numpy().astype(np.float64) * 2.0  # heatmap 24x16 -> 48x32
            trans_inv = get_affine_transform(center, scale, 0, (48, 32), inv=1)
            out.append(affine_transform_pts(pts, trans_inv))
        return np.concatenate(out).astype(np.float32)

    @torch.no_grad()
    def step_parsing(self):
        """BiSeNet's main head, argmax per pixel, as the reference's colour
        map (face_parsing/test.py:31-50): head classes red, neck green, body
        blue, the rest white; NET_BATCH frames a call. The head pixel counts
        are in ``self.last_parsing``."""
        from dfanerf_torch.models.perception.bisenet import load_bisenet

        _need(self.assets.bisenet_pth, "step 3 needs bisenet_pth")
        net = load_bisenet(self.assets.bisenet_pth, device=self.device)
        colors = np.full((19, 3), 255, np.uint8)
        for c in range(1, 14):
            colors[c] = (255, 0, 0)
        colors[14] = (0, 255, 0)
        colors[16] = (0, 0, 255)
        colors[17] = (255, 0, 0)
        head_pixels = []
        paths = sorted(glob(self._path("ori_imgs", "*.jpg")))
        for start in range(0, len(paths), NET_BATCH):
            chunk = paths[start:start + NET_BATCH]
            x = np.stack([(_imread(p).astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
                          for p in chunk])
            out, _, _ = net(torch.from_numpy(x).to(self.device).permute(0, 3, 1, 2))
            for p, classes in zip(chunk, out.argmax(dim=1).cpu().numpy()):
                rgb = colors[classes]
                head_pixels.append(int(((rgb[..., 0] == 255) & (rgb[..., 1] == 0)).sum()))
                _imwrite(self._path("parsing", os.path.basename(p).replace(".jpg", ".png")), rgb)
        self.last_parsing = {"frames": len(head_pixels), "head_pixels": head_pixels}

    def step_background(self, every: int = 20):
        from dfanerf_torch.pipeline.steps import extract_background

        ids = _valid_img_ids(self.id_dir)[::every]
        parsing = np.stack([_imread(self._path("parsing", f"{i:06d}.png")) for i in ids])
        ori = np.stack([_imread(self._path("ori_imgs", f"{i:06d}.jpg")) for i in ids])
        bc = extract_background(parsing, ori)
        _imwrite(self._path("bc.jpg"), bc)
        return bc

    def step_compose(self):
        from dfanerf_torch.pipeline.steps import compose_training_images

        bc = _imread(self._path("bc.jpg"))
        for i in _valid_img_ids(self.id_dir):
            ori = _imread(self._path("ori_imgs", f"{i:06d}.jpg"))
            parsing = _imread(self._path("parsing", f"{i:06d}.png"))
            com, head, mask = compose_training_images(ori, parsing, bc)
            _imwrite(self._path("com_imgs", f"{i:06d}.jpg"), com)
            _imwrite(self._path("head_imgs", f"{i:06d}.jpg"), head)
            _imwrite(self._path("face_mask", f"{i:06d}.png"), mask)

    def step_flow(self, ref_id: int = 18, crop_hw=(320, 240)):
        """Dense flow ref -> frame with the UNFaceFlow test_flow contract
        (test_flow.py:88-104, network_test_flow.py:73-104): source and
        target cropped to their face-mask bboxes (+-10 px, masked colour),
        RAFT on the 320x240 crops, the flow rescaled and un-cropped into
        the source rect of the full frame, multiplied by the source mask.
        RAFT runs on NET_BATCH frames a call. Then rigid-keypoint mining
        and tracking (process_data_ba.py:289-372).
        """
        from dfanerf_torch.models.perception.raft import flow_on_crops, load_raft_small, mask_crop
        from dfanerf_torch.pipeline.steps import (
            flow_stability_map, mine_rigid_keypoints, track_keypoints,
        )

        _need(self.assets.raft_pth, "step 6 needs raft_pth")
        net = load_raft_small(self.assets.raft_pth, device=self.device)
        ids = _valid_img_ids(self.id_dir)
        ref = _imread(self._path("ori_imgs", f"{ref_id:06d}.jpg"))
        ref_mask_img = _imread(self._path("face_mask", f"{ref_id:06d}.png"))
        src_mask = ref_mask_img[..., 0] != 0
        h, w = ref.shape[:2]
        src_crop, rect_s = mask_crop(ref, src_mask, crop_hw)
        flows = []
        for start in range(0, len(ids), NET_BATCH):
            chunk = ids[start:start + NET_BATCH]
            tar_crops, crop_params = [], []
            for i in chunk:
                tgt = _imread(self._path("ori_imgs", f"{i:06d}.jpg"))
                tgt_mask = _imread(self._path("face_mask", f"{i:06d}.png"))[..., 0] != 0
                tar_crop, rect_t = mask_crop(tgt, tgt_mask, crop_hw)
                tar_crops.append(tar_crop)
                crop_params.append([*rect_s, *rect_t])
            flow_full = flow_on_crops(net, np.repeat(src_crop[None], len(chunk), 0),
                                      np.stack(tar_crops), np.array(crop_params, np.int32), (h, w))
            for i, ff in zip(chunk, flow_full):
                # the flow masked by the SOURCE mask (test_flow.py predict():101-103)
                f = (ff * src_mask[..., None]).transpose(2, 0, 1).astype(np.float32)
                flows.append(f)
                np.save(self._path("flow_result", f"{ref_id:06d}_{i:06d}.npy"), f)
        rigid_mask = ref_mask_img[..., 0] > 250
        rigid = np.stack([f[:, rigid_mask] for f in flows])
        stab = flow_stability_map(rigid, rigid_mask, h, w)
        key_xys = mine_rigid_keypoints(stab)
        np.savetxt(self._path("keypoints.txt"), key_xys, "%d")
        track = track_keypoints(flows, key_xys)
        np.save(self._path("track_xys.npy"), track)
        return track

    def _face3dmm(self):
        from dfanerf_torch.pipeline.face3dmm import load_face3dmm, make_synthetic_3dmm

        _need(self.assets.face3dmm_dir, "step 7 needs face3dmm_dir")
        spec = self.assets.face3dmm_dir
        if spec.startswith("random:"):
            return make_synthetic_3dmm(int(spec.split(":", 1)[1] or 0), device=self.device), 20, 12
        return load_face3dmm(spec, device=self.device), 100, 79

    def step_track(self, n_iters: int = 2000, out_name: str = "track_params_ba.pt"):
        """The 3DMM fit to the landmarks; the winning focal and the loss are
        in ``self.last_track``."""
        from dfanerf_torch.pipeline.tracking import fit_landmarks

        model, id_dim, exp_dim = self._face3dmm()
        ids = _valid_img_ids(self.id_dir)
        lms = np.stack([np.loadtxt(self._path("ori_imgs", f"{i:06d}.lms")) for i in ids])
        params, loss = fit_landmarks(model, lms.astype(np.float32),
                                     (self.dst_size / 2.0, self.dst_size / 2.0), n_iters=n_iters,
                                     id_dim=id_dim, exp_dim=exp_dim)
        _torch_save({k: getattr(params, k).cpu().numpy()
                     for k in ("id", "exp", "euler", "trans", "focal")}, self._path(out_name))
        self.last_track = {"focal": float(params.focal[0]), "loss": loss}
        return loss

    def step_bundle_adjust(self):
        """Bundle adjustment of the tracked poses against the keypoint
        tracks; its losses are in ``self.last_ba``."""
        from dfanerf_torch.data.dataset import _load_pt_or_npy
        from dfanerf_torch.pipeline.tracking import bundle_adjust

        base = self._path("track_params_ba.pt")
        euler = _load_pt_or_npy(base, "euler")
        trans = _load_pt_or_npy(base, "trans") / 1000.0
        focal = _load_pt_or_npy(base, "focal")
        track = np.load(self._path("track_xys.npy"))
        out = bundle_adjust(track, torch.from_numpy(euler).to(self.device),
                            torch.from_numpy(trans).to(self.device), torch.tensor(focal[0]),
                            (self.dst_size / 2.0, self.dst_size / 2.0))
        _torch_save({"euler": out["euler"].cpu().numpy(), "trans": out["trans"].cpu().numpy(),
                     "focal": focal}, self._path("bundle_adjustment.pt"))
        self.last_ba = {"loss_pts": out["loss_pts"], "loss": out["loss"],
                        "keypoints": int(track.shape[1])}

    def _write_transforms(self, base_name: str, trans_div: float, suffix: str, cfg_extra):
        from dfanerf_torch.data.dataset import _load_pt_or_npy
        from dfanerf_torch.pipeline.steps import build_transforms

        base = self._path(base_name)
        euler = _load_pt_or_npy(base, "euler")
        trans = _load_pt_or_npy(base, "trans")
        if trans_div != 1.0:
            trans = trans / trans_div
        focal = _load_pt_or_npy(base, "focal")
        ids = _valid_img_ids(self.id_dir)
        lms = [np.loadtxt(self._path("ori_imgs", f"{i:06d}.lms")) for i in ids]
        train, val, near, far = build_transforms(euler, trans, float(focal.reshape(-1)[0]), lms,
                                                 ids, self.dst_size, self.dst_size)
        for name, obj in (("train", train), ("val", val)):
            with open(self._path(f"transforms_{name}{suffix}.json"), "w") as f:
                json.dump(obj, f, indent=2, separators=(",", ": "))
        for cfg_name, exp_suffix, extra in cfg_extra(val):
            with open(self._path(cfg_name), "w") as f:
                f.write(f"expname = {self.id}{exp_suffix}\n")
                f.write(f"datadir = {os.path.abspath(self.id_dir)}\n")
                f.write(f"basedir = {os.path.abspath(self.id_dir)}/logs\n")
                f.write(f"near = {near}\n")
                f.write(f"far = {far}\n")
                f.write(f"{extra}\n")
        return near, far

    def step_transforms(self):
        """Step 9: transforms_{train,val}_ba.json and the BA config txts from
        bundle_adjustment.pt."""
        return self._write_transforms("bundle_adjustment.pt", 1.0, "_ba", lambda val: (
            ("HeadNeRF_config_ba.txt", "_head", "testskip = 1"),
            ("TorsoNeRF_config_ba.txt", "_com", "testskip = 1"),
            ("TorsoNeRFTest_config_ba.txt", "_com", "with_test = 1")))

    def step_transforms_nonba(self):
        """The non-BA (AD-NeRF-style) transforms step, process_data.py's step
        6 (:190-281): track_params.pt directly (no flow, no bundle
        adjustment), trans scaled by /10 (the BA path divides by 1000 at
        step 8 instead), transforms_{train,val}.json (no ``_ba`` suffix)
        and the non-BA config txts, whose testskip is len(val) // 7
        (process_data.py:246-263)."""
        def extras(val):
            testskip = max(len(val["frames"]) // 7, 1)
            return (("HeadNeRF_config.txt", "_head", f"testskip = {testskip}"),
                    ("TorsoNeRF_config.txt", "_com", f"testskip = {testskip}"),
                    ("TorsoNeRFTest_config.txt", "_com", "with_test = 1"))

        return self._write_transforms("track_params.pt", 10.0, "", extras)

    def run_nonba(self, src_video: str, steps=range(0, 7)):
        """The 7-step AD-NeRF-style pipeline (data_util/process_data.py):
        0 wav + DeepSpeech, 1 frames, 2 landmarks + pose, 3 parsing,
        4 background, 5 compose, 6 track + transforms (no flow, no bundle
        adjustment, no disentangle/wav2exp: the older dataset contract)."""
        table = self.nonba_steps(src_video)
        for s in steps:
            table[s]()

    def nonba_steps(self, video: str):
        return {
            0: lambda: self.step_audio(video),
            1: lambda: self.step_frames(video),
            2: self.step_landmarks,
            3: self.step_parsing,
            4: self.step_background,
            5: self.step_compose,
            6: lambda: (self.step_track(out_name="track_params.pt"),
                        self.step_transforms_nonba()),
        }

    def ba_steps(self, video: str, src_video: Optional[str] = None):
        return {
            -1: lambda: self.step_reencode(src_video),
            0: lambda: self.step_audio(video),
            1: lambda: self.step_frames(video),
            2: self.step_landmarks,
            3: self.step_parsing,
            4: self.step_background,
            5: self.step_compose,
            6: self.step_flow,
            7: self.step_track,
            8: self.step_bundle_adjust,
            9: self.step_transforms,
            10: self.step_disentangle,
            11: self.step_wav2exp,
        }

    def step_disentangle(self):
        from dfanerf_torch.data.dataset import _load_pt_or_npy
        from dfanerf_torch.pipeline.disentangle import disentangle_sequence, load_distangler

        _need(self.assets.disentangle_dir, "step 10 needs disentangle_dir")
        dis = load_distangler(os.path.join(self.assets.disentangle_dir, "dis_ckpt.pth"),
                              device=self.device)
        exps = _load_pt_or_npy(self._path("track_params_ba.pt"), "exp")
        _torch_save(disentangle_sequence(dis, exps), self._path(f"{self.id}_64_32.pt"))

    def step_wav2exp(self):
        from scipy.io import wavfile

        from dfanerf_torch.pipeline.audio.wav2exp import audio_encoder_from_torch, wav2exp_features

        _need(self.assets.wav2exp_pth, "step 11 needs wav2exp_pth")
        sd = torch.load(self.assets.wav2exp_pth, map_location="cpu")
        if not any(k.startswith("audio_encoder.") for k in sd):
            sd = {f"audio_encoder.{k}": v for k, v in sd.items()}
        encoder = audio_encoder_from_torch(sd, self.device)
        sr, wav = wavfile.read(self._path("aud.wav"))
        wav = wav.astype(np.float32) / 32768.0
        feats = wav2exp_features(encoder, wav).cpu().numpy()
        _torch_save(feats, self._path(f"{self.id}_aud.pt"))
        return feats
