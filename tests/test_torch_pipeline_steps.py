"""The preprocessing DAG's array steps against the reference on the CPU:
the heatmap decode, the affine crop geometry, the core/geometry.py
rotations and projection, the transforms of step 9, the landmark
smoothing, background and composition, the flow stability map, keypoint
mining and tracking, the mask crop, the LK stabilisation and the pose
filters. Inputs are numpy-seeded; each tolerance is stated where it is
used (1e-5 for float results; integer and image results exactly)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dfanerf_torch.core import geometry as pg
from dfanerf_torch.models.perception import raft as prf
from dfanerf_torch.pipeline import affine as paf
from dfanerf_torch.pipeline import filters as pfl
from dfanerf_torch.pipeline import heatmaps as phm
from dfanerf_torch.pipeline import pose as pps
from dfanerf_torch.pipeline import steps as pst
from dfanerf_tpu.core import geometry as jg
from dfanerf_tpu.models.perception import raft as jrf
from dfanerf_tpu.pipeline import affine as jaf
from dfanerf_tpu.pipeline import filters as jfl
from dfanerf_tpu.pipeline import heatmaps as jhm
from dfanerf_tpu.pipeline import pose as jps
from dfanerf_tpu.pipeline import steps as jst

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch single-threaded for this module: its inputs are small, and the
    intra-op threads of six suite workers on a few cores cost more than they
    save."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _heatmaps(seed, n=2, k=5, h=16, w=24):
    """Smooth peaked maps with ties, flat maps and border peaks."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[:h, :w]
    hm = np.zeros((n, k, h, w), np.float32)
    for i in range(n):
        for j in range(k):
            cy, cx = rng.uniform(-1, h), rng.uniform(-1, w)
            hm[i, j] = np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / 6.0) * rng.uniform(0.2, 1.2)
    hm += rng.randn(n, k, h, w).astype(np.float32) * 0.01
    hm[0, 1] = 0.5            # a flat map: the first maximum wins
    hm[1, 2] = -0.25          # max <= 0: the coords are zeroed
    hm[0, 3, 0, 5] = 3.0      # a peak on the border: no quarter step
    return hm


@pytest.mark.parametrize("sigma,modulate", [(2.0, True), (1.5, True), (None, False)])
def test_decode_heatmaps(sigma, modulate):
    """Modulation (odd 13-tap and even 10-tap kernels), argmax with the first
    maximum, the quarter-pixel step with sign(0) = 0 and the border guard."""
    hm = _heatmaps(0)
    kw = {"modulate": modulate} | ({"sigma": sigma} if sigma else {})
    c, v = phm.decode_heatmaps(torch.from_numpy(hm), **kw)
    jc, jv = jhm.decode_heatmaps(jnp.asarray(hm.transpose(0, 2, 3, 1)), **kw)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    if modulate:
        m = phm.gaussian_modulation(torch.from_numpy(hm), sigma)
        jm = jhm.gaussian_modulation(jnp.asarray(hm.transpose(0, 2, 3, 1)), sigma)
        np.testing.assert_allclose(m.permute(0, 2, 3, 1).numpy(), np.asarray(jm), rtol=TOL,
                                   atol=TOL)


def test_affine_geometry():
    """bbox2cs, pts2cs, the 3-point transform and its inverse, the warp and
    the point transform."""
    rng = np.random.RandomState(1)
    img = rng.randint(0, 255, (96, 128, 3)).astype(np.uint8)
    for _ in range(4):
        x0, y0 = rng.uniform(0, 60, 2)
        box = np.array([x0, y0, x0 + rng.uniform(10, 60), y0 + rng.uniform(10, 40)], np.float32)
        c, s = paf.bbox2cs(box)
        jc, js = jaf.bbox2cs(box)
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(s, js)
        pts = rng.uniform(10, 80, (6, 2)).astype(np.float32)
        np.testing.assert_array_equal(paf.pts2cs(pts)[1], jaf.pts2cs(pts)[1])
        for inv in (0, 1):
            np.testing.assert_array_equal(paf.get_affine_transform(c, s, 0, (48, 32), inv=inv),
                                          jaf.get_affine_transform(c, s, 0, (48, 32), inv=inv))
        np.testing.assert_array_equal(paf.crop_affine(img, c, s, (48, 32)),
                                      jaf.crop_affine(img, c, s, (48, 32)))
        t = paf.get_affine_transform(c, s, 0, (48, 32), inv=1)
        np.testing.assert_array_equal(paf.affine_transform_pts(pts.astype(np.float64), t),
                                      jaf.affine_transform_pts(pts.astype(np.float64), t))


def test_geometry_rotation_and_projection():
    """euler2rot, rot_trans_pts, proj_pts (scalar and per-batch focal) and
    forward_transform at 1e-5."""
    rng = np.random.RandomState(2)
    euler = rng.uniform(-np.pi, np.pi, (6, 3)).astype(np.float32)
    pts = rng.randn(6, 11, 3).astype(np.float32)
    trans = (rng.randn(6, 3) + np.array([0, 0, -5])).astype(np.float32)
    cxy = np.array([64.0, 48.0], np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(pg.euler2rot(t(euler)).numpy(),
                               np.asarray(jg.euler2rot(jnp.asarray(euler))), rtol=TOL, atol=TOL)
    for focal in (np.float32(900.0), rng.uniform(500, 1500, 6).astype(np.float32)):
        got = pg.forward_transform(t(pts), t(euler), t(trans), torch.as_tensor(focal), t(cxy))
        want = jg.forward_transform(jnp.asarray(pts), jnp.asarray(euler), jnp.asarray(trans),
                                    jnp.asarray(focal), jnp.asarray(cxy))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    # rot_to_euler's signed zeros at the zero matrix stay the reference's
    got = pg.rot_to_euler(torch.zeros(1, 3, 3))
    want = np.asarray(jg.rot_to_euler(jnp.zeros((1, 3, 3))))
    np.testing.assert_array_equal(torch.signbit(got).numpy(), np.signbit(want))
    np.testing.assert_array_equal(got.numpy(), want)


def test_build_transforms_and_smoothing():
    """Step 9's manifests (the 10/11 split, face rects, near/far = mean z
    -0.2 / +0.4) at 1e-5, and the jaw-only landmark smoothing at 1e-5."""
    rng = np.random.RandomState(3)
    n = 23
    euler = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    trans = (rng.randn(n, 3) * 0.05 + np.array([0, 0, -0.6])).astype(np.float32)
    lms = [rng.uniform(100, 400, (68, 2)) for _ in range(n)]
    ids = list(range(2, 2 + n))
    got = pst.build_transforms(euler, trans, 1100.0, lms, ids, 512, 512)
    want = jst.build_transforms(euler, trans, 1100.0, lms, ids, 512, 512)
    for g, w in zip(got[:2], want[:2]):
        assert len(g["frames"]) == len(w["frames"])
        assert (g["focal_len"], g["cx"], g["cy"]) == (w["focal_len"], w["cx"], w["cy"])
        for fg, fw in zip(g["frames"], w["frames"]):
            assert (fg["img_id"], fg["aud_id"], fg["face_rect"]) == (
                fw["img_id"], fw["aud_id"], fw["face_rect"])
            np.testing.assert_allclose(fg["transform_matrix"], fw["transform_matrix"], rtol=TOL,
                                       atol=TOL)
    assert len(got[0]["frames"]) == int(n * 10 / 11)
    np.testing.assert_allclose(got[2:], want[2:], rtol=TOL, atol=TOL)
    seq = np.stack(lms).astype(np.float32)
    for area in ("only_jaw", "wo_mouth", "all"):
        np.testing.assert_allclose(pst.landmark_gaussian_smooth(seq, 1.5, area),
                                   jst.landmark_gaussian_smooth(seq, 1.5, area), rtol=TOL,
                                   atol=TOL)


def _parsing(rng, h, w):
    """A colour parsing map: white background, a red head blob, a green neck."""
    p = np.full((h, w, 3), 255, np.uint8)
    ys, xs = np.mgrid[:h, :w]
    cy, cx = rng.uniform(h * 0.3, h * 0.5), rng.uniform(w * 0.4, w * 0.6)
    p[((ys - cy) ** 2 + (xs - cx) ** 2) < (h * 0.2) ** 2] = (255, 0, 0)
    p[(ys > cy + h * 0.2) & (abs(xs - cx) < w * 0.08)] = (0, 255, 0)
    return p


def test_background_compose_and_keypoints():
    """Steps 4, 5 and 6's host half: background, composition, the stability
    map, keypoint mining and tracking, exactly."""
    rng = np.random.RandomState(4)
    h, w, s = 48, 64, 4
    parsing = np.stack([_parsing(rng, h, w) for _ in range(s)])
    ori = rng.randint(0, 255, (s, h, w, 3)).astype(np.uint8)
    bc = pst.extract_background(parsing, ori)
    np.testing.assert_array_equal(bc, jst.extract_background(parsing, ori))
    for a, b in zip(pst.compose_training_images(ori[0], parsing[0], bc),
                    jst.compose_training_images(ori[0], parsing[0], bc)):
        np.testing.assert_array_equal(a, b)
    mask = (parsing[0][..., 0] == 255) & (parsing[0][..., 1] == 0)
    flows = [rng.randn(2, h, w).astype(np.float32) * (i + 1) * 0.3 for i in range(6)]
    rigid = np.stack([f[:, mask] for f in flows])
    stab = pst.flow_stability_map(rigid, mask, h, w)
    np.testing.assert_array_equal(stab, jst.flow_stability_map(rigid, mask, h, w))
    keys = pst.mine_rigid_keypoints(stab)
    np.testing.assert_array_equal(keys, jst.mine_rigid_keypoints(stab))
    assert len(keys) > 0
    np.testing.assert_array_equal(pst.track_keypoints(flows, keys),
                                  jst.track_keypoints(flows, keys))
    crop = prf.mask_crop(ori[0], mask, (40, 32))
    jcrop = jrf.mask_crop(ori[0], mask, (40, 32))
    np.testing.assert_array_equal(crop[0], jcrop[0])
    assert crop[1] == jcrop[1]


def test_lk_stabilize_and_pose_filters():
    """The host copies: LK stabilisation, the Kalman and one-euro filters,
    the 98 -> 68 map and EPnP with its warm start, exactly."""
    import cv2

    rng = np.random.RandomState(5)
    img = cv2.GaussianBlur(rng.randint(0, 255, (96, 96)).astype(np.uint8), (7, 7), 2)
    moved = np.roll(img, (1, 2), axis=(0, 1))
    prev = rng.uniform(20, 76, (68, 2)).astype(np.float32)
    det = prev + rng.uniform(-6, 6, (68, 2)).astype(np.float32)
    np.testing.assert_array_equal(pfl.lk_stabilize(img, moved, prev, det),
                                  jfl.lk_stabilize(img, moved, prev, det))
    seq = rng.randn(10, 4)
    for port, ref in ((pfl.OneEuroFilter(beta=0.1), jfl.OneEuroFilter(beta=0.1)),
                      (pps.KalmanStabilizer(2, 1, 0.3, 18.1),
                       jps.KalmanStabilizer(2, 1, 0.3, 18.1))):
        for v in seq[:, :1]:
            if isinstance(port, pfl.OneEuroFilter):
                np.testing.assert_array_equal(port(v), ref(v))
            else:
                port.update(v)
                ref.update(v)
                np.testing.assert_array_equal(port.state, ref.state)
    lms98 = rng.randn(98, 2)
    np.testing.assert_array_equal(pfl.map_98_to_68(lms98), jfl.map_98_to_68(lms98))
    est, jest = pps.PoseEstimator((256, 256)), jps.PoseEstimator((256, 256))
    pts = pps.synthetic_model_points()
    for i in range(3):
        lms = (pts[:, :2] * 1.2 + 128 + rng.randn(68, 2) * 0.5 + i).astype(np.float32)
        for a, b in zip(est.solve_pose_by_68_points(lms), jest.solve_pose_by_68_points(lms)):
            np.testing.assert_array_equal(a, b)
