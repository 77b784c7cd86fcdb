"""The 3DMM tracker and bundle adjustment against the reference on the CPU.

A small seeded 3DMM (200 points, 20 id and 12 exp dims) is written in the
reference's ``.bin`` layout and loaded by both packages (``random:<seed>``
cannot reproduce ``jax.random``). Targets are the model's projected
landmarks at a known pose and focal, with noise. One fit runs with the
id/exp gate opening at iteration 20 of 50 so the gated groups start
stepping; the full tracker runs the 20-candidate focal sweep; bundle
adjustment runs both phases short. The winning focal is equal, the
parameters agree at rtol 1e-3 (atol 1e-5 on values near zero) and the
losses at rtol 1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfanerf_torch.pipeline import face3dmm as pfm
from dfanerf_torch.pipeline import tracking as ptr
from dfanerf_tpu.pipeline import face3dmm as jfm
from dfanerf_tpu.pipeline import tracking as jtr

DIMS = dict(point_num=200, id_dim=20, exp_dim=12, tex_dim=8)
RTOL, ATOL = 1e-3, 1e-5
CXY = (64.0, 64.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch single-threaded for this module: its inputs are small, and the
    intra-op threads of six suite workers on a few cores cost more than they
    save."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bfm"))
    pfm.write_face3dmm(path, pfm.synthetic_3dmm_arrays(7, **DIMS))
    port = pfm.load_face3dmm(path, **DIMS, device="cpu")
    ref = jfm.load_face3dmm(path, **DIMS)
    return port, ref


def _targets(port, n=3, seed=0, z=-650.0, noise=0.3):
    """[n, 68, 2] landmarks: the model at random id/exp/pose, focal 900."""
    rng = np.random.RandomState(seed)
    idx = port.lands_info
    geo = pfm.forward_geo_sub(port, torch.from_numpy(rng.randn(n, 20).astype(np.float32) * 0.5),
                              torch.from_numpy(rng.randn(n, 12).astype(np.float32) * 0.5), idx)
    euler = torch.from_numpy(rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32))
    trans = torch.from_numpy((rng.randn(n, 3) * 5.0 + [0, 0, z]).astype(np.float32))
    from dfanerf_torch.core.geometry import forward_transform

    proj = forward_transform(geo, euler, trans, 900.0, torch.tensor(CXY))[..., :2]
    return (proj.numpy() + rng.randn(n, 68, 2) * noise).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_models_load_the_same(models):
    port, ref = models
    for k in ("base_id", "base_exp", "mu", "sig_id", "sig_exp"):
        np.testing.assert_array_equal(getattr(port, k).numpy(), np.asarray(getattr(ref, k)))
    np.testing.assert_array_equal(port.lands_info, ref.lands_info)


def test_fit_once_with_the_gate_opening(models):
    """50 iterations at focal 900, id/exp stepping from iteration 21."""
    port, ref = models
    lms = _targets(port)[:, -51:]
    idx = port.lands_info[-51:]
    p, loss = ptr._fit_once(port, torch.from_numpy(lms), idx, 900.0, torch.tensor(CXY), 50, 20,
                            12, id_exp_after=20)
    jp, jloss = jax.jit(lambda: jtr._fit_once(ref, jnp.asarray(lms), jnp.asarray(idx),
                                              jnp.float32(900.0), jnp.asarray(CXY), 50, 20, 12,
                                              id_exp_after=20))()
    for k in ("id", "exp", "euler", "trans"):
        _close(p[k].numpy(), jp[k])
    assert np.abs(p["id"].numpy()).max() > 0  # the gate opened
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)


def test_fit_landmarks_focal_sweep(models):
    """The whole tracker: 20 focal candidates on every 2nd frame, then the
    full fit; the same winning focal, parameters and loss. The targets sit
    within the fit's 40 steps of its start (z = -600), so the sweep's
    losses have an interior minimum."""
    port, ref = models
    lms = _targets(port, n=4, seed=1, z=-594.0, noise=1e-4)
    got, loss = ptr.fit_landmarks(port, lms, CXY, sweep_stride=2, n_iters=40, id_dim=20,
                                  exp_dim=12)
    want, jloss = jtr.fit_landmarks(ref, jnp.asarray(lms), CXY, sweep_stride=2, n_iters=40,
                                    id_dim=20, exp_dim=12)
    assert float(got.focal[0]) == float(want.focal[0])
    for k in ("id", "exp", "euler", "trans"):
        _close(getattr(got, k).numpy(), getattr(want, k))
    np.testing.assert_allclose(loss, jloss, rtol=RTOL)


def test_bundle_adjust(models):
    """Both phases, short: points from zero (lr 1e-2), then points and poses
    (lr 1e-4)."""
    rng = np.random.RandomState(2)
    n, k = 5, 30
    euler = rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)
    trans = (rng.randn(n, 3) * 0.01 + [0, 0, -0.6]).astype(np.float32)
    pts = rng.randn(k, 3).astype(np.float32) * 0.05
    from dfanerf_torch.core.geometry import forward_transform

    track = forward_transform(torch.from_numpy(pts)[None].expand(n, k, 3), torch.from_numpy(euler),
                              torch.from_numpy(trans), 1000.0, torch.tensor(CXY))[..., :2]
    track = (track.numpy() + rng.randn(n, k, 2) * 0.5).astype(np.float32)
    got = ptr.bundle_adjust(track, torch.from_numpy(euler), torch.from_numpy(trans),
                            torch.tensor(1000.0), CXY, iters_pts=60, iters_joint=40)
    want = jtr.bundle_adjust(track, jnp.asarray(euler), jnp.asarray(trans), jnp.float32(1000.0),
                             CXY, iters_pts=60, iters_joint=40)
    for key in ("euler", "trans", "pts"):
        _close(got[key].numpy(), want[key])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
    assert got["loss"] < got["loss_pts"] or got["loss"] == pytest.approx(got["loss_pts"])
