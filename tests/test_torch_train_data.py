"""The port's training data and helpers against the reference package on
the CPU, on the same inputs made with numpy from a seed: rays of explicit
pixels, the analytic scene and its ground-truth frames, the random forms of
the depth samplers (fed JAX's own uniform draws), losses, the half-signal
image, the staged-Adam update and the learning-rate schedule.

Tolerances, each above the largest difference measured:
- rays_for_pixels: 1e-6 (the 3x3 rotation's sums; measured 1.2e-7), and
  equal to get_rays' rows at those pixels;
- analytic_field: colours 1e-6 (measured 1.2e-7), densities 1e-4 relative
  (measured 1.6e-7; sigmoid and norm differ in the last bits);
- ground-truth frames, 32x32, 4 frames, both target sets: every channel
  value within 1 LSB, and fewer than 0.1% of them off by one, since float
  order can move a value across a truncation edge (measured: none of the
  24,576 differ);
- jittered depths 1e-6 (measured 0); the random inverse-CDF resample on
  random positive weights 2e-5, the bar of the deterministic one in
  tests/test_torch_sampling.py (measured 1.3e-6);
- the learning rate rtol 1e-6 (numpy's float32 pow against XLA's differ
  by an ulp); Adam parameters 1e-7 after each update.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfanerf_tpu.core import losses as jl
from dfanerf_tpu.core import sampling as js
from dfanerf_tpu.core.rays import rays_for_pixels as j_rays_for_pixels
from dfanerf_tpu.data import make_synthetic_dataset as j_make_synthetic_dataset
from dfanerf_tpu.data.dataset import FrameDataset as JFrameDataset
from dfanerf_tpu.data.dataset import speaking_i_train as j_speaking_i_train
from dfanerf_tpu.data.synthetic import analytic_field as j_analytic_field
from dfanerf_tpu.train import optim as jo
from dfanerf_tpu.train.signals import get_half_signals as j_get_half_signals
from dfanerf_torch.config import ExperimentConfig
from dfanerf_torch.core import losses as tl
from dfanerf_torch.core import sampling as ts
from dfanerf_torch.core.rays import get_rays, rays_for_pixels
from dfanerf_torch.data.dataset import FrameDataset, speaking_i_train
from dfanerf_torch.data.synthetic import analytic_field, make_synthetic_dataset
from dfanerf_torch.train import optim as to
from dfanerf_torch.train.signals import get_half_signals
from dfanerf_torch.train.step import dataset_to_device, make_train_step


def _t(x):
    return torch.from_numpy(np.array(x))


def test_rays_for_pixels_matches_reference_and_get_rays():
    rng = np.random.RandomState(0)
    coords = np.stack([rng.randint(0, 40, 300), rng.randint(0, 50, 300)], -1).astype(np.int32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0]
    c2w[:3, 3] = rng.randn(3)
    ro_j, rd_j = j_rays_for_pixels(jnp.asarray(coords), 55.0, jnp.asarray(c2w), 25.0, 20.0)
    ro, rd = rays_for_pixels(_t(coords), 55.0, _t(c2w), 25.0, 20.0)
    assert np.abs(rd.numpy() - np.asarray(rd_j)).max() < 1e-6
    np.testing.assert_array_equal(ro.numpy(), np.asarray(ro_j))
    # the rows of the full grid at those pixels
    go, gd = get_rays(40, 50, 55.0, _t(c2w), 25.0, 20.0)
    assert np.abs(gd[coords[:, 0], coords[:, 1]].numpy() - rd.numpy()).max() < 1e-6


@pytest.mark.parametrize("include_torso", [True, False])
def test_analytic_field_matches_reference(include_torso):
    rng = np.random.RandomState(1)
    pts = (rng.randn(4000, 3) * 0.15).astype(np.float32)
    pts[:50] = pts[:50] * 0.01 + [0.0, -0.04, 0.0]  # the mouth band
    for a in (-0.7, 0.0, 0.9):
        rgb_j, sig_j = j_analytic_field(jnp.asarray(pts), jnp.float32(a), include_torso)
        rgb, sig = analytic_field(_t(pts), torch.tensor(a, dtype=torch.float32), include_torso)
        assert np.abs(rgb.numpy() - np.asarray(rgb_j)).max() < 1e-6
        sig_j = np.asarray(sig_j)
        assert (np.abs(sig.numpy() - sig_j) <= 1e-4 * sig_j + 1e-6).all()


def test_ground_truth_frames_match_reference():
    kw = dict(n_frames=4, H=32, W=32, n_samples_gt=32, seed=3)
    ref = j_make_synthetic_dataset(**kw)
    got = make_synthetic_dataset(**kw, device="cpu")
    for k in ("poses", "auds", "exps", "bc_img", "sample_rects", "i_train", "i_val"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k), err_msg=k)
    assert got.hwfcxy == ref.hwfcxy and (got.near, got.far) == (ref.near, ref.far)
    for k in ("imgs_com", "imgs_head"):
        g, r = getattr(got, k), getattr(ref, k)
        assert g.dtype == np.uint8 and g.shape == r.shape == (4, 32, 32, 3)
        d = np.abs(g.astype(np.int16) - r.astype(np.int16))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3, (k, d.max(), int((d > 0).sum()))
    # the head-only targets differ from the composites where the torso is
    assert (got.imgs_com != got.imgs_head).any()


def test_stratified_jitter_with_reference_draws():
    key = jax.random.PRNGKey(4)
    ref = np.asarray(js.stratified_z_vals(0.3, 0.9, 50, 24, key=key))
    u = _t(jax.random.uniform(key, (50, 24)))
    got = ts.jitter_z_vals(ts.stratified_z_vals(0.3, 0.9, 50, 24), u).numpy()
    assert np.abs(got - ref).max() < 1e-6
    drawn = ts.stratified_z_vals(0.3, 0.9, 50, 24, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (50, 24) and bool((drawn[:, 1:] >= drawn[:, :-1]).all())
    assert not torch.equal(drawn, ts.stratified_z_vals(0.3, 0.9, 50, 24))


def test_random_resample_with_reference_draws():
    rng = np.random.RandomState(5)
    R, M, N = 200, 30, 48
    z = np.sort(rng.uniform(0.3, 0.9, (R, M + 2)).astype(np.float32), axis=1)
    w = (rng.rand(R, M + 2) + 0.05).astype(np.float32)
    key = jax.random.PRNGKey(6)
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    ref = np.asarray(js.sample_pdf(jnp.asarray(bins), jnp.asarray(w[:, 1:-1]), N, key=key))
    u = _t(jax.random.uniform(key, (R, N)))
    got = ts.inverse_cdf(_t(bins), _t(w[:, 1:-1]), u).numpy()
    assert np.abs(got - ref).max() < 2e-5
    ref_h = np.asarray(js.hierarchical_z_vals(jnp.asarray(z), jnp.asarray(w), N, key=key))
    got_h = torch.sort(torch.cat([_t(z), torch.from_numpy(got)], -1), -1).values.numpy()
    assert np.abs(got_h - ref_h).max() < 2e-5
    g = torch.Generator().manual_seed(0)
    drawn = ts.hierarchical_z_vals(_t(z), _t(w), N, generator=g)
    assert drawn.shape == (R, M + 2 + N) and bool((drawn[:, 1:] >= drawn[:, :-1]).all())
    with pytest.raises(ValueError, match="generator"):
        ts.sample_pdf(_t(bins), _t(w[:, 1:-1]), N)


def test_losses_match_reference():
    rng = np.random.RandomState(7)
    x, y = rng.rand(64, 3).astype(np.float32), rng.rand(64, 3).astype(np.float32)
    mse_j = jl.img2mse(jnp.asarray(x), jnp.asarray(y))
    mse = tl.img2mse(_t(x), _t(y))
    np.testing.assert_allclose(float(mse), float(mse_j), rtol=1e-6)
    np.testing.assert_allclose(float(tl.mse2psnr(mse)), float(jl.mse2psnr(mse_j)), rtol=1e-6)
    np.testing.assert_array_equal(tl.to8b(_t(x * 1.2 - 0.1)), jl.to8b(x * 1.2 - 0.1))
    ts_ = [rng.randn(4, 9).astype(np.float32), rng.randn(2, 3, 7).astype(np.float32)]
    np.testing.assert_allclose(float(tl.cal_lap_loss([_t(a) for a in ts_], [1.0, 0.5])),
                               float(jl.cal_lap_loss([jnp.asarray(a) for a in ts_], [1.0, 0.5])),
                               rtol=1e-6)
    for k, n in ((0, 8), (3, 8), (5, 16)):
        assert np.abs(tl.dct_basis(k, n).numpy() - np.asarray(jl.dct_basis(k, n))).max() < 1e-6
    assert np.abs(tl.dct_space(3, 8).numpy() - np.asarray(jl.dct_space(3, 8))).max() < 1e-6
    null = tl.dct_null_space(3, 8)
    assert null.shape == (5, 8)
    assert np.abs(null.numpy() - np.asarray(jl.dct_null_space(3, 8))).max() < 1e-6
    # the two spaces together are orthonormal
    full = torch.cat([tl.dct_space(3, 8), null])
    assert float((full @ full.T - torch.eye(8)).abs().max()) < 1e-5


@pytest.mark.parametrize("H", [6, 7])
def test_half_signals_match_reference(H):
    rng = np.random.RandomState(8)
    aud, eye = rng.randn(5).astype(np.float32), rng.randn(5).astype(np.float32)
    got = get_half_signals(H, 4, _t(aud), _t(eye))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_get_half_signals(H, 4, aud, eye)))
    assert got.shape == (2 * (H // 2), 4, 5)


def test_speaking_frames_and_device_data():
    base = dict(poses=np.zeros((6, 4, 4), np.float32), auds=np.zeros((6, 512), np.float32),
                exps=np.zeros((6, 64), np.float32), imgs_head=None, imgs_com=None,
                bc_img=np.zeros((4, 4, 3), np.uint8), sample_rects=None,
                hwfcxy=(4, 4, 4.4, 2.0, 2.0), i_train=np.arange(5, dtype=np.int32),
                i_val=np.array([5], np.int32))
    for speak in (None, np.array([0, 1, 1, 0, 1, 1], np.int32)):
        got = speaking_i_train(FrameDataset(**base, speak_frames=speak))
        np.testing.assert_array_equal(got, j_speaking_i_train(JFrameDataset(
            **base, speak_frames=speak)))
    ds = FrameDataset(**base, speak_frames=speak)
    data = dataset_to_device(ds, "cpu")
    assert set(data) == {"poses", "auds", "exps", "bc_img"}
    # the step owns the training frames (speaking ones only) and the rects
    step = make_train_step(ExperimentConfig(), ds, device="cpu")
    np.testing.assert_array_equal(step.i_train, [1, 2, 4])
    np.testing.assert_array_equal(step.rects, np.zeros((6, 4), np.int32))
    assert data["bc_img"].dtype == torch.uint8 and data["poses"].dtype == torch.float32
    assert [f.name for f in dataclasses.fields(FrameDataset)] == [
        f.name for f in dataclasses.fields(JFrameDataset)]


def test_staged_adam_and_schedule_match_reference():
    rng = np.random.RandomState(9)
    lin = torch.nn.Linear(5, 3)
    p0 = {"w": rng.randn(5, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
    with torch.no_grad():
        lin.weight.copy_(_t(p0["w"].T))
        lin.bias.copy_(_t(p0["b"]))
    opt_t = to.adam_init(lin)
    opt_j = jo.adam_init(jax.tree.map(jnp.asarray, p0))
    pj = jax.tree.map(jnp.asarray, p0)
    for step, gate in enumerate((1, 0, 1, 1)):
        g = {"w": rng.randn(5, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
        lr = to.exp_decay_lr(step * 40000, 5e-4, 500)
        lr_j = jo.exp_decay_lr(jnp.int32(step * 40000), 5e-4, 500)
        np.testing.assert_allclose(lr, float(lr_j), rtol=1e-6)  # powf vs XLA's pow
        pj, opt_j = jo.adam_update(opt_j, jax.tree.map(jnp.asarray, g), pj, lr_j,
                                   jnp.int32(gate))
        to.adam_update(opt_t, {"weight": _t(g["w"].T), "bias": None if step == 3 else _t(g["b"])},
                       dict(lin.named_parameters()), lr, bool(gate))
        if step == 3:  # a parameter without a gradient steps with zeros
            pj_b = pj["b"]
        assert opt_t["t"] == int(opt_j["t"])
        if step < 3:
            assert np.abs(lin.weight.detach().numpy().T - np.asarray(pj["w"])).max() < 1e-7
            assert np.abs(lin.bias.detach().numpy() - np.asarray(pj["b"])).max() < 1e-7
    assert opt_t["t"] == 3
    # the last step's bias took a zero gradient in the port: m and v only decay
    assert not np.allclose(lin.bias.detach().numpy(), np.asarray(pj_b))


def test_transmittance_cumprod_gradient_is_torchs():
    """The compositing's cumprod takes torch's own gradient for inputs
    without zeros, bit for bit, with no host read of a device value."""
    from dfanerf_torch.core.compositing import _PositiveCumprod

    x = (torch.rand(6, 9, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
         * 0.9 + 1e-10).requires_grad_()
    assert torch.autograd.gradcheck(_PositiveCumprod.apply, (x,))
    x32 = x.detach().float().requires_grad_()
    g = torch.randn(6, 9, generator=torch.Generator().manual_seed(1))
    ours = torch.autograd.grad(_PositiveCumprod.apply(x32), x32, g)[0]
    assert torch.equal(ours, torch.autograd.grad(torch.cumprod(x32, -1), x32, g)[0])
