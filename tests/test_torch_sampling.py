"""The port's compositing and depth sampling (dfanerf_torch/core/
compositing.py, core/sampling.py) against the reference package's, on the
CPU, on the same inputs made with numpy from a seed.

Both sides run the same float32 expressions. What differs is the order of
the float32 sums and products inside the scans: torch.cumsum and
torch.cumprod against XLA's blocked scans, and the row sums. The weights then
differ by a few ulps (measured 1.8e-7; bar 1e-6), and so do the CDFs of the
resample. The inverse-CDF interpolation divides by a CDF step, which is as
small as the 1e-5 weight floor over the weight sum in bins of zero weight
(relu'd densities): there an ulp of the CDF moves a depth by a visible part
of the bin. Bars per kind of ray, each well above the largest difference
measured over these cases:
- no mass at all (every weight 0): 1e-6 (measured 1.2e-7);
- all mass in one early bin (the CDF saturates at once): 1e-6 (3.0e-8);
- random positive weights: 2e-5 (2.9e-6);
- random weights with zeros mixed in: 5e-4, 5% of a bin (9.6e-5), and
  1e-5 wherever the interpolation step is at least 1e-3;
- the whole resample (hierarchical_z_vals) on weights from
  calc_volume_weights of densities with zeros: 1e-3 (measured 3.4e-4), on
  sorted depths of the same length."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfanerf_tpu.core import compositing as jc
from dfanerf_tpu.core import sampling as js
from dfanerf_torch.core import compositing as tc
from dfanerf_torch.core import sampling as ts

R, S, M, N_FINE = 300, 64, 62, 128


def _rays(seed):
    rng = np.random.RandomState(seed)
    z = np.sort(rng.uniform(0.3, 0.9, (R, S)).astype(np.float32), axis=1)
    rd = (rng.randn(R, 3) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32)
    sigma = (rng.randn(R, S) * 3.0).astype(np.float32)
    sigma[:10] = 0.0           # empty rays: only the +1e-6 density
    sigma[10:20, :5] = 0.0
    sigma[10:20, 5] = 1e7      # saturate at the 6th sample
    return rng, z, rd, sigma


def _t(x):
    return torch.from_numpy(np.array(x))


def test_calc_volume_weights_matches_reference():
    _, z, rd, sigma = _rays(0)
    for last_dist in (1e10, 0.1):
        ref = np.asarray(jc.calc_volume_weights(jnp.asarray(z), jnp.asarray(rd),
                                                jnp.asarray(sigma), last_dist))
        got = tc.calc_volume_weights(_t(z), _t(rd), _t(sigma), last_dist).numpy()
        assert got.dtype == np.float32 and np.abs(got - ref).max() < 1e-6
    # the saturated rays put all their weight on the 6th sample
    assert np.abs(got[10:20, 5] - 1.0).max() < 1e-6


@pytest.mark.parametrize("n_fields", [1, 2])
def test_volume_render_matches_reference(n_fields):
    rng, z, rd, _ = _rays(1)
    sigma = np.abs(rng.randn(n_fields, R, S)).astype(np.float32)
    sigma[:, :5] = 0.0  # a zero density sum takes the 1e-4 guard
    feat = rng.rand(n_fields, R, S, 3).astype(np.float32)
    rgb_j, w_j = jc.volume_render(jnp.asarray(z), jnp.asarray(rd), jnp.asarray(sigma),
                                  jnp.asarray(feat))
    rgb_t, w_t = tc.volume_render(_t(z), _t(rd), _t(sigma), _t(feat))
    assert np.abs(rgb_t.numpy() - np.asarray(rgb_j)).max() < 1e-6
    assert np.abs(w_t.numpy() - np.asarray(w_j)).max() < 1e-6


def test_sample_pdf_det_matches_reference():
    rng = np.random.RandomState(2)
    bins = np.broadcast_to(np.linspace(0.3, 0.9, M + 1, dtype=np.float32), (4 * 100, M + 1))
    w = rng.rand(400, M).astype(np.float32) * 0.05
    w[:100] = 0.0                           # no mass
    w[100:200] = 0.0
    w[100:200, 3] = 1.0                     # saturates in bin 3
    w[200:300] *= rng.rand(100, M) < 0.4    # zeros mixed in
    ref = np.asarray(js.sample_pdf(jnp.asarray(bins), jnp.asarray(w), N_FINE, det=True))
    got = ts.sample_pdf(_t(bins), _t(w), N_FINE, det=True).numpy()
    assert got.shape == ref.shape == (400, N_FINE)
    err = np.abs(got - ref)
    for rows, bar in ((slice(0, 100), 1e-6), (slice(100, 200), 1e-6), (slice(200, 300), 5e-4),
                      (slice(300, 400), 2e-5)):
        assert err[rows].max() < bar, (rows, err[rows].max())
    # where the CDF step the depth interpolates over is at least 1e-3, the
    # mixed rays agree as closely as the positive ones
    pdf = (w + 1e-5) / (w + 1e-5).sum(-1, keepdims=True)
    step = pdf[np.arange(400)[:, None], np.clip(np.searchsorted(
        np.linspace(0.3, 0.9, M + 1, dtype=np.float32), ref) - 1, 0, M - 1)]
    assert err[200:300][step[200:300] >= 1e-3].max() < 1e-5
    # the saturating rays put nearly every depth inside bin 3
    inside = (got[100:200] >= bins[0, 3]) & (got[100:200] <= bins[0, 4])
    assert inside.mean() > 0.95


def test_hierarchical_z_vals_matches_reference():
    _, z, rd, sigma = _rays(3)
    z_lin = np.broadcast_to(np.asarray(jnp.linspace(0.3, 0.9, S)), (R, S))
    for zz in (z, z_lin):
        w = np.asarray(jc.calc_volume_weights(jnp.asarray(zz), jnp.asarray(rd),
                                              jnp.asarray(sigma)))
        ref = np.asarray(js.hierarchical_z_vals(jnp.asarray(zz), jnp.asarray(w), N_FINE,
                                                det=True))
        got = ts.hierarchical_z_vals(_t(zz), _t(w), N_FINE, det=True).numpy()
        assert got.shape == ref.shape == (R, S + N_FINE)
        assert (np.diff(got, axis=1) >= 0).all()
        assert np.abs(got - ref).max() < 1e-3
        # empty rays resample uniformly: the weight floor alone
        assert np.abs(got[:10] - ref[:10]).max() < 1e-6


def test_stratified_z_vals_equal_and_random_paths_raise():
    """The uniform depths equal the reference's; the random forms, fed the
    reference's uniform draws for a key, match its jittered depths (bit for
    bit here) and its random resample (the positive-weight bar above); a
    random resample without a generator raises."""
    got = ts.stratified_z_vals(0.3, 0.9, 5, S).numpy()
    np.testing.assert_array_equal(got, np.asarray(js.stratified_z_vals(0.3, 0.9, 5, S)))
    key = jax.random.PRNGKey(0)
    u = _t(jax.random.uniform(key, (5, S)))
    jit = ts.jitter_z_vals(ts.stratified_z_vals(0.3, 0.9, 5, S), u).numpy()
    assert np.abs(jit - np.asarray(js.stratified_z_vals(0.3, 0.9, 5, S, key=key))).max() < 1e-6
    bins = np.broadcast_to(np.linspace(0.3, 0.9, M + 1, dtype=np.float32), (20, M + 1))
    w = np.random.RandomState(4).rand(20, M).astype(np.float32)
    ref = np.asarray(js.sample_pdf(jnp.asarray(bins), jnp.asarray(w), N_FINE, key=key))
    got = ts.inverse_cdf(_t(bins), _t(w), _t(jax.random.uniform(key, (20, N_FINE)))).numpy()
    assert np.abs(got - ref).max() < 2e-5
    with pytest.raises(ValueError, match="generator"):
        ts.sample_pdf(_t(np.zeros((2, 5), np.float32)), _t(np.ones((2, 4), np.float32)), 8)
