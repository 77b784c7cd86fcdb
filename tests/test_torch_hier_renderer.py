"""The slice as a whole: the port's hierarchical head renderer (plain
versions, on the CPU) against the reference package's
make_head_hierarchical_renderer (Pallas interpret mode), with the setup of
tests/test_render.py's hierarchical tests: 24x24 synthetic scene, 16 coarse
+ 16 fine samples, occupancy grid 16, JAX init converted to the port, zero
signal.

Thresholds: random-init head densities vary little over the grid, so each
flagged case takes its threshold in the top 0.1% of the node densities,
where half of the (tile, slab) pairs are flagged (relu 0.172, softplus
2.859).

- Dense, without and with flags (one frame each): the frames differ only by
  the last bits of the float32 sums and an occasional flipped bf16
  activation. Bars max 3e-5, mean 2.5e-6 (measured 1.48e-5 and 1.31e-6).
- Pair-compacted, 5 frames, refresh every 3 frames, softplus (the serving
  recipe's density), a budgeted contribution prune of 0.065: after every
  frame the union tiles and both pair lists equal the reference's unpadded
  prefix (the reference pads its lists to bucket sizes with pairs on a dummy
  tile row). The pair path stores colours in bf16, so a flipped rounding
  there moves a sample's colour by 2^-8 of itself, weighted by the sample's
  weight: bars max 2.5e-4, mean 3e-6 (measured 1.09e-4 and 1.33e-6).
  The per-tile slab masses the budget sums lie 4e-3 or more from the budget
  at each refresh, far outside the masses' rounding (a few 1e-6), so the
  drop decisions cannot differ between the packages by rounding."""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfanerf_tpu.config import ExperimentConfig as JExperimentConfig
from dfanerf_tpu.config import RenderConfig as JRenderConfig
from dfanerf_tpu.config import TrainConfig as JTrainConfig
from dfanerf_tpu.data import make_synthetic_dataset
from dfanerf_tpu.models import DecoderConfig as JDecoderConfig
from dfanerf_tpu.render.renderer import (
    make_head_hierarchical_renderer as j_make_head_hierarchical_renderer,
)
from dfanerf_tpu.train import dataset_to_device
from dfanerf_tpu.train import init_train_state as j_init_train_state
from dfanerf_torch.compat.from_jax import state_from_jax
from dfanerf_torch.config import ExperimentConfig, RenderConfig
from dfanerf_torch.core.compositing import calc_volume_weights
from dfanerf_torch.core.sampling import hierarchical_z_vals
from dfanerf_torch.models import DecoderConfig
from dfanerf_torch.ops.occupancy import occupancy_flags_and_sat
from dfanerf_torch.ops.sigma_head import fused_sigma_head
from dfanerf_torch.render.renderer import fine_slab_mass, make_head_hierarchical_renderer

DENSE_MAX, DENSE_MEAN = 3e-5, 2.5e-6
PAIR_MAX, PAIR_MEAN = 2.5e-4, 3e-6
BASE = dict(n_samples=16, n_importance=16, use_fused_kernel=True, occ_grid_res=16, ert_eps=1e-4)
PAIRS = dict(BASE, occ_sigma_thresh=2.859, occ_pair_compaction=True, occ_refresh_every=3,
             occ_prune_contrib=0.065)
MARGIN = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch single-threaded for this module: its plain versions run many
    small products, and the intra-op threads of six suite workers on a few
    cores cost more than they save."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    ds = make_synthetic_dataset(n_frames=6, H=24, W=24, n_samples_gt=16)
    jstate = j_init_train_state(jax.random.PRNGKey(0), JExperimentConfig(
        train=JTrainConfig(n_rand=128), render=JRenderConfig(n_samples=16, tile_rays=256)))
    tstate = state_from_jax(
        jax.tree.map(np.asarray, {k: jstate[k] for k in ("params", "z_shape", "z_app", "step")}),
        ExperimentConfig(), device="cpu")
    return ds, jstate, dataset_to_device(ds), tstate


def _renderers(setup, act, **render):
    ds = setup[0]
    j = j_make_head_hierarchical_renderer(JExperimentConfig(
        decoder=JDecoderConfig(density_activation=act), render=JRenderConfig(**render)),
        ds.hwfcxy, ds.near, ds.far)
    t = make_head_hierarchical_renderer(ExperimentConfig(
        decoder=DecoderConfig(density_activation=act), render=RenderConfig(**render)),
        ds.hwfcxy, ds.near, ds.far, device="cpu")
    return j, t


def _frames(setup, j_render, t_render, i):
    ds, jstate, data, tstate = setup
    sig = np.zeros(96, np.float32)
    ref = j_render(jstate["params"], jstate["z_shape"], jstate["z_app"], data["poses"][i],
                   jnp.asarray(sig), data["bc_img"])
    got = t_render(tstate["params"], tstate["z_shape"], tstate["z_app"], ds.poses[i],
                   torch.from_numpy(sig), ds.bc_img)
    return got.numpy(), np.asarray(ref)


def _check(got, ref, max_err, mean_err, tag):
    assert got.shape == ref.shape == (24, 24, 3) and np.isfinite(got).all()
    err = np.abs(got - ref)
    assert err.max() < max_err and err.mean() < mean_err, (tag, err.max(), err.mean())


@pytest.mark.parametrize("act, thresh", [("relu", 0.0), ("relu", 0.172), ("softplus", 2.859)],
                         ids=["no-skip", "flags-relu", "flags-softplus"])
def test_dense_renderer_matches_reference(setup, monkeypatch, act, thresh):
    monkeypatch.setenv("DFANERF_PALLAS_INTERPRET", "1")
    j_render, t_render = _renderers(setup, act, **BASE, occ_sigma_thresh=thresh)
    got, ref = _frames(setup, j_render, t_render, 0)
    _check(got, ref, DENSE_MAX, DENSE_MEAN, thresh)
    if thresh > 0:  # the case is not degenerate: flags of both passes mixed
        ds, _, _, tstate = setup
        st = t_render.stages
        pw, ro, rd, _ = st["prep"](tstate["params"], tstate["z_shape"], tstate["z_app"],
                                   ds.poses[0], torch.zeros(96), ds.bc_img)
        occ_c, sat = st["coarse_flags"](pw, ro, rd)
        _, occ_f = st["resample"](pw, ro, rd, st["sigma"](pw, ro, rd, occ_c), sat)
        assert 0 < occ_c.float().mean() < 1 and 0 < occ_f.float().mean() < 1


def _budget_margin(setup, t_render, i, budget):
    """The smallest distance of the per-tile cumulative slab masses (smallest
    first) from the budget, at frame i's refresh, and the number of slabs
    the budget drops; computed from the port's public functions."""
    ds, _, _, tstate = setup
    pw, ro, rd, _ = t_render.stages["prep"](tstate["params"], tstate["z_shape"], tstate["z_app"],
                                            ds.poses[i], torch.zeros(96), ds.bc_img)
    z_c = torch.from_numpy(np.array(jnp.linspace(ds.near, ds.far, 16)))
    z_b = z_c.expand(ro.shape[0], 16)
    occ_c, sat = occupancy_flags_and_sat(pw, "head", ro, rd, z_b, PAIRS["occ_sigma_thresh"], 16,
                                         act="softplus")
    sigma = fused_sigma_head(pw, ro, rd, z_c, occupancy=occ_c, act="softplus")
    sigma[:, -1] += 1e-6
    weights = calc_volume_weights(z_b, rd, sigma)
    z_fine = hierarchical_z_vals(z_b, weights, 16, det=True)
    occ_f, _ = occupancy_flags_and_sat(pw, "head", ro, rd, z_fine, PAIRS["occ_sigma_thresh"], 16,
                                       sat_cache=sat, act="softplus")
    mass = torch.where(occ_f > 0, fine_slab_mass(weights, z_fine, z_c), 0.0)
    cum = torch.sort(mass, dim=1).values.cumsum(dim=1)
    live = torch.sort(mass, dim=1).values > 0
    return float((cum - budget).abs()[live].min()), int(((cum <= budget) & live).sum())


def test_pair_renderer_matches_reference(setup, monkeypatch):
    monkeypatch.setenv("DFANERF_PALLAS_INTERPRET", "1")
    j_render, t_render = _renderers(setup, "softplus", **PAIRS)
    j_cache = inspect.getclosurevars(j_render).nonlocals["hcache"]
    counts = []
    for i in range(5):
        got, ref = _frames(setup, j_render, t_render, i)
        _check(got, ref, PAIR_MAX, PAIR_MEAN, i)
        tc = t_render.cache
        assert tc["age"] == j_cache["age"] and not tc["empty"]
        k_u = j_cache["k_u"]
        np.testing.assert_array_equal(tc["tiles_u"], np.asarray(j_cache["tiles_sel"])[
            :j_cache["n_real"]])
        for ti, ji in (("ti_c", "ji_c"), ("ti_f", "ji_f")):
            k = tc[ti].numel()
            np.testing.assert_array_equal(tc[ti].numpy(), np.asarray(j_cache[ti])[:k])
            np.testing.assert_array_equal(tc[ji].numpy(), np.asarray(j_cache[ji])[:k])
            # everything past the prefix is the reference's padding
            assert (np.asarray(j_cache[ti])[k:] == k_u).all()
        counts.append((tc["ti_c"].numel(), tc["ti_f"].numel()))
    # refreshes at frames 0 and 3; coarse and fine lists partly filled
    assert all(0 < k_c < 4 * 2 and 0 < k_f < 4 * 4 for k_c, k_f in counts)
    for i in (0, 3):
        margin, dropped = _budget_margin(setup, t_render, i, PAIRS["occ_prune_contrib"])
        assert margin > MARGIN and dropped > 0, (i, margin, dropped)


def test_all_empty_frame_is_the_background(setup, monkeypatch):
    monkeypatch.setenv("DFANERF_PALLAS_INTERPRET", "1")
    j_render, t_render = _renderers(setup, "softplus", **dict(PAIRS, occ_sigma_thresh=1e3))
    got, ref = _frames(setup, j_render, t_render, 0)
    assert t_render.cache["empty"]
    # the background pixel itself; XLA divides by 255 as a product with the
    # reciprocal, one float32 ulp from the division
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7)
    np.testing.assert_allclose(got, setup[0].bc_img.astype(np.float32) / 255.0, rtol=0, atol=1e-7)


def test_unported_or_invalid_configurations_raise():
    hw = (24, 24, 26.4, 12.0, 12.0)
    base = ExperimentConfig(render=RenderConfig(**BASE))
    for bad in ({"n_importance": 0}, {"n_importance": 12}, {"concate_bg": False}):
        with pytest.raises(ValueError):
            make_head_hierarchical_renderer(dataclasses.replace(base, render=dataclasses.replace(
                base.render, **bad)), hw, 0.3, 0.9, device="cpu")
