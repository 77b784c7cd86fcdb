"""The slice as a whole: the port's occupancy serving renderers (plain
versions, on the CPU) against the reference package's (Pallas interpret
mode): the plain occupancy path and the per-field tile classes
(``occ_tile_compaction``, the shipped serving configuration), over 5 frames
that cross two flag refreshes, on a 32x32 synthetic scene with 16 samples,
occupancy grid 16, refresh every 2 frames, JAX init converted to the port.

After every frame the flag state must be equal: the flags in force (plain
path), or the tile order, the segment sizes ``ks``, each segment's flags and
the age (tile classes). Bars on both images: max 3e-5 and mean 1e-6
(measured at most 6.6e-6 max, 7.5e-7 mean over these cases and frames).

Random-init densities (relu) peak near 0.05 for the head and 0.1 for the
torso at the nodes of these frames, so the threshold picks the classes
(node threshold = threshold / 4). Class sizes (both, head, torso, none) at
the refreshes of frames 0, 2 and 4:
- 0.18: (4, 0, 0, 0), (1, 0, 3, 0), (2, 0, 2, 0). At T = 4 the bucket
  ladder is {0, 4}, so the "both" segment borrows the torso-only tiles and
  renders them with their joint flags.
- 0.37: (0, 0, 2, 2) each time: no "both" tile; the torso-only segment is
  padded from the "none" tiles with zero flags, so the torso-only kernel
  variant and the padding run.
- 0.6: no flag at all; every tile gets the background epilogue alone.

``tile_classes`` is also held against the reference's own class split at
the full 450x450 frame (841 tiles), with the reference's occupancy, kernel
and epilogue replaced by seeded flags and zero stubs in this test only."""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfanerf_tpu.ops.fused_render as jf
from dfanerf_tpu.config import ExperimentConfig as JExperimentConfig
from dfanerf_tpu.config import RenderConfig as JRenderConfig
from dfanerf_tpu.config import TrainConfig as JTrainConfig
from dfanerf_tpu.data import make_synthetic_dataset
from dfanerf_tpu.render.renderer import make_frame_renderer as j_make_frame_renderer
from dfanerf_tpu.train import dataset_to_device
from dfanerf_tpu.train import init_train_state as j_init_train_state
from dfanerf_torch.compat.from_jax import state_from_jax
from dfanerf_torch.config import ExperimentConfig, RenderConfig
from dfanerf_torch.render import renderer as t_renderer
from dfanerf_torch.render.renderer import make_frame_renderer, tile_classes

MAX_ERR, MEAN_ERR = 3e-5, 1e-6
# the class sizes of each case's three refreshes (see above)
SIZES = {
    "plain": [(4, 0, 0, 0), (1, 0, 3, 0), (2, 0, 2, 0)],
    "classes-both": [(4, 0, 0, 0), (1, 0, 3, 0), (2, 0, 2, 0)],
    "classes-no-both": [(0, 0, 2, 2)] * 3,
    "classes-empty": [(0, 0, 0, 4)] * 3,
}
KS = {"classes-both": (4, 0, 0), "classes-no-both": (0, 0, 4), "classes-empty": (0, 0, 0)}
OCC = dict(n_samples=16, use_fused_kernel=True, spatial_tiles=True, occ_grid_res=16,
           occ_refresh_every=2, ert_eps=1e-4)
CASES = {
    "plain": dict(occ_sigma_thresh=0.18, occ_tile_compaction=False),
    "classes-both": dict(occ_sigma_thresh=0.18, occ_tile_compaction=True),
    "classes-no-both": dict(occ_sigma_thresh=0.37, occ_tile_compaction=True),
    "classes-empty": dict(occ_sigma_thresh=0.6, occ_tile_compaction=True),
}


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
    ds = make_synthetic_dataset(n_frames=6, H=32, W=32, n_samples_gt=16)
    jstate = j_init_train_state(jax.random.PRNGKey(0), JExperimentConfig(
        train=JTrainConfig(n_rand=128), render=JRenderConfig(n_samples=16, tile_rays=256)))
    tstate = state_from_jax(
        jax.tree.map(np.asarray, {k: jstate[k] for k in ("params", "z_shape", "z_app", "step")}),
        ExperimentConfig(), device="cpu")
    return ds, jstate, dataset_to_device(ds), tstate


def _ref_cache(render):
    """The reference renderer's flag state: the ``cache`` dict its frame
    function closes over (it does not expose it as an attribute)."""
    return inspect.getclosurevars(render).nonlocals["cache"]


def _class_sizes(occ):
    """(both, head-only, torso-only, none) tile counts of flags [2, T, J]."""
    th, tt = occ[0].max(axis=1) > 0, occ[1].max(axis=1) > 0
    return (int((th & tt).sum()), int((th & ~tt).sum()), int((tt & ~th).sum()),
            int((~th & ~tt).sum()))


@pytest.mark.parametrize("case", list(CASES))
def test_occupancy_renderer_matches_reference(setup, monkeypatch, case):
    monkeypatch.setenv("DFANERF_PALLAS_INTERPRET", "1")
    ds, jstate, data, tstate = setup
    render_cfg = dict(OCC, **CASES[case])
    j_render = j_make_frame_renderer(JExperimentConfig(render=JRenderConfig(**render_cfg)),
                                     ds.hwfcxy, ds.near, ds.far)
    t_render = make_frame_renderer(ExperimentConfig(render=RenderConfig(**render_cfg)),
                                   ds.hwfcxy, ds.near, ds.far, device="cpu")
    flag_runs = []
    real = t_renderer.conservative_occupancy

    def spy(*args, **kw):  # each refresh's flags, for the class sizes
        out = real(*args, **kw)
        flag_runs.append(out.numpy())
        return out

    monkeypatch.setattr(t_renderer, "conservative_occupancy", spy)
    sig, sig_t = np.zeros(96, np.float32), np.zeros(42, np.float32)
    sizes, ks_seen = [], []
    for i in range(5):
        n_runs = len(flag_runs)
        ref = j_render(jstate["params"], jstate["z_shape"], jstate["z_app"], data["poses"][i],
                       data["poses"][0], jnp.asarray(sig), jnp.asarray(sig_t), data["bc_img"])
        got = t_render(tstate["params"], tstate["z_shape"], tstate["z_app"], ds.poses[i],
                       ds.poses[0], torch.from_numpy(sig), torch.from_numpy(sig_t), ds.bc_img)
        jc, tc = _ref_cache(j_render), t_render.cache
        assert tc["age"] == jc["age"]
        if case == "plain":
            np.testing.assert_array_equal(tc["occ"].numpy(), np.asarray(jc["occ"]))
        else:
            np.testing.assert_array_equal(tc["order"].numpy(), np.asarray(jc["order"]))
            assert tc["ks"] == jc["ks"]
            for t_occ, j_occ in zip(tc["occs"], jc["occs"]):
                assert (t_occ is None) == (j_occ is None)
                if t_occ is not None:
                    np.testing.assert_array_equal(t_occ.numpy(), np.asarray(j_occ))
            ks_seen.append(tc["ks"])
        if len(flag_runs) > n_runs:
            sizes.append(_class_sizes(flag_runs[-1]))
        for g, r in zip(got, ref):
            g, r = g.numpy(), np.asarray(r)
            assert g.shape == r.shape == (32, 32, 3) and np.isfinite(g).all()
            err = np.abs(g - r)
            assert err.max() < MAX_ERR and err.mean() < MEAN_ERR, (i, err.max(), err.mean())
    # the case is not degenerate: its classes are the ones it is meant to run
    assert sizes == SIZES[case]
    assert case == "plain" or ks_seen == [KS[case]] * 5, ks_seen


def _reference_classes(monkeypatch, flags):
    """The reference renderer's cache after one 450x450 frame under the
    given per-field flags, with its kernel and epilogue stubbed to zeros."""
    H = W = 450
    monkeypatch.setattr(jf, "conservative_occupancy", lambda *a, **k: jnp.asarray(flags))

    def zero_kernel(*args, **kw):
        n = args[2].shape[0]
        return jnp.zeros((n, 3)), jnp.zeros((n, 3))

    monkeypatch.setattr(jf, "fused_render_rays", zero_kernel)
    monkeypatch.setattr(jf, "_bg_epilogue", lambda *args, **kw: zero_kernel(*args))
    cfg = JExperimentConfig(render=JRenderConfig(
        n_samples=64, use_fused_kernel=True, spatial_tiles=True, occ_sigma_thresh=0.5,
        occ_grid_res=48, occ_tile_compaction=True, occ_refresh_every=4))
    render = j_make_frame_renderer(cfg, (H, W, 500.0, 225.0, 225.0), 0.3, 0.9)
    params = {"decoder": jax.tree.map(jnp.asarray, _decoder_params())}
    z = jnp.zeros((2, 256))
    head, _ = render(params, z, z, jnp.eye(4)[:3], jnp.eye(4)[:3], jnp.zeros(96), jnp.zeros(42),
                     jnp.zeros((H, W, 3), jnp.uint8))
    assert head.shape == (H, W, 3)
    return _ref_cache(render)


_DECODER = {}


def _decoder_params():
    if not _DECODER:
        from dfanerf_tpu.models import DecoderConfig, init_decoder

        _DECODER["p"] = jax.tree.map(np.asarray, init_decoder(jax.random.PRNGKey(0),
                                                              DecoderConfig()))
    return _DECODER["p"]


# per-field densities of flagged tiles -> the segment sizes ks they give
FULL_FRAME_KS = {
    (0.02, 0.03): (64, 0, 0),     # 2 "both" tiles: the 64-tile bucket takes every head and
                                  # torso tile, then none tiles
    (0.1, 0.6): (64, 64, 512),    # three rungs, each segment padded
    (0.3, 0.1): (64, 256, 64),
    (0.5, 0.5): (256, 256, 256),
    (0.97, 0.99): (841, 0, 0),    # the bucket is the frame: every pool runs out
}


@pytest.mark.parametrize("density", list(FULL_FRAME_KS), ids=lambda d: f"head{d[0]}-torso{d[1]}")
def test_tile_classes_match_reference_at_full_frame(monkeypatch, density):
    """841 tiles, 8 slabs, seeded flags at several densities, so the classes
    land on different rungs of the bucket ladder and the pools run out."""
    rng = np.random.RandomState(int(density[0] * 100))
    T, J = 841, 8
    tiles = np.stack([rng.rand(T) < p for p in density])                   # [2, T]
    flags = (tiles[:, :, None] & (rng.rand(2, T, J) < 0.5)).astype(np.int32)
    flags[:, :, 0] |= tiles.astype(np.int32)  # a flagged tile has a flag
    order, ks, occs = tile_classes(flags)
    jc = _reference_classes(monkeypatch, flags)
    np.testing.assert_array_equal(order, np.asarray(jc["order"]))
    assert ks == jc["ks"] == FULL_FRAME_KS[density]
    for o, j in zip(occs, jc["occs"]):
        assert (o is None) == (j is None)
        if o is not None:
            np.testing.assert_array_equal(o, np.asarray(j))
    assert sorted(order.tolist()) == list(range(T))


def test_render_config_of_the_shipped_server():
    """configs/obama_serve_tpu.json takes the tile-class branch; without
    tile compaction the plain occupancy branch."""
    cfg = ExperimentConfig.from_json("configs/obama_serve_tpu.json")
    rc = cfg.render
    assert (rc.occ_sigma_thresh, rc.occ_tile_compaction, rc.occ_pair_compaction) == (0.5, True,
                                                                                     False)
    hw = (32, 32, 35.2, 16.0, 16.0)
    small = dataclasses.replace(cfg, render=dataclasses.replace(rc, compute_dtype="float32"))
    render = make_frame_renderer(small, hw, 0.3, 0.9, device="cpu")
    gens = {"served", "gen", "gen_src"}  # every serving renderer's frame and install counts
    assert set(render.cache) == {"order", "ks", "occs", "age"} | gens and "segment" in render.stages
    plain = dataclasses.replace(small, render=dataclasses.replace(small.render,
                                                                  occ_tile_compaction=False))
    plain_cache = make_frame_renderer(plain, hw, 0.3, 0.9, device="cpu").cache
    assert set(plain_cache) == {"occ", "age"} | gens
