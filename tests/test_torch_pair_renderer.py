"""The slice as a whole: the port's pair-compacted frame renderer (plain
versions, on the CPU) against the reference package's pair-compaction
renderer (Pallas interpret mode), over 5 frames that cross two flag
refreshes, under the setup of tests/test_async_refresh.py: 32x32 synthetic
scene, 16 samples, occupancy grid 16, refresh every 2 frames, JAX init
converted to the port.

After every frame the flag state must be equal: the pair lists (the
reference pads its lists to bucket sizes with dummy-tile pairs; its prefix
before the padding is compared), the union tiles and the flags in force.
The frames differ only where a bf16 colour rounds the other way in one
sample, weighted by that sample's compositing weight. Bars: max 3e-5
(measured 1.36e-5) and mean 2e-6 (measured 8.4e-7) on both images.

Two cases: the default transmittance prune (1e-3, which random-init fields
never trigger), and a contribution prune (0.0203) that drops pairs at each
refresh, down to 2 of the 4 tiles and, on some frames, to no head pair at
all. Both have partly occupied head flags."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfanerf_tpu.config import ExperimentConfig as JExperimentConfig
from dfanerf_tpu.config import RenderConfig as JRenderConfig
from dfanerf_tpu.config import TrainConfig as JTrainConfig
from dfanerf_tpu.data import make_synthetic_dataset
from dfanerf_tpu.render.renderer import make_frame_renderer as j_make_frame_renderer
from dfanerf_tpu.train import dataset_to_device
from dfanerf_tpu.train import init_train_state as j_init_train_state
from dfanerf_torch.compat.from_jax import state_from_jax
from dfanerf_torch.config import ExperimentConfig, RenderConfig
from dfanerf_torch.models import DecoderConfig
from dfanerf_torch.ops.fused_render import field_flops_per_sample, render_flops_per_sample
from dfanerf_torch.render.renderer import make_frame_renderer

MAX_ERR, MEAN_ERR = 3e-5, 2e-6
PAIRS = dict(n_samples=16, use_fused_kernel=True, spatial_tiles=True, occ_sigma_thresh=0.18,
             occ_grid_res=16, occ_refresh_every=2, occ_pair_compaction=True, ert_eps=0.0)


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


@pytest.mark.parametrize("prune", [{}, {"occ_prune_contrib": 0.0203}],
                         ids=["default-trans-prune", "contrib-prune"])
def test_pair_renderer_matches_reference(setup, monkeypatch, prune):
    monkeypatch.setenv("DFANERF_PALLAS_INTERPRET", "1")
    ds, jstate, data, tstate = setup
    j_render = j_make_frame_renderer(JExperimentConfig(render=JRenderConfig(**PAIRS, **prune)),
                                     ds.hwfcxy, ds.near, ds.far)
    t_render = make_frame_renderer(ExperimentConfig(render=RenderConfig(**PAIRS, **prune)),
                                   ds.hwfcxy, ds.near, ds.far, device="cpu")
    sig, sig_t = np.zeros(96, np.float32), np.zeros(42, np.float32)
    pair_counts = []
    for i in range(5):
        ref = j_render(jstate["params"], jstate["z_shape"], jstate["z_app"], data["poses"][i],
                       data["poses"][0], jnp.asarray(sig), jnp.asarray(sig_t), data["bc_img"])
        got = t_render(tstate["params"], tstate["z_shape"], tstate["z_app"], ds.poses[i],
                       ds.poses[0], torch.from_numpy(sig), torch.from_numpy(sig_t), ds.bc_img)
        jc, tc = j_render.cache, t_render.cache
        np.testing.assert_array_equal(tc["tiles_u"], jc["tiles_u"])
        np.testing.assert_array_equal(tc["occ"].numpy(), np.asarray(jc["occ"]))
        counts = []
        for (t_i, j_i), (jt_i, jj_i) in zip(tc["lists"], jc["lists"]):
            k = t_i.numel()
            np.testing.assert_array_equal(t_i.numpy(), np.asarray(jt_i)[:k])
            np.testing.assert_array_equal(j_i.numpy(), np.asarray(jj_i)[:k])
            # everything past the prefix is the reference's padding
            assert (np.asarray(jt_i)[k:] == jc["tiles_sel"].shape[0]).all()
            counts.append(k)
        pair_counts.append(counts)
        assert tc["age"] == jc["age"]
        for g, r in zip(got, ref):
            g, r = g.numpy(), np.asarray(r)
            assert g.shape == r.shape == (32, 32, 3) and np.isfinite(g).all()
            err = np.abs(g - r)
            assert err.max() < MAX_ERR and err.mean() < MEAN_ERR, (i, err.max(), err.mean())
    # the case is not degenerate: head flags partly set; the prune drops
    # whole tiles and, on some frames, every head pair
    assert any(0 < k_h < 8 for k_h, _ in pair_counts)
    if prune:
        assert len(t_render.cache["tiles_u"]) < 4
        assert any(k_h == 0 for k_h, _ in pair_counts)


# cfg2 of benchmarks/serve_trained.py:313-321, verbatim: cfg1 (:246-259,
# with run()'s defaults :129-132) and the live levers
CFG2 = dict(n_samples=64, use_fused_kernel=True, compute_dtype="bfloat16", ert_eps=1e-4,
            spatial_tiles=True, occ_sigma_thresh=2.0, occ_grid_res=96, occ_refresh_every=4,
            occ_pair_compaction=True, occ_prune_contrib=0.0, occ_prune_budget=2e-3,
            occ_budget_color=True, occ_budget_iters=2, occ_prune_trans=0.1, far_skip_tol=2e-3,
            far_subsample=8, occ_prune_carry=0, occ_async_refresh=True,
            occ_prune_hist_decay=0.8, occ_live_keys=True)


def test_unported_levers_raise():
    """Config 3's live levers are ported: cfg2 builds, with its refresh
    worker exposed (tests/test_torch_live_serving.py drives them). What is
    left is precompile_headroom, the reference's off-stream compile of
    program classes, which raises naming its ROADMAP place."""
    hw = (32, 32, 35.2, 16.0, 16.0)
    cfg = ExperimentConfig(decoder=DecoderConfig(density_activation="softplus"),
                           render=RenderConfig(**CFG2))
    render = make_frame_renderer(cfg, (450, 450, 1200.0, 225.0, 225.0), 0.3, 0.9, device="cpu")
    assert render.cache["lists"] is None
    assert render.worker["thread"] is None and render.worker["fails"] == 0
    base = ExperimentConfig(render=RenderConfig(**PAIRS))
    for lever in ({}, {"occ_pack2": True, "occ_async_refresh": True}):
        cfg = dataclasses.replace(base, render=dataclasses.replace(base.render, **lever))
        render = make_frame_renderer(cfg, hw, 0.3, 0.9, device="cpu")
        for args in ((), (0, 1)):
            with pytest.raises(NotImplementedError, match="ROADMAP.md queue 2, R10\\)"):
                render.precompile_headroom(*args)


def test_flop_counts_per_field_and_kernel():
    """Both fields with both heads still count the dense kernel's 2,368,768
    FLOP per sample; each kernel's count drops the heads it does not run."""
    head, torso = field_flops_per_sample("head"), field_flops_per_sample("torso")
    assert head + torso == render_flops_per_sample() == 2_368_768
    assert field_flops_per_sample("head", color=False) == head - 2 * (256 * 256 + 256 * 3)
    assert field_flops_per_sample("torso", sigma=False) == torso - 2 * 256


def _debug_lines(out: str):
    """(tag, integer fields) of each [tag] line: floats are left out."""
    lines = []
    for line in out.splitlines():
        m = re.match(r"^\[([^\]]+)\]\s*(.*)$", line)
        if m:
            ints = re.findall(r"(\w+)=(-?\d+)(?![\d.])", m.group(2))
            lines.append((m.group(1), ints))
    return lines


def test_debug_compaction_lines_match_reference(setup, monkeypatch, capsys):
    """DFANERF_DEBUG_COMPACTION: over 3 frames (refreshes at frames 0 and
    2) with the contribution prune, the port prints the reference's lines,
    with the same tags ([pairs:flags], [pairs:pruned]) and the same
    integer counts; with the variable unset it prints none."""
    monkeypatch.setenv("DFANERF_PALLAS_INTERPRET", "1")
    ds, jstate, data, tstate = setup
    rcfg = dict(PAIRS, occ_prune_contrib=0.0203)
    j_render = j_make_frame_renderer(JExperimentConfig(render=JRenderConfig(**rcfg)),
                                     ds.hwfcxy, ds.near, ds.far)
    t_render = make_frame_renderer(ExperimentConfig(render=RenderConfig(**rcfg)),
                                   ds.hwfcxy, ds.near, ds.far, device="cpu")
    sig, sig_t = np.zeros(96, np.float32), np.zeros(42, np.float32)
    monkeypatch.setenv("DFANERF_DEBUG_COMPACTION", "1")
    capsys.readouterr()
    for i in range(3):
        j_render(jstate["params"], jstate["z_shape"], jstate["z_app"], data["poses"][i],
                 data["poses"][0], jnp.asarray(sig), jnp.asarray(sig_t), data["bc_img"])
    want = _debug_lines(capsys.readouterr().out)
    for i in range(3):
        t_render(tstate["params"], tstate["z_shape"], tstate["z_app"], ds.poses[i], ds.poses[0],
                 torch.from_numpy(sig), torch.from_numpy(sig_t), ds.bc_img)
    got = _debug_lines(capsys.readouterr().out)
    assert [tag for tag, _ in want] == ["pairs:flags", "pairs:pruned"] * 2
    assert got == want
    monkeypatch.delenv("DFANERF_DEBUG_COMPACTION")
    for i in (3, 4):  # frame 4 refreshes
        t_render(tstate["params"], tstate["z_shape"], tstate["z_app"], ds.poses[i], ds.poses[0],
                 torch.from_numpy(sig), torch.from_numpy(sig_t), ds.bc_img)
    assert t_render.cache["age"] == 1
    assert capsys.readouterr().out == ""
