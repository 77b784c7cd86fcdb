"""BASELINE config 3's offline serving levers in the port's pair renderer
(plain versions, on the CPU) against the reference package's (Pallas
interpret mode): the budgeted prune with colour keys and its per-slot
refinement with verify-and-revert, far_skip_tol, far_subsample and
occ_prune_carry, under the setup of tests/test_torch_pack2_renderer.py
(32x32 synthetic scene, 16 samples, occupancy grid 16, JAX init converted
to the port).

- ``budget_drop_masks``, a copy of the reference's host numpy, must give
  the same drops bit for bit on seeded random ledgers, with and without a
  measured base.
- ``deferred_composite(with_ray_diag=True)`` against the reference's on
  the buffers of tests/test_torch_composite.py, in mass and colour mode, at
  8 and 4 samples per slab. The two sides run the same expressions in
  another float32 order: measured 2.4e-7 at most on every output (colour
  keys up to 0.48), against that file's bar of 1e-6.
- The live renderer (refresh every 2, colour-keyed budget, occ_prune_carry
  1, far_subsample 8 and 2) over 6 frames: full refreshes at frames 0 and
  4, a carried one at frame 2. The flag state, ``age`` and ``keep_age``
  must equal the reference's after every frame; steady and carried frames
  are fast frames (far plane on the subgrid), refresh frames pipeline
  frames (tests/test_torch_serve_levers_live.py).
- ``refresh_union(per_slot=True)`` with ``occ_budget_iters=2``: every slot
  equal, ``far_skip`` and ``far_cmix_err`` included, with colour keys at
  occ_pack2 off and on and with mass keys; where the case's budget leaves
  the refinement room, it must drop a pair in some slot
  (tests/test_torch_serve_levers_slots.py).
- ``far_skip_tol`` 1.0 (taken) and 1e-9 (not taken, in the live test):
  the same decision and measured error as the reference, and under the
  skip no far-plane evaluation in a served frame; with it, the revert of
  verify-and-revert, reached by making the refinement drop every
  candidate in both packages.

The budgets sit where the colour keys of this scene drop some pairs and
keep others; no decision here is a near-tie (the states are equal). Frames
are held to tests/test_torch_pair_renderer.py's bars, max 3e-5 and mean
2e-6. The live-lever and per-slot cases have files of their own, each on
its own worker of the parallel suite; they share this file's settings."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_composite import OCC4
from test_torch_composite import setup as composite_setup  # noqa: F401
from test_torch_pack2_renderer import (
    assert_frames_close, assert_state_equal, frame_args, renderers, setup,  # noqa: F401
)

import dfanerf_torch.render.renderer as t_renderer
from dfanerf_tpu.ops import fused_render as jf
from dfanerf_tpu.render.renderer import budget_drop_masks as j_budget_drop_masks
from dfanerf_torch.ops.composite import deferred_composite
from dfanerf_torch.render.renderer import budget_drop_masks

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch single-threaded for this module: its renders are small, and the
    intra-op threads of six suite workers on a few cores cost more than they
    save."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BASE = dict(n_samples=16, use_fused_kernel=True, spatial_tiles=True, occ_sigma_thresh=0.18,
            occ_grid_res=16, occ_refresh_every=2, occ_pair_compaction=True, ert_eps=0.0,
            occ_prune_trans=0.1, occ_budget_color=True)
DIAG_BAR = 1e-6
# far_cmix_err = max |c_mix - bc| is a difference of two colours in [0, 1]
# that agree to ~4e-5, so float32 resolves it only to their ulp: measured
# 3.5882e-05 against the reference's 3.5822e-05 (6e-8 apart, one ulp at
# 0.5). Held to rtol 1e-4 with an absolute floor of two ulps at 0.5.
CMIX_RTOL, CMIX_ATOL = 1e-4, 1.2e-7


@pytest.mark.parametrize("with_base", [False, True], ids=["no-base", "base"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_budget_drop_masks_match_reference(seed, with_base):
    rng = np.random.default_rng(seed)
    J, K, R = 8, 12, 256
    wr_h, wr_t = (rng.uniform(0, 4e-3, (J, K, R)).astype(np.float32) for _ in range(2))
    cand = rng.random((2, K, J)) < 0.7
    base = rng.uniform(0, 5e-3, (K, R)).astype(np.float32) if with_base else None
    for budget in (1e-3, 6e-3, 2e-2):
        got = budget_drop_masks(wr_h, wr_t, cand, budget, base=base)
        ref = j_budget_drop_masks(wr_h, wr_t, cand, budget, base=base)
        np.testing.assert_array_equal(got, ref)
        assert not (got & ~cand).any()
    assert got.any() and (cand & ~got).any()  # the largest budget drops some, not all


@pytest.mark.parametrize("color", [False, True], ids=["mass", "colour"])
@pytest.mark.parametrize("sp", [8, 4])
def test_ray_diag_matches_reference(composite_setup, sp, color):  # noqa: F811
    s = composite_setup
    occ, bh, bt = ((s["occ"], s["buf_h"], s["buf_t"]) if sp == 8
                   else (OCC4, s["buf4_h"], s["buf4_t"]))
    ref = jf.deferred_composite(
        tuple(jnp.asarray(b) for b in bh), tuple(jnp.asarray(b) for b in bt), jnp.asarray(occ),
        jnp.asarray(s["rd"]), jnp.asarray(s["rd_t"]), jnp.asarray(s["z"]), s_slab=sp,
        with_ray_diag=True, ray_err_bc=jnp.asarray(s["bc"]) if color else None)
    got = deferred_composite(
        tuple(torch.from_numpy(b) for b in bh), tuple(torch.from_numpy(b) for b in bt),
        torch.from_numpy(occ), torch.from_numpy(s["rd"]), torch.from_numpy(s["rd_t"]),
        torch.from_numpy(s["z"]), s_slab=sp, with_ray_diag=True,
        ray_err_bc=torch.from_numpy(s["bc"]) if color else None)
    assert len(got) == len(ref) == 10
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape and torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), r, atol=DIAG_BAR, rtol=0)
    J = 16 // sp
    assert tuple(got[8].shape) == (J, 2, 256)
    assert float(got[8].max()) > 0.05 and float(got[9].max()) > 0.05  # real costs


def _far_calls(monkeypatch):
    """Records the rows of each far-plane evaluation of the port's renderer."""
    calls = []
    real = t_renderer.fused_far_eval_split

    def counted(*a, **kw):
        calls.append(a[2].shape[0])
        return real(*a, **kw)

    monkeypatch.setattr(t_renderer, "fused_far_eval_split", counted)
    return calls


def test_far_skip_and_revert_match_reference(setup, monkeypatch):  # noqa: F811
    """far_skip_tol 1.0 (the skip is taken; the live test's second case
    measures a tolerance it is not taken at) and the revert of
    verify-and-revert, which the budgets above never reach: in both
    packages the refinement round drops every candidate
    (``budget_drop_masks`` given a measured base returns the candidates),
    so the verify render finds tiles whose error grew by more than the
    budget and restores their round-1 drops. The slot must equal the
    reference's, far_skip and far_cmix_err included, with tiles reverted,
    and its frame must evaluate no far plane."""
    import dfanerf_tpu.render.renderer as j_renderer

    monkeypatch.setenv("DFANERF_PALLAS_INTERPRET", "1")
    for module in (j_renderer, t_renderer):
        real = module.budget_drop_masks
        monkeypatch.setattr(module, "budget_drop_masks",
                            lambda *a, base=None, _real=real: (a[2].copy() if base is not None
                                                               else _real(*a)))
    calls = _far_calls(monkeypatch)
    j_render, t_render = renderers(setup[0], **BASE, occ_prune_budget=1e-2, occ_budget_iters=2,
                                   far_skip_tol=1.0, far_subsample=2)
    args = frame_args(setup, 0)
    j_render.refresh_union([j_render.inputs_fn(*args[0])], per_slot=True)
    t_render.refresh_union([t_render.inputs_fn(*args[1])], per_slot=True)
    ts, js = t_render.cache["slots"][0], j_render.cache["slots"][0]
    assert_state_equal(ts, js, pack2=False)
    assert ts["far_skip"] is js["far_skip"] is True
    np.testing.assert_allclose(ts["far_cmix_err"], js["far_cmix_err"], rtol=CMIX_RTOL,
                               atol=CMIX_ATOL)
    prep = t_render.cache["slot_prep"][0]
    assert prep["refined"][0] > 0 and prep["reverted"][0] > 0, prep
    # the prep measured c_mix at every ray (slot, union); no render evaluated the far plane
    assert calls == [1024, 1024]
    assert_frames_close(t_render(*args[1], window_slot=0), j_render(*args[0], window_slot=0),
                        "frame 0 under its slot")
    assert calls == [1024, 1024]


# cfg1 of benchmarks/serve_trained.py:246-259 with run()'s defaults
# (:129-132), the bench headline's render config, verbatim
CFG1 = dict(n_samples=64, use_fused_kernel=True, compute_dtype="bfloat16", ert_eps=1e-4,
            spatial_tiles=True, occ_sigma_thresh=2.0, occ_grid_res=96, occ_refresh_every=8,
            occ_pair_compaction=True, occ_prune_contrib=0.0, occ_prune_budget=2e-3,
            occ_budget_color=True, occ_budget_iters=2, occ_prune_trans=0.1, far_skip_tol=2e-3,
            far_subsample=8, occ_prune_carry=3)


def test_cfg1_builds():
    """The port builds cfg1's render config (chip_smoke.py serves it on the
    card; at grid 96 and 64 samples the CPU plain versions are too slow for
    this suite)."""
    from dfanerf_torch.config import ExperimentConfig, RenderConfig
    from dfanerf_torch.models import DecoderConfig
    from dfanerf_torch.render.renderer import make_frame_renderer

    cfg = ExperimentConfig(decoder=DecoderConfig(density_activation="softplus"),
                           render=RenderConfig(**CFG1))
    render = make_frame_renderer(cfg, (450, 450, 1200.0, 225.0, 225.0), 0.3, 0.9, device="cpu")
    assert callable(render.refresh_union) and render.cache["lists"] is None
