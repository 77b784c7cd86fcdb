"""BASELINE config 3's per-slot refinement in the port's pair renderer
(plain versions, on the CPU) against the reference package's (Pallas
interpret mode), under the setup and settings of
tests/test_torch_serve_levers.py: ``refresh_union(per_slot=True)`` with
``occ_budget_iters=2`` over a window of 2 frames. Every slot must equal the
reference's, ``far_skip`` and ``far_cmix_err`` included, with colour keys
at occ_pack2 off and on and with mass keys; where the case's budget leaves
the refinement room, it must drop a pair in some slot. Frames served under
each slot are held to tests/test_torch_pair_renderer.py's bars, max 3e-5
and mean 2e-6."""

import numpy as np
import pytest
from test_torch_pack2_renderer import (  # noqa: F401
    assert_frames_close, assert_state_equal, frame_args, renderers, setup,
)
from test_torch_serve_levers import BASE, CMIX_ATOL, CMIX_RTOL, one_thread  # noqa: F401


# (render options, whether a refinement round drops a pair in some slot).
# On this scene the refinement's room lies in narrow budget windows: with
# colour keys, searched over occupancy thresholds 0.12-0.2 and budgets
# 2e-3-3e-2, the round drops nothing more at occ_pack2 off, and at 0.0118
# (threshold 0.16) one pair in frame 0's slot with occ_pack2 on; with
# mass keys at 0.0245 it drops 2-4 pairs in every slot. No tile reverted in
# any of these.
SLOTS = {"colour-pack2-off": (dict(occ_pack2=False, occ_prune_budget=1e-2), False),
         "colour-pack2-on": (dict(occ_pack2=True, occ_prune_budget=0.0118,
                                  occ_sigma_thresh=0.16), True),
         "mass-pack2-off": (dict(occ_pack2=False, occ_prune_budget=0.0245,
                                 occ_budget_color=False), True)}
WINDOW = 2


@pytest.mark.parametrize("case,refines", list(SLOTS.values()), ids=list(SLOTS))
def test_per_slot_refinement_matches_reference(setup, monkeypatch, case, refines):  # noqa: F811
    monkeypatch.setenv("DFANERF_PALLAS_INTERPRET", "1")
    pack2 = case["occ_pack2"]
    j_render, t_render = renderers(setup[0], **dict(BASE, **case), occ_budget_iters=2,
                                   far_skip_tol=2e-3, far_subsample=8)
    args = [frame_args(setup, i) for i in range(WINDOW)]
    j_render.refresh_union([j_render.inputs_fn(*j) for j, _ in args], per_slot=True)
    t_render.refresh_union([t_render.inputs_fn(*t) for _, t in args], per_slot=True)
    jc, tc = j_render.cache, t_render.cache
    assert len(tc["slots"]) == WINDOW
    for ts, js in zip(tc["slots"], jc["slots"]):
        assert_state_equal(ts, js, pack2)
        assert ts["far_skip"] is js["far_skip"]
        np.testing.assert_allclose(ts["far_cmix_err"], js["far_cmix_err"], rtol=CMIX_RTOL,
                                   atol=CMIX_ATOL)
    assert_state_equal(tc, jc, pack2)
    prep = tc["slot_prep"]
    assert all(len(p["pairs"]) == 3 for p in prep)  # unpruned, round 1, round 2
    assert any(p["pairs"][1] != p["pairs"][0] for p in prep)  # round 1 drops pairs
    assert any(p["refined"][0] for p in prep) == refines, prep
    for i in range(WINDOW):
        got = t_render(*args[i][1], window_slot=i)
        ref = j_render(*args[i][0], window_slot=i)
        assert_frames_close(got, ref, f"frame {i} under slot {i}")
