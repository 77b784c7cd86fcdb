"""The pair renderer's offline window mode, ``render.refresh_union``, in the
port (plain versions, on the CPU) against the reference package's (Pallas
interpret mode), with occ_pack2 off and on, under the setup of
tests/test_torch_pack2_renderer.py and a contribution prune that drops
pairs (so the union and the per-frame states differ).

Over a window of 4 prepped frames:
- ``per_slot=False``: the union of the frames' flags, pruned to the pairs
  some frame's composite sees. The pinned state must equal the reference's
  and stay in force: two more frames render under it without a refresh,
  although their age passes ``occ_refresh_every``.
- ``per_slot=True``: each frame's own pruned state as a slot (and the union
  again). Every slot's state must equal the reference's, and
  ``render(..., window_slot=i)`` renders under slot i % 4 (frames 0 and 3
  under their own slots, frame 5 under slot 1).
Frames are held to the bars of tests/test_torch_pair_renderer.py, max 3e-5
and mean 2e-6."""

import numpy as np
import pytest
from test_torch_pack2_renderer import (
    assert_frames_close, assert_state_equal, frame_args, renderers, setup,  # noqa: F401
)

BASE = dict(n_samples=16, use_fused_kernel=True, spatial_tiles=True, occ_sigma_thresh=0.18,
            occ_grid_res=16, occ_refresh_every=2, occ_pair_compaction=True, ert_eps=0.0)
# contribution prunes that drop some pairs of each frame: 8-sample slabs as
# in tests/test_torch_pair_renderer.py, half-slabs as in
# tests/test_torch_pack2_renderer.py
CASES = {"pack2-off": dict(occ_pack2=False, occ_prune_contrib=0.0203),
         "pack2-on": dict(occ_pack2=True, occ_prune_contrib=0.0108)}
WINDOW = 4


@pytest.mark.parametrize("case", list(CASES.values()), ids=list(CASES))
def test_refresh_union_matches_reference(setup, monkeypatch, case):  # noqa: F811
    monkeypatch.setenv("DFANERF_PALLAS_INTERPRET", "1")
    pack2 = case["occ_pack2"]
    j_render, t_render = renderers(setup[0], **BASE, **case)
    args = [frame_args(setup, i) for i in range(6)]
    window_j = [j_render.inputs_fn(*j) for j, _ in args[:WINDOW]]
    window_t = [t_render.inputs_fn(*t) for _, t in args[:WINDOW]]
    jc, tc = j_render.cache, t_render.cache

    j_render.refresh_union(window_j)
    t_render.refresh_union(window_t)
    assert tc["pinned"] and jc["pinned"] and tc["slots"] == [] == jc["slots"]
    union = assert_state_equal(tc, jc, pack2)
    for i in (4, 5):  # ages 1 and 2: past the cadence, yet no refresh
        assert_frames_close(t_render(*args[i][1]), j_render(*args[i][0]), f"pinned frame {i}")
        assert tc["age"] == jc["age"] == i - 3
        assert assert_state_equal(tc, jc, pack2) == union

    j_render.refresh_union(window_j, per_slot=True)
    t_render.refresh_union(window_t, per_slot=True)
    assert assert_state_equal(tc, jc, pack2) == union and tc["pinned"]
    assert len(tc["slots"]) == len(jc["slots"]) == WINDOW
    slot_counts = [assert_state_equal(ts, js, pack2) for ts, js in zip(tc["slots"], jc["slots"])]
    # the union lists every pair some slot lists, and more than one slot
    for f in range(2):
        assert union[f] >= max(c[f] for c in slot_counts)
    assert any(c != union for c in slot_counts)
    for t_slot in tc["slots"]:
        assert not np.setdiff1d(t_slot["tiles_u"], tc["tiles_u"]).size
    for i, slot in ((0, 0), (3, 3), (5, 5)):  # slot 5 % 4 = 1 serves frame 5
        got = t_render(*args[i][1], window_slot=slot)
        ref = j_render(*args[i][0], window_slot=slot)
        assert_frames_close(got, ref, f"frame {i} under slot {slot % WINDOW}")
