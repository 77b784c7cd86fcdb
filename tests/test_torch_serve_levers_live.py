"""BASELINE config 3's live serving levers in the port's pair renderer
(plain versions, on the CPU) against the reference package's (Pallas
interpret mode), under the setup and settings of
tests/test_torch_serve_levers.py: the live renderer (refresh every 2,
colour-keyed budget, occ_prune_carry 1, far_subsample 8 and 2) over 6
frames, full refreshes at frames 0 and 4, a carried one at frame 2. The
flag state, ``age`` and ``keep_age`` must equal the reference's after every
frame; steady and carried frames are fast frames (far plane on the
subgrid), refresh frames pipeline frames; far_skip_tol 1e-9 measures the
far plane's error without taking the skip. Frames are held to
tests/test_torch_pair_renderer.py's bars, max 3e-5 and mean 2e-6."""

import numpy as np
import pytest
from test_torch_pack2_renderer import (  # noqa: F401
    assert_frames_close, assert_state_equal, frame_args, renderers, setup,
)
from test_torch_serve_levers import BASE, CMIX_ATOL, CMIX_RTOL, _far_calls, one_thread  # noqa: F401

import dfanerf_torch.render.renderer as t_renderer

LIVE = dict(BASE, occ_prune_budget=1e-2, occ_prune_carry=1)


# (far_subsample, far_skip_tol): the second case also measures the far
# plane's c_mix error at every refresh, carried ones included, and keeps it
@pytest.mark.parametrize("ss,tol", [(8, 0.0), (2, 1e-9)], ids=["ss8", "ss2-far-measured"])
def test_live_levers_match_reference(setup, monkeypatch, ss, tol):  # noqa: F811
    monkeypatch.setenv("DFANERF_PALLAS_INTERPRET", "1")
    flags = []
    real = t_renderer.conservative_occupancy
    monkeypatch.setattr(t_renderer, "conservative_occupancy",
                        lambda *a, **kw: flags.append(real(*a, **kw)) or flags[-1])
    calls = _far_calls(monkeypatch)
    j_render, t_render = renderers(setup[0], **LIVE, far_subsample=ss, far_skip_tol=tol)
    jc, tc = j_render.cache, t_render.cache
    kinds, dropped, steady_calls = [], 0, []
    for i in range(6):
        j_args, t_args = frame_args(setup, i)
        ref = j_render(*j_args)
        n_flags, n_calls = len(flags), len(calls)
        got = t_render(*t_args)
        counts = assert_state_equal(tc, jc, pack2=False)
        assert (tc["age"], tc["keep_age"]) == (jc["age"], jc["keep_age"]), i
        assert tc["far_skip"] is jc["far_skip"] is False
        if tol > 0:
            np.testing.assert_allclose(tc["far_cmix_err"], jc["far_cmix_err"], rtol=CMIX_RTOL,
                                       atol=CMIX_ATOL)
        assert_frames_close(got, ref, i)
        kinds.append((tc["age"], tc["keep_age"]))
        if len(flags) > n_flags:  # a refresh: the pruned lists against its flags
            dropped += int(flags[-1].sum()) - sum(counts)
        else:
            steady_calls.append(calls[n_calls:])
    # full refresh, steady, carried refresh, steady, full refresh, steady
    assert kinds == [(1, 0), (2, 0), (1, 1), (2, 1), (1, 0), (2, 0)]
    assert len(flags) == 3 and dropped > 0
    # a steady frame evaluates the far plane once, on the subgrid of 4 tiles
    assert steady_calls == [[4 * (16 // ss) ** 2]] * 3
