"""Config 3's live serving levers in the port's pair renderer (plain
versions, on the CPU) against the reference package's (Pallas interpret
mode): the served frames' own prune keys, the decayed prune history and the
async double-buffered refresh, under the setup of
tests/test_torch_pack2_renderer.py (32x32 synthetic scene, 16 samples,
occupancy grid 16, JAX init converted to the port).

- ``deferred_composite(with_keys=True)`` against the reference's on seeded
  pair buffers (NaN in every unlisted block): mass and colour keys, at 8
  and 4 samples per slab and with the packed-2 partitions, at DIAG_BAR
  1e-6.
- The live renderer of the reference's test_live_keys_derive_matches_noskip
  (tests/test_async_refresh.py:262-300: async, live keys, colour-keyed
  budget, hist decay 0.8, remeasure 3, refresh every frame, and the
  default occ_class_clamp, on), at the occupancy threshold and budget
  where this scene's flags are mixed and the budget drops pairs (0.18 and
  1e-2; the reference's 0.05 and 1e-3 occupy and keep every pair here),
  over 8 frames. Each worker is run to its end after its frame in both
  packages (``DeferredWorker``), so each swap lands on the same frame.
  After every frame these equal the reference's: the flag state, age,
  rjit, swaps, derive_ct, the key frames (count, union tiles and keys),
  ever_measured, the keep-masks and the history; the frames are held to
  the pair renderer's bars, max 3e-5 and mean 2e-6. prune_flags runs with
  the history three times (the synchronous refresh of frame 0, the full
  derives 0 and 3 of frames 1 and 7); derives 1 and 2 come from the keys
  and drop pairs. The keys and the history come from each package's own
  pair buffers, which differ as the frames do: held within KEY_BAR 1e-5
  (measured 3.5e-6 at most, a slab-start transmittance).

The reference pads its lists into program classes and, under
occ_class_clamp, re-pads a fresh state onto a class already run, which
leaves its frames bit for bit as they are (renderer.py :1442-1450); the
port lists exactly K pairs and compiles nothing per class, so its frames
equal the reference's with the clamp on (at this size every state falls
into the reference's smallest class). The reference's worker also renders
a throwaway frame under a state whose class has not run yet, only to
compile it (:1530-1541), and that frame's run_fast stashes its keys beside
the served frames'. The port renders no such frame; the reference's
key-frame deque here keeps the served frames' stashes only
(``ServedFrames``), so both packages aggregate the same frames."""

import threading
from collections import deque

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_composite import OCC4, _partition
from test_torch_pack2_renderer import (
    assert_frames_close, assert_state_equal, frame_args, renderers, setup,  # noqa: F401
)

import dfanerf_torch.render.renderer as t_renderer
from dfanerf_tpu.ops import fused_render as jf
from dfanerf_torch.ops.composite import deferred_composite

DIAG_BAR = 1e-6
# Keys and history of the renderers: each package composites its own pair
# buffers, whose densities and bf16 colours differ as the frames do.
KEY_BAR = 1e-5
LIVE = dict(n_samples=16, use_fused_kernel=True, spatial_tiles=True, occ_sigma_thresh=0.18,
            occ_grid_res=16, occ_refresh_every=1, occ_pair_compaction=True,
            occ_prune_budget=1e-2, occ_budget_color=True, occ_prune_trans=0.01,
            occ_prune_carry=0, ert_eps=0.0, occ_async_refresh=True, occ_prune_hist_decay=0.8,
            occ_live_keys=True, occ_live_remeasure=3)


N_RAYS = 512  # two tiles


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
def buffers():
    """Seeded pair buffers (sigma, r, g, b), each [J, sp, 3 * 256] (two
    tiles and the row past them), with NaN in every block the flags clear,
    at 8 and 4 samples per slab, and the rays, depths and background."""
    rng = np.random.default_rng(7)

    def bufs(flags, sp):
        J = flags.shape[1]
        out = []
        for c in range(4):
            x = (rng.uniform(0.0, 6.0, (J, sp, 3, 256)) if c == 0
                 else rng.uniform(0.0, 1.0, (J, sp, 3, 256))).astype(np.float32)
            for t in range(2):
                for j in range(J):
                    if not flags[t, j]:
                        x[j, :, t] = np.nan
            x[:, :, 2] = np.nan
            out.append(x.reshape(J, sp, 3 * 256))
        return tuple(out)

    occ8 = np.array([[[1, 0], [1, 1]], [[0, 1], [1, 1]]], np.int32)  # [field, tile, slab]
    return {8: (occ8, bufs(occ8[0], 8), bufs(occ8[1], 8)),
            4: (OCC4, bufs(OCC4[0], 4), bufs(OCC4[1], 4)),
            "rd": (rng.normal(size=(N_RAYS, 3)) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32),
            "rd_t": (rng.normal(size=(N_RAYS, 3)) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32),
            "z": np.linspace(0.3, 0.9, 16, dtype=np.float32),
            "bc": rng.uniform(0.0, 1.0, (N_RAYS, 3)).astype(np.float32)}


@pytest.mark.parametrize("color", [False, True], ids=["mass", "colour"])
@pytest.mark.parametrize("sp,packed", [(8, False), (4, False), (4, True)],
                         ids=["sp8", "sp4", "sp4-packed-2"])
def test_keys_match_reference(buffers, sp, packed, color):
    occ, bh, bt = buffers[sp]
    kw = dict(with_diagnostics=False, s_slab=sp, with_keys=True)
    kw_j, kw_t = dict(kw), dict(kw)
    if color:
        kw_j["ray_err_bc"] = jnp.asarray(buffers["bc"])
        kw_t["ray_err_bc"] = torch.from_numpy(buffers["bc"])
    if packed:
        # the same buffers read through the disjoint A and B flags
        occ, occ2 = _partition(OCC4)
        kw_j.update(buf_h2=tuple(jnp.asarray(b) for b in bh),
                    buf_t2=tuple(jnp.asarray(b) for b in bt), occ2=jnp.asarray(occ2))
        kw_t.update(buf_h2=tuple(torch.from_numpy(b) for b in bh),
                    buf_t2=tuple(torch.from_numpy(b) for b in bt), occ2=torch.from_numpy(occ2))
    args = [buffers[k] for k in ("rd", "rd_t", "z")]
    ref = jf.deferred_composite(tuple(jnp.asarray(b) for b in bh),
                                tuple(jnp.asarray(b) for b in bt), jnp.asarray(occ),
                                *(jnp.asarray(x) for x in args), **kw_j)
    got = deferred_composite(tuple(torch.from_numpy(b) for b in bh),
                             tuple(torch.from_numpy(b) for b in bt), torch.from_numpy(occ),
                             *(torch.from_numpy(x) for x in args), **kw_t)
    assert len(got) == len(ref) == 5 and len(got[4]) == len(ref[4]) == 4
    for g, r in zip(list(got[:4]) + list(got[4]), list(ref[:4]) + list(ref[4])):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape and torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), r, atol=DIAG_BAR, rtol=0)
    assert tuple(got[4][0].shape) == (2, 16 // sp)
    assert float(got[4][2].max()) > 0.05 and float(got[4][3].max()) > 0.05  # real costs
    assert float(got[4][1].min()) < 0.5  # transmittances well below 1


def _equal_hist(th, jh):
    assert set(th) == set(jh)
    for name in th:
        np.testing.assert_allclose(th[name], np.asarray(jh[name]), atol=KEY_BAR, rtol=0,
                                   err_msg=name)


class DeferredWorker(threading.Thread):
    """threading.Thread for the refresh workers of both packages: a worker
    starts when ``run_workers`` runs it, after its frame has returned (the
    port starts its worker then; the reference starts its own before it
    serves the frame, and which thread stashes or reads the keys first
    would decide what the derive sees)."""

    pending = []

    def start(self):
        if getattr(self._target, "__name__", "").lstrip("_") != "refresh_async":
            return super().start()
        DeferredWorker.pending.append(self)


def run_workers():
    while DeferredWorker.pending:
        th = DeferredWorker.pending.pop()
        super(DeferredWorker, th).start()
        th.join(timeout=300.0)
        assert not th.is_alive()


class ServedFrames(deque):
    """The reference's key-frame deque, keeping what the serving (main)
    thread stashes; ``dropped`` counts the worker's throwaway stashes."""

    def __init__(self):
        super().__init__(maxlen=12)
        self.dropped = 0

    def append(self, x):
        if threading.current_thread() is threading.main_thread():
            super().append(x)
        else:
            self.dropped += 1


def test_live_async_matches_reference(setup, monkeypatch):  # noqa: F811
    monkeypatch.setenv("DFANERF_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(threading, "Thread", DeferredWorker)
    flags = []
    real = t_renderer.conservative_occupancy
    monkeypatch.setattr(t_renderer, "conservative_occupancy",
                        lambda *a, **kw: flags.append(real(*a, **kw)) or flags[-1])
    j_render, t_render = renderers(setup[0], **LIVE)
    jc, tc = j_render.cache, t_render.cache
    jc["key_frames"] = ServedFrames()
    derives = []  # (kind, pairs the derived state drops)
    for i in range(8):
        j_args, t_args = frame_args(setup, i % 6)
        ref = j_render(*j_args)
        n_derive = tc.get("derive_ct", 0)
        got = t_render(*t_args)
        run_workers()
        assert t_render.worker["error"] is None and j_render.worker["error"] is None
        assert_state_equal(tc, jc, pack2=False)
        for key in ("age", "rjit", "swaps", "derive_ct"):
            assert tc.get(key) == jc.get(key), (i, key)
        assert len(tc.get("key_frames", ())) == len(jc["key_frames"]) == i
        for (keys, tiles_u, _), (j_keys, j_tiles_u) in zip(tc.get("key_frames", ()),
                                                           jc["key_frames"]):
            np.testing.assert_array_equal(tiles_u, j_tiles_u)
            for k, r in zip(keys, j_keys):
                np.testing.assert_allclose(k.numpy(), np.asarray(r)[:len(tiles_u)],
                                           atol=KEY_BAR, rtol=0)
        em = tc.get("ever_measured")
        assert (em is None) == (jc.get("ever_measured") is None)
        if em is not None:
            np.testing.assert_array_equal(em, np.asarray(jc["ever_measured"]))
        for k, r in zip(tc["keeps"], jc["keeps"]):
            np.testing.assert_array_equal(k, np.asarray(r))
        _equal_hist(tc["hist"], jc["hist"])
        assert_frames_close(got, ref, i)
        if tc.get("derive_ct", 0) > n_derive:
            # this frame's worker derived a state (it lands at the next
            # frame) from the flags it measured
            st = t_render.worker["result"][0]
            derives.append(("full" if n_derive % LIVE["occ_live_remeasure"] == 0 else "keys",
                            int(flags[-1].sum()) - sum(int(t.numel()) for t, _ in st["lists"])))
    assert t_render.worker["fails"] == 0
    assert jc["key_frames"].dropped == 1  # the reference's one throwaway frame
    kinds = [kind for kind, _ in derives]
    assert kinds == ["full", "keys", "keys", "full", "keys", "keys"][:len(kinds)]
    assert tc["swaps"] == len(derives) - 1  # the last one lands at the next frame
    assert any(d > 0 for kind, d in derives if kind == "keys"), derives
    assert set(tc["hist"]) == {"tm_h", "tm_c", "wr_h", "wr_t", "ktm_h", "ktm_c", "ke_h", "ke_t"}

