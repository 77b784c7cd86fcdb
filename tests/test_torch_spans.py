"""The port's span API (dfanerf_torch/spans.py) and the spans and list
generations of its serving renderers, on the CPU (plain versions): off it
records nothing and hands out one shared context; on it nests, keeps each
thread's spans apart and reads perf_counter_ns; a tile-class frame, a
hierarchical pair frame and an async pair frame carry their stage spans,
refresh frames their occupancy download and lists and steady frames neither;
frames are bit-identical with recording on and off; ``[hier:t]`` keeps the
reference's tags; the train stages are still torch.profiler ranges; and
``render.cache``'s ``gen`` / ``gen_src`` follow the synchronous, carried and
worker refreshes of tests/test_async_refresh.py's runs.

The scene: the port's synthetic dataset at 32x32 and its own seeded init
(no JAX), 16 samples, grid 16; a threshold of 0.1 flags every tile at these
frames (random-init densities), so every stage runs."""

import re
import threading
import time

import pytest
import torch

from dfanerf_torch import spans
from dfanerf_torch.config import ExperimentConfig, RenderConfig, TrainConfig
from dfanerf_torch.data.synthetic import make_synthetic_dataset
from dfanerf_torch.models import DecoderConfig
from dfanerf_torch.ops import _build
from dfanerf_torch.render.renderer import (
    encode_frame_signals, make_frame_renderer, make_head_hierarchical_renderer,
)
from dfanerf_torch.train.state import init_train_state
from dfanerf_torch.train.step import STAGES, dataset_to_device, make_train_step

N_FRAMES = 4
TILES = dict(n_samples=16, use_fused_kernel=True, spatial_tiles=True, occ_grid_res=16,
             occ_refresh_every=2, ert_eps=1e-4, occ_sigma_thresh=0.1, occ_tile_compaction=True)
HIER = dict(n_samples=16, n_importance=16, use_fused_kernel=True, occ_grid_res=16, ert_eps=1e-4,
            occ_sigma_thresh=0.1, occ_pair_compaction=True, occ_refresh_every=2)
# tests/test_async_refresh.py's renders (its threshold 0.05 at the reference's
# init; 0.1 at the port's)
PAIRS = dict(n_samples=16, use_fused_kernel=True, spatial_tiles=True, occ_sigma_thresh=0.1,
             occ_grid_res=16, occ_refresh_every=2, occ_pair_compaction=True, ert_eps=0.0)
ASYNC = dict(PAIRS, occ_prune_contrib=1e-4, occ_prune_carry=1, occ_async_refresh=True)
HIST = dict(PAIRS, occ_refresh_every=1, occ_prune_budget=1e-3, occ_prune_trans=0.01,
            occ_prune_carry=0, occ_async_refresh=True, occ_prune_hist_decay=0.8)
STAGE_SPANS = {
    "tiles": {"render.inputs", "render.gather", "render.segment", "render.finish",
              "render.untile"},
    "hier": {"render.inputs", "render.gather", "render.sigma", "render.resample", "render.fine",
             "render.finish"},
    "async": {"render.inputs", "render.poll", "render.gather", "render.segment", "render.finish",
              "render.untile"},
}
REFRESH_SPANS = {"occupancy.flags", "occupancy.download", "occupancy.lists"}


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
def scene():
    ds = make_synthetic_dataset(n_frames=6, H=32, W=32, n_samples_gt=16, device="cpu")
    state = init_train_state(ExperimentConfig(), 0, device="cpu")
    return ds, state


def _renderer(scene, kind, render):
    ds, _ = scene
    cfg = ExperimentConfig(render=RenderConfig(**render))
    make = make_head_hierarchical_renderer if kind == "hier" else make_frame_renderer
    return make(cfg, ds.hwfcxy, ds.near, ds.far, device="cpu")


def _serve(scene, kind, render, n, join=False):
    """n frames of a fresh renderer: (renderer, composites, the cache's
    (age, gen, gen_src, swaps) after each frame, the worker's snapshot
    frame or None at each). With ``join`` each frame's worker is waited
    for, so the next frame swaps its state in."""
    ds, state = scene
    r = _renderer(scene, kind, render)
    sig, sig_t = torch.zeros(96), torch.zeros(ExperimentConfig().decoder.dim_et_embed)
    outs, after, started, prev = [], [], [], None
    for i in range(n):
        pose = ds.poses[i % len(ds.poses)]
        if kind == "hier":
            outs.append(r(state["params"], state["z_shape"], state["z_app"], pose, sig, ds.bc_img))
        else:
            outs.append(r(state["params"], state["z_shape"], state["z_app"], pose, ds.poses[0],
                          sig, sig_t, ds.bc_img)[1])
        c = r.cache
        after.append((c["age"], c["gen"], c["gen_src"], c.get("swaps", 0)))
        th = getattr(r, "worker", {}).get("thread")
        started.append(i if th is not None and th is not prev else None)
        prev = th
        if join and th is not None:
            th.join(timeout=120)
            assert not th.is_alive()
    return r, outs, after, started


@pytest.fixture(scope="module")
def runs(scene):
    """Each kind's frames with recording on (and its record) and off."""
    out = {}
    for kind, render in (("tiles", TILES), ("hier", HIER), ("async", ASYNC)):
        spans.start()
        on = _serve(scene, "hier" if kind == "hier" else "pairs", render, N_FRAMES,
                    join=kind == "async")
        worker = getattr(on[0], "worker", {}).get("thread")
        if worker is not None:
            worker.join(timeout=120)
        record = spans.stop()
        off = _serve(scene, "hier" if kind == "hier" else "pairs", render, N_FRAMES,
                     join=kind == "async")
        out[kind] = (on, record, off)
    return out


def _frames(record):
    """[(render.frame span, [the spans inside it on its thread])], in order."""
    frames = sorted((s for s in record if s[0] == "render.frame"), key=lambda s: s[3])
    return [(f, [s for s in record if s[1] == f[1] and s is not f and f[3] <= s[3]
                 and s[4] <= f[4]]) for f in frames]


def test_off_records_nothing_and_returns_the_shared_context():
    assert spans.span("render.frame") is spans.OFF is spans.span("kernel.blobs")
    with spans.span("a"):
        with spans.span("b"):
            pass
    assert spans.recorded() == []
    assert spans.stop() == []


def test_on_nests_tags_the_worker_thread_and_reads_perf_counter_ns():
    spans.start()
    t_before = time.perf_counter_ns()
    with spans.span("outer"):
        with spans.span("inner"):
            th = threading.Thread(target=lambda: spans.span("worker").__enter__().__exit__())
            th.start()
            th.join(timeout=30)
    t_after = time.perf_counter_ns()
    record = spans.stop()
    assert spans.stop() == []
    by_name = {s[0]: s for s in record}
    assert set(by_name) == {"outer", "inner", "worker"}
    assert [s[0] for s in record if s[0] != "worker"] == ["inner", "outer"]  # as they close
    me = threading.get_ident()
    assert by_name["outer"][1:3] == (me, 0) and by_name["inner"][1:3] == (me, 1)
    assert by_name["worker"][1] != me and by_name["worker"][2] == 0
    for _, _, _, t0, t1 in record:
        assert t_before <= t0 <= t1 <= t_after
    outer, inner = by_name["outer"], by_name["inner"]
    assert outer[3] <= inner[3] <= inner[4] <= outer[4]


def test_signals_span(scene):
    ds, state = scene
    spans.start()
    encode_frame_signals(state["params"], torch.as_tensor(ds.auds), torch.as_tensor(ds.exps),
                         torch.as_tensor(ds.poses), 2, len(ds.poses), ExperimentConfig(), True)
    assert [s[0] for s in spans.stop()] == ["render.signals"]


def test_a_binding_call_is_a_kernel_span():
    class PairFieldPerzKernel(_build.Binding):
        def __call__(self, x):
            return x + 1

    spans.start()
    assert PairFieldPerzKernel("pair_perz", {})(1) == 2
    assert [s[0] for s in spans.stop()] == ["kernel.pair_field_perz"]


@pytest.mark.parametrize("kind", ["tiles", "hier", "async"])
def test_frames_carry_their_stage_spans(runs, kind):
    (r, _, after, _), record, _ = runs[kind]
    frames = _frames(record)
    assert len(frames) == N_FRAMES
    me = threading.get_ident()
    for i, ((f, inside), (age, *_)) in enumerate(zip(frames, after)):
        expect = set(STAGE_SPANS[kind])
        if kind == "async" and i == 0:
            expect.discard("render.poll")  # the first frame refreshes synchronously
        if kind == "hier" and age == 1:
            expect.discard("render.gather")  # its refresh gathered
        assert f[1] == me and f[2] == 0
        assert {s[0] for s in inside} - REFRESH_SPANS == expect, (kind, i, inside)
        assert all(s[2] >= 1 for s in inside)
    if kind == "async":
        work = [s for s in record if s[1] != me]
        assert {s[0] for s in work} >= {"worker.refresh", "occupancy.flags",
                                         "occupancy.download", "occupancy.lists"}
        assert all(s[0] != "render.frame" for s in work)


@pytest.mark.parametrize("kind", ["tiles", "hier", "async"])
def test_refresh_frames_carry_the_occupancy_download_and_lists(runs, kind):
    (r, _, after, _), record, _ = runs[kind]
    n_refresh = 0
    for i, ((f, inside), (age, gen, gen_src, swaps)) in enumerate(zip(_frames(record), after)):
        names = {s[0] for s in inside}
        synchronous = gen_src == i  # the frame built the lists it was served under
        assert synchronous == (age == 1 and (i == 0 or kind != "async")), (kind, i, after)
        if synchronous:
            n_refresh += 1
            assert {"occupancy.download", "occupancy.lists"} <= names, (kind, i, names)
        else:
            assert not names & {"occupancy.download", "occupancy.lists"}, (kind, i, names)
    assert n_refresh == (1 if kind == "async" else 2)


@pytest.mark.parametrize("kind", ["tiles", "hier", "async"])
def test_frames_are_bit_identical_with_recording_on_and_off(runs, kind):
    (_, on, _, _), _, (_, off, _, _) = runs[kind]
    assert len(on) == len(off) == N_FRAMES
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_hier_t_line_keeps_its_format(scene, monkeypatch, capsys):
    monkeypatch.setenv("DFANERF_DEBUG_HIER_T", "1")
    _serve(scene, "hier", HIER, 3)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[hier:t]")]
    ms = r"=\d+\.\dms"
    steady = ("prep", "sigma_kernel", "resample", "fine_kernel", "finish")
    refresh = ("prep", "refresh") + steady[1:]
    expect = [refresh, steady, refresh]
    assert len(lines) == 3
    for line, tags in zip(lines, expect):
        assert re.fullmatch(r"\[hier:t\] " + " ".join(t + ms for t in tags), line), line
    for line in lines[0::2]:  # the refresh frame's sigma and resample ran in its refresh
        assert "sigma_kernel=0.0ms resample=0.0ms" in line
    monkeypatch.delenv("DFANERF_DEBUG_HIER_T")
    _serve(scene, "hier", HIER, 1)
    assert "[hier:t]" not in capsys.readouterr().out


def test_train_stages_are_profiler_ranges():
    """A CPU-activity torch.profiler sees STAGES as ranges, as chip_smoke.py
    reads them, and the spans record them while it runs."""
    cfg = ExperimentConfig(decoder=DecoderConfig(hidden_size=64, n_blocks=4, skips=(2,),
                                                 z_dim=32),
                           render=RenderConfig(n_samples=8, compute_dtype="float32"),
                           train=TrainConfig(n_rand=32, z_dim=32))
    ds = make_synthetic_dataset(n_frames=4, H=16, W=16, n_samples_gt=8, device="cpu")
    state = init_train_state(cfg, 0, device="cpu")
    step = make_train_step(cfg, ds, device="cpu")
    data = dataset_to_device(ds, "cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, data, torch.Generator().manual_seed(0))
    ranges = {e.name for e in prof.events()}
    assert set(STAGES) <= ranges
    assert set(STAGES) <= {s[0] for s in spans.stop()}


def test_sync_refreshes_advance_the_generation(scene):
    """tests/test_async_refresh.py's synchronous run (refresh every 2), with
    its prune and carry: an install at frames 0 (full), 2 (carried) and 4
    (full), each built from its own frame."""
    r, _, after, _ = _serve(scene, "pairs", dict(PAIRS, occ_prune_contrib=1e-4,
                                                 occ_prune_carry=1), 5)
    assert [(gen, src) for _, gen, src, _ in after] == [(1, 0), (1, 0), (2, 2), (2, 2), (3, 4)]
    assert r.cache["served"] == 5 and r.worker["thread"] is None


@pytest.mark.parametrize("kind", ["carry", "hist"])
def test_worker_swaps_advance_the_generation_to_their_snapshot(scene, runs, kind):
    """tests/test_async_refresh.py's async runs, each worker waited for: the
    first frame installs its own refresh; each later install is a swap,
    counted in ``swaps``, built from the frame that started the worker (the
    carried refresh's run is the recorded async run, one swap in 4 frames;
    the history run swaps twice in 5)."""
    if kind == "carry":
        (r, _, after, started), _, _ = runs["async"]
    else:
        r, _, after, started = _serve(scene, "pairs", HIST, 5, join=True)
    assert after[0][1:3] == (1, 0)
    snap = None
    for i in range(1, len(after)):
        (_, gen0, _, sw0), (_, gen, src, sw) = after[i - 1], after[i]
        if sw > sw0:
            assert gen == gen0 + 1 and src == snap, (i, after, started)
        else:
            assert gen == gen0, (i, after)
        if started[i] is not None:
            snap = started[i]
    assert after[-1][3] == (1 if kind == "carry" else 2) and after[-1][1] == 1 + after[-1][3]
    assert r.worker["error"] is None
