"""The readers of the program's spans (program_spans.py and the seven metrics
that read them) on a synthetic traced run whose record and trace are known;
each reports nothing for a program without the span API. On the card
(marked ``card``): a profiled window of each serving cell at the small size
carries the kernel bindings' spans, and ``blob_relays_per_frame`` equals the
weight blobs that the frames' launches took."""

import sys
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from conftest import ROOT, SMALL, SMALL_HIER
from port_bench import harness, serve
from port_bench.trace import Trace

NEW = ["refresh_wait_ms", "refresh_lists_ms", "inputs_ms", "wrapper_ms",
       "blob_relays_per_frame", "idle_in_program_pct", "kernel_load_s"]
MS = 1_000_000  # ns
BASE = 10 ** 12  # ns: the host clock at the synthetic run's first frame


def _frame(i, refreshed):
    """Frame i: dispatch [i * 100, i * 100 + 40] ms, pixels at + 60 ms."""
    t0 = (BASE + i * 100 * MS) * 1e-9
    return serve.Frame(c=i, t0=t0, t1=t0 + 0.040, t2=t0 + 0.060, refreshed=refreshed,
                       traced=True)


def _spans(i, refreshed, me):
    """Frame i's spans (name, thread, depth, start ms, end ms from the frame's
    start): signals 1 ms, the frame 38 ms with inputs 2 ms, a refresh's
    flags, download (10 + i ms) and lists (3 ms), and two render_rays calls
    of 1.5 ms each holding two blob re-lays; the second call's blobs hold a
    load. A worker thread's download runs beside."""
    s = [("render.signals", 0, 0.5, 1.5), ("render.frame", 0, 1.5, 39.5),
         ("render.inputs", 1, 1.6, 3.6)]
    t = 4.0
    if refreshed:
        s += [("occupancy.flags", 1, 4.0, 5.0), ("occupancy.download", 1, 5.0, 15.0 + i),
              ("occupancy.lists", 1, 15.0 + i, 18.0 + i)]
        t = 18.0 + i
    for k in range(2):
        a = t + 2 * k
        s += [("render.segment", 1, a, a + 1.6), ("kernel.render_rays", 2, a, a + 1.5),
              ("kernel.blobs", 3, a + 0.1, a + 0.4), ("kernel.blobs", 3, a + 0.5, a + 0.8)]
        if k == 1:
            s += [("kernel.load", 4, a + 0.55, a + 0.65)]
    t0 = BASE + i * 100 * MS
    out = [(n, me, d, t0 + int(a * MS), t0 + int(b * MS)) for n, d, a, b in s]
    return out + [("occupancy.download", me + 1, 0, t0 + 2 * MS, t0 + 30 * MS)]


@pytest.fixture
def synthetic(monkeypatch):
    """Three traced frames, the first a refresh frame; a trace 7 ms behind the
    host clock whose device is busy for the first 20 ms of each frame."""
    from dfanerf_torch import spans
    from dfanerf_torch.ops import _build

    me = threading.get_ident()
    frames = [_frame(i, i == 0) for i in range(3)]
    record = [s for i, f in enumerate(frames) for s in _spans(i, f.refreshed, me)]
    monkeypatch.setattr(spans, "recorded", lambda: list(record))
    off = 7 * MS
    ops = [("k", BASE + i * 100 * MS + off, BASE + i * 100 * MS + off + 20 * MS, 7)
           for i in range(3)]
    trace = Trace(ops=ops, spans=[], start=BASE + off, end=BASE + 260 * MS + off,
                  serving_stream=7)
    t_start = (BASE - 5 * MS) * 1e-9
    monkeypatch.setattr(_build, "LOADS", [
        ("kernel.build", BASE - 900 * MS, BASE - 400 * MS),
        ("kernel.load", BASE - 300 * MS, BASE - 250 * MS),
        ("kernel.load", BASE + 5 * MS, BASE + 6 * MS)])  # after the first timed frame
    return SimpleNamespace(frames=frames, trace=trace, t_start=t_start)


def read(name, run):
    return harness.load_reader(ROOT, name)(run)


def test_each_reader_reads_the_synthetic_run(synthetic):
    assert read("refresh_wait_ms", synthetic) == pytest.approx(10.0)
    assert read("refresh_lists_ms", synthetic) == pytest.approx(3.0)
    assert read("inputs_ms", synthetic) == pytest.approx(3.0)
    assert read("wrapper_ms", synthetic) == pytest.approx(3.0)
    assert read("blob_relays_per_frame", synthetic) == 4
    # idle under the outermost spans (signals 0.5-1.5, frame 1.5-39.5 ms):
    # busy 0-20 ms, so 19.5 ms a frame; window 260 ms
    assert read("idle_in_program_pct", synthetic) == pytest.approx(100 * 3 * 19.5 / 260)
    assert read("kernel_load_s", synthetic) == pytest.approx(0.55)


def test_no_refresh_frame_no_refresh_reading(synthetic):
    for f in synthetic.frames:
        f.refreshed = False
    assert read("refresh_wait_ms", synthetic) is None
    assert read("refresh_lists_ms", synthetic) is None
    assert read("inputs_ms", synthetic) == pytest.approx(3.0)


def test_a_program_without_spans_reports_nothing(synthetic, monkeypatch):
    import dfanerf_torch
    from dfanerf_torch.ops import _build

    monkeypatch.delattr(dfanerf_torch, "spans")
    monkeypatch.setitem(sys.modules, "dfanerf_torch.spans", None)
    monkeypatch.delattr(_build, "LOADS")
    for name in NEW:
        assert read(name, synthetic) is None, name


def test_the_serving_cells_list_the_new_metrics():
    for name in ("head_torso.shipped_serve", "head_hier.pair_serve"):
        listed = [m["name"] for m in harness.load_cell(ROOT, name).per_layer]
        assert listed[-len(NEW):] == NEW


@pytest.mark.card
@pytest.mark.parametrize("name", ["head_torso.shipped_serve", "head_hier.pair_serve"])
def test_kernel_spans_and_blob_relays_on_the_card(card, name):
    """Frames under a CUDA-activity profiler, as in a traced run: their
    kernel.* spans are recorded, and the blobs re-laid per frame equal the
    launches' blobs (render_rays two, the hierarchical kernels and the node
    grid of a refresh frame one each)."""
    from dfanerf_torch import spans
    from dfanerf_torch.ops.fused_render import render_rays_kernel
    from dfanerf_torch.ops.occupancy import node_grid_kernel
    from dfanerf_torch.ops.pair_hier import pair_field_perz_kernel, pair_sigma_kernel

    cell = harness.load_cell(ROOT, name)
    size = SMALL_HIER if name == "head_hier.pair_serve" else SMALL
    prog = serve.Program(serve.prepare(cell.model, cell.mix, 2 ** 31 + 29, card, size))
    serve.warm_up(prog, 4)
    blobs_of = {render_rays_kernel: 2, pair_sigma_kernel: 1, pair_field_perz_kernel: 1,
                node_grid_kernel: 1}
    before = {b: b.launches for b in blobs_of}
    n, frames = 8, []
    spans.stop()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        for i in range(n):
            t0 = time.perf_counter()
            img = prog.dispatch(prog.frame_of(4 + i))
            t1 = time.perf_counter()
            serve.to_host(img)
            frames.append(serve.Frame(i, t0, t1, time.perf_counter(), prog.refreshed(),
                                      traced=True))
    prog.close()
    launches = sum(k * (b.launches - before[b]) for b, k in blobs_of.items())
    names = {s[0] for s in spans.recorded()}
    kernels = ({"kernel.render_rays"} if name == "head_torso.shipped_serve"
               else {"kernel.pair_sigma", "kernel.pair_field_perz"})
    assert kernels | {"kernel.blobs", "render.frame"} <= names, names
    run = SimpleNamespace(frames=frames, trace=None, t_start=frames[0].t0)
    assert launches > 0 and read("blob_relays_per_frame", run) == pytest.approx(launches / n)
    assert read("wrapper_ms", run) > 0
    spans.stop()
