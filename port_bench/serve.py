"""Serving runs: one client in a closed loop over a seeded driving clip,
through the program's public entry points (``make_frame_renderer`` or
``make_head_hierarchical_renderer``, ``encode_frame_signals``), each frame's
composite copied to the host as uint8 before the next is dispatched, as
``render_video_frames`` does. After the window, frames that the seed picks
(the slowest among them) are compared with the plain reference's frames of
the same inputs.

The loop is shared here; what differs between serving paths sits in one file
per path, ``paths/<path>.py``, found by name (``resolve_path``). A path file
holds ``prepare`` (as a rule this module's), ``Program`` (as a rule a
subclass of this module's that lists the frame's kernel work), its
``reference_frames(st, frames, prec="fp32")``, which makes the path's skip
decisions itself at the same refresh frames (``reference.py``, "skipping"),
and ``KERNELS``, the counted work of each kernel its ``work()`` names.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from port_bench import counts, reference, trace
from port_bench.clip import make_clip
from port_bench.harness import Cell, load_named
from port_bench.weights import calibrate, make_weights


@dataclasses.dataclass
class Frame:
    c: int               # clip index
    t0: float            # dispatch starts (host clock, s)
    t1: float            # the renderer's call returned, before its output is waited for
    t2: float            # uint8 pixels on the host
    refreshed: bool      # the frame rebuilt the occupancy state (the cadence's refresh frame)
    c_ref: int = -1      # clip index of the refresh frame whose state the frame was served under
    traced: bool = False
    work: Optional[list] = None  # (kernel, fields, tiles, listed blocks) of the frame, traced only

    @property
    def ms(self) -> float:
        return (self.t2 - self.t0) * 1e3


@dataclasses.dataclass
class Setup:
    """A cell's inputs and weights, made by the benchmark from the seed."""
    model: dict
    render: dict
    clip: object
    params: Dict[str, torch.Tensor]
    z_shape: torch.Tensor
    z_app: torch.Tensor
    device: torch.device
    calibration: dict


def prepare(model: dict, mix: dict, seed: int, device, size: Optional[dict] = None) -> Setup:
    """Weights on the device from the configuration's weights seed, the clip
    from ``seed``, the density of both fields (the head alone for a
    hierarchical configuration) calibrated as the configuration's
    ``assumed.field`` states. The render settings are the
    configuration's, then the mix's; ``size`` overrides frame and render
    sizes (the CPU tests' small frames)."""
    rcfg = {**model["render"], **mix.get("render", {}), **(size or {}).get("render", {})}
    frame = dict(model["frame"], **(size or {}).get("frame", {}))
    clip = make_clip(seed, mix["clip_frames"], frame["H"], frame["W"], rcfg["near"], rcfg["far"],
                     mix["clip_step"])
    params, z_shape, z_app = make_weights(model, model["assumed"]["weights_seed"], device)
    sig, sig_t = reference_signals(params, model, clip, 0, device)
    field_cfg = dict(model["assumed"]["field"], **(size or {}).get("field", {}))
    fields = ("head", "torso") if rcfg.get("n_importance", 0) == 0 else ("head",)
    calibration = calibrate(params, z_shape, z_app, (sig, sig_t), model, clip, field_cfg,
                            rcfg["occ_sigma_thresh"], fields)
    return Setup(model, rcfg, clip, params, z_shape, z_app, torch.device(device), calibration)


def clip_tensors(clip, device):
    return (torch.from_numpy(clip.auds).to(device), torch.from_numpy(clip.exps).to(device),
            torch.from_numpy(clip.poses).to(device), torch.from_numpy(clip.bc_img).to(device))


def reference_signals(params, model, clip, c: int, device):
    auds, exps, poses, _ = clip_tensors(clip, device)
    s = model["signal"]
    with reference.strict_float32():
        return (reference.head_signal(params, auds, exps, c, clip.n_frames, s["smo_size"]),
                reference.torso_signal(params, poses, c, clip.n_frames, s["smo_torso_size"],
                                       s["et_multires"]))


def path_name(model: dict, mix: dict) -> str:
    """The serving path of a configuration under a mix: the mix's ``path``,
    else the one its render flags select (pair lists, tile classes or
    neither; the hierarchical head on pair lists). A hierarchical
    configuration off the pair path has none: the hierarchical pair path's
    reference would make decisions its renderer does not make."""
    if "path" in mix:
        return mix["path"]
    rcfg = {**model["render"], **mix.get("render", {})}
    if rcfg.get("n_importance", 0) > 0:
        if (rcfg.get("use_fused_kernel") and rcfg.get("occ_pair_compaction")
                and rcfg.get("occ_sigma_thresh", 0) > 0):
            return "hier_pairs"
        raise SystemExit(f"port_bench: {model['name']} under this mix is hierarchical off the "
                         "pair path: no serving path; name one with `path` in the mix")
    return ("pairs" if rcfg.get("occ_pair_compaction")
            else "tile_classes" if rcfg.get("occ_tile_compaction") else "dense")


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A kernel's counted work: the FLOPs at one (ray, sample) point of a
    listed block, ``flops_per_point(fields)``, and the bytes a launch must
    move, ``bytes(fields, tiles, blocks)``."""
    flops_per_point: Callable[[str], float]
    bytes: Callable[[str, int, int], float]


# The counted work of each kernel that a loaded serving path names, by the
# kernel's name (the name a launch carries in the trace): filled as paths load.
KERNELS: Dict[str, Kernel] = {}


def load_path(root: Path, name: str) -> ModuleType:
    """The serving path port_bench/paths/<name>.py under ``root``, its
    kernels' counted work entered in KERNELS."""
    path = load_named(root, "paths", name)
    KERNELS.update(path.KERNELS)
    return path


def resolve_path(cell: Cell) -> ModuleType:
    """The cell's serving path, found under the cell's root."""
    return load_path(cell.root, path_name(cell.model, cell.mix))


class Program:
    """The system under test, built from the setup through its public entry
    points: the hierarchical head renderer for a configuration with
    ``n_importance`` > 0, else the head+torso frame renderer. ``dispatch(c)``
    renders clip frame c and returns the composite [H, W, 3] on the device.
    It lists no kernel work; a path's program that does subclasses it."""

    kind = "dense"

    def __init__(self, st: Setup):
        from dfanerf_torch.config import ExperimentConfig
        from dfanerf_torch.render import renderer
        from dfanerf_torch.train.state import Params

        self.renderer = renderer
        rcfg = st.render
        self.cfg = ExperimentConfig.from_dict({"decoder": st.model["decoder"], "render": rcfg,
                                               "signal": st.model["signal"]})
        with torch.device("meta"):
            module = Params(self.cfg)
        self.module = module.to_empty(device=st.device)
        self.module.load_state_dict(st.params, strict=True)
        self.module.requires_grad_(False)
        self.z_shape, self.z_app = st.z_shape, st.z_app
        self.auds, self.exps, self.poses, self.bc = clip_tensors(st.clip, st.device)
        self.n, self.start = st.clip.n_frames, st.clip.start
        clip = st.clip
        self.hier = rcfg.get("n_importance", 0) > 0
        make = (renderer.make_head_hierarchical_renderer if self.hier
                else renderer.make_frame_renderer)
        self.render = make(self.cfg, clip.hwfcxy, clip.near, clip.far, device=st.device)

    def frame_of(self, i: int) -> int:
        """The clip index of the run's i-th frame."""
        return (self.start + i) % self.n

    def dispatch(self, c: int) -> torch.Tensor:
        sig, sig_t = self.renderer.encode_frame_signals(self.module, self.auds, self.exps,
                                                        self.poses, c, self.n, self.cfg, True)
        if self.hier:
            return self.render(self.module, self.z_shape, self.z_app, self.poses[c], sig, self.bc)
        return self.render(self.module, self.z_shape, self.z_app, self.poses[c], self.poses[0],
                           sig, sig_t, self.bc)[1]

    def refreshed(self) -> bool:
        return getattr(self.render, "cache", {}).get("age") == 1

    def work(self) -> list:
        """The listed work of the frame just rendered, read from the
        renderer's state: [(kernel, fields, tiles, listed (tile, slab)
        blocks)]."""
        return []

    def close(self):
        worker = getattr(self.render, "worker", None)
        if worker is not None and worker.get("thread") is not None:
            worker["thread"].join(timeout=120)
            if worker["thread"].is_alive():
                raise RuntimeError("the refresh worker did not finish")
        self.render = None


def to_host(img: torch.Tensor) -> torch.Tensor:
    return (img.clamp(0, 1) * 255).to(torch.uint8).cpu()


def work_flops(kernel: str, fields: str, blocks: int) -> float:
    """The counted FLOPs of a kernel's listed blocks (KERNELS)."""
    if kernel not in KERNELS:
        raise KeyError(f"{kernel}: no loaded serving path counts its work")
    pts = blocks * counts.RAYS_PER_TILE * counts.SAMPLES_PER_SLAB
    return pts * KERNELS[kernel].flops_per_point(fields)


def run_window(prog: Program, start: int, seconds: float, traced: bool, trace_s: float,
               seed: int, keep: int, c_ref: int):
    """Frames back to back for ``seconds``; with ``traced`` a profiler over
    [seconds / 3, seconds / 3 + trace_s). ``c_ref`` is the clip index of the
    refresh frame the first frame is served under. Keeps on the device the
    float composite of the slowest frame and, for each position r = 1 ..
    keep - 1 in a cycle of ``keep`` frames (the refresh cadence: the frames'
    ages), one frame at that position drawn from the seed as the window goes
    (reservoir sampling). Returns (frames, {frame position: composite}, the
    profiler or None)."""
    frames: List[Frame] = []
    reservoir: Dict[int, tuple] = {}  # cycle position -> (frame position, composite)
    seen = [0] * keep
    slowest = (-1.0, None, None)
    rng = np.random.default_rng([seed, 2])
    prof, state = None, "before"
    i = start
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        if t0 - t_start >= seconds:
            break
        if traced and state == "before" and t0 - t_start >= seconds / 3:
            prof, state = trace.Profiler(), "on"
            prof.start()
            t_on = t0 = time.perf_counter()
        c = prog.frame_of(i)
        in_trace = state == "on"
        img = prog.dispatch(c)
        t1 = time.perf_counter()
        to_host(img)
        t2 = time.perf_counter()
        refreshed = prog.refreshed()
        c_ref = c if refreshed else c_ref
        f = Frame(c, t0, t1, t2, refreshed, c_ref, traced=in_trace)
        if in_trace:
            f.work = prog.work()
        j = len(frames)
        frames.append(f)
        if f.ms > slowest[0]:
            slowest = (f.ms, j, img.clone())
        r = j % keep
        seen[r] += 1
        if r and int(rng.integers(seen[r])) == 0:
            reservoir[r] = (j, img.clone())
        i += 1
        if state == "on" and time.perf_counter() - t_on >= trace_s:
            prof.stop_window()
            state = "after"
    if state == "on":
        prof.stop_window()
    kept = dict(reservoir.values())
    kept[slowest[1]] = slowest[2]
    return frames, kept, prof


def warm_up(prog: Program, n: int) -> int:
    """The cell's warm frames; returns the clip index of the refresh frame
    the next frame is served under."""
    c_ref = -1
    for i in range(n):
        c = prog.frame_of(i)
        to_host(prog.dispatch(c))
        c_ref = c if prog.refreshed() else c_ref
    return c_ref


# The check's allowance for rounding in the program's skip decisions: a node
# whose raw density lies within MARGIN of the threshold (in units of the
# calibrated density output's scale, the contrast) may be decided either
# way; a path's file sets how far a box bound may be off a node.
MARGIN = 2e-3


def margin(st: Setup) -> float:
    return MARGIN * float(st.model["assumed"]["field"]["contrast"])


def _frame_inputs(st: Setup, c: int) -> dict:
    clip = st.clip
    _, _, poses, bc = clip_tensors(clip, st.device)
    sig, sig_t = reference_signals(st.params, st.model, clip, c, st.device)
    return {"pose": poses[c], "pose_torso": poses[0], "signal": sig, "signal_torso": sig_t,
            "z_shape": st.z_shape, "z_app": st.z_app, "bc": bc.reshape(-1, 3).float() / 255.0}


def frames_under_refresh(st: Setup, frames: List[tuple], render, decide=None) -> list:
    """The plain reference's frames [(composite [H, W, 3], U [H, W])] for
    ``frames`` [(clip index, refresh frame's clip index)] in strict float32:
    ``decide(inputs)`` once for each refresh frame's inputs, and
    ``render(inputs, decided)`` for each frame, U the bound on what the
    uncertain decisions can move. Without ``decide`` nothing is decided."""
    out, states = [], {}
    with reference.strict_float32():
        for c, c_ref in frames:
            fr = _frame_inputs(st, c)
            if decide is not None and c_ref not in states:
                states[c_ref] = decide(_frame_inputs(st, c_ref))
            out.append(render(fr, states.get(c_ref)))
    return out


def no_skip_frames(st: Setup, frames: List[tuple], prec: str = "fp32") -> list:
    """The reference's no-skip frames, U = 0: the head+torso frame, or the
    hierarchical head for a configuration with ``n_importance`` > 0."""
    hwf = (st.clip.H, st.clip.W, st.clip.focal)
    dec, rcfg = st.model["decoder"], st.render

    def render(fr, _):
        if rcfg.get("n_importance", 0) > 0:
            img = reference.head_hier_frame(st.params, dec, rcfg, fr, hwf, prec)
        else:
            img = reference.head_torso_frame(st.params, dec, rcfg, fr, hwf, prec)[1]
        return img, torch.zeros(img.shape[:2], device=img.device)

    return frames_under_refresh(st, frames, render)


def tile_means(e: torch.Tensor) -> torch.Tensor:
    """Means of e [H, W] over the renderers' 16x16 tiles (edge tiles over
    the pixels they hold)."""
    H, W = e.shape
    pad = (0, -W % reference.TILE, 0, -H % reference.TILE)
    s = F.avg_pool2d(F.pad(e, pad)[None, None], reference.TILE, divisor_override=1)
    n = F.avg_pool2d(F.pad(torch.ones_like(e), pad)[None, None], reference.TILE,
                     divisor_override=1)
    return (s / n).reshape(-1)


def compare(kept: List[torch.Tensor], refs: List[tuple]) -> dict:
    """The kept frames against the reference's. ``err_p50``: the largest over
    the colour channels of the median absolute pixel error, the precision of
    every pixel. ``tile_excess``: the largest over the frames' 16x16 tiles of
    the tile's mean excess, a pixel's excess being its error (the largest
    over its channels) less its bound U on what uncertain skip decisions
    can move, where positive: a fault on one tile's pixels, such as blocks
    skipped or run against the rules or a tile lost, and not the rounding
    of single samples near a sharp surface. ``nonfinite_px``: the values
    that are not finite. Also read: ``excess_max``, the largest pixel
    excess."""
    d = [(k.float().cpu() - r.cpu()).abs() for k, (r, _) in zip(kept, refs)]
    finite = torch.cat([torch.isfinite(x).all(dim=-1).reshape(-1) for x in d])
    if not finite.all():
        return {"err_p50": float("inf"), "tile_excess": float("inf"),
                "nonfinite_px": int((~finite).sum()), "excess_max": float("inf")}
    e = [x.amax(dim=-1) - u.cpu() for x, (_, u) in zip(d, refs)]
    return {"err_p50": float(torch.cat([x.reshape(-1, 3) for x in d]).median(dim=0).values.max()),
            "tile_excess": float(max(tile_means(x.clamp_min(0.0)).max() for x in e)),
            "nonfinite_px": 0, "excess_max": float(max(x.max() for x in e))}


def roofline_share(run, kernel: str, bytes_of=None):
    """A kernel's share of its roofline over the traced window: its launches'
    device time on the serving stream against the larger of the counted
    FLOPs over the bf16 peak and the counted bytes (``bytes_of(fields,
    tiles, blocks)``, by default the path's KERNELS) over HBM bandwidth.
    None where it did not run."""
    tr = run.trace
    items = [w for f in run.frames if f.traced and f.work for w in f.work
             if w[0] == kernel and w[3] > 0]
    if tr is None or not items:
        return None
    seconds = tr.kernel_seconds(kernel, tr.serving_stream)
    bytes_of = bytes_of or KERNELS[kernel].bytes
    flops = sum(work_flops(k, fields, blocks) for k, fields, _, blocks in items)
    n_bytes = sum(bytes_of(fields, tiles, blocks) for _, fields, tiles, blocks in items)
    return counts.roofline_pct(flops, n_bytes, seconds)


def host_spans(frames: List[Frame]):
    """The traced frames' host spans: dispatch (the calls into the program),
    to_host (waiting for the frame and copying it), loop (the benchmark's
    own work between frames); and the traced window's (start, end)."""
    fr = [f for f in frames if f.traced]
    spans = [s for f in fr for s in (("serve.dispatch", f.t0, f.t1), ("serve.to_host", f.t1, f.t2))]
    spans += [("serve.loop", a.t2, b.t0) for a, b in zip(fr, fr[1:])]
    return spans, fr[0].t0, fr[-1].t2
