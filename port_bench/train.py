"""Training runs: ``TrainStep`` steps back to back on a seeded synthetic
identity (the clip's frames with their ground truth), each on a batch the
benchmark draws from the seed (a frame, ``n_rand`` distinct pixels, the
uniform depths) and hands to ``TrainStep.step_on_batch``. Set-up builds the
one state the window trains and drives it through its first three steps,
which the plain reference follows after the window.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench import reference, trace
from port_bench.clip import make_clip, truth_frames
from port_bench.weights import make_weights

CHECKED_STEPS = 3


@dataclasses.dataclass
class TrainSetup:
    model: dict
    mix: dict
    clip: object
    imgs_head: torch.Tensor
    imgs_com: torch.Tensor
    params: Dict[str, torch.Tensor]
    z_shape: torch.Tensor
    z_app: torch.Tensor
    device: torch.device
    n_rand: int


def prepare(model: dict, mix: dict, seed: int, device, size: Optional[dict] = None) -> TrainSetup:
    frame = dict(model["frame"], **(size or {}).get("frame", {}))
    rcfg = dict(model["render"], **(size or {}).get("render", {}))
    model = dict(model, render=rcfg)
    clip = make_clip(seed, mix["frames"], frame["H"], frame["W"], rcfg["near"], rcfg["far"], 1)
    imgs_head, imgs_com = truth_frames(clip, mix["truth_samples"], device)
    params, z_shape, z_app = make_weights(model, model["assumed"]["weights_seed"], device)
    n_rand = int((size or {}).get("n_rand", model["train"]["n_rand"]))
    return TrainSetup(model, mix, clip, imgs_head, imgs_com, params, z_shape, z_app,
                      torch.device(device), n_rand)


class Batches:
    """The benchmark's feed: for each step a frame drawn from the seed, n_rand
    distinct pixels of it (a permutation on the device), the uniform depths."""

    def __init__(self, ts: TrainSetup, seed: int):
        self.rng = np.random.default_rng([seed, 3])
        self.gen = torch.Generator(device=ts.device).manual_seed(int(seed) % (1 << 63))
        self.H, self.W, self.n = ts.clip.H, ts.clip.W, ts.clip.n_frames
        self.n_rand = ts.n_rand
        r = ts.model["render"]
        self.z = torch.linspace(r["near"], r["far"], r["n_samples"], device=ts.device)

    def __call__(self) -> dict:
        pix = torch.randperm(self.H * self.W, generator=self.gen, device=self.z.device)
        pix = pix[:self.n_rand]
        return {"img_i": int(self.rng.integers(self.n)),
                "coords": torch.stack([pix // self.W, pix % self.W], dim=-1),
                "z_vals": self.z.expand(self.n_rand, -1)}


class TrainProgram:
    """The system under test: the program's ``TrainStep`` over a dataset of the
    setup's frames, and the one state it trains."""

    def __init__(self, ts: TrainSetup):
        from dfanerf_torch.config import ExperimentConfig
        from dfanerf_torch.data.dataset import FrameDataset
        from dfanerf_torch.train.optim import adam_init
        from dfanerf_torch.train.state import OPT_GROUPS, Params
        from dfanerf_torch.train.step import dataset_to_device, make_train_step

        m, clip = ts.model, ts.clip
        render = {k: m["render"][k] for k in ("n_samples", "last_dist", "concate_bg", "near",
                                               "far", "compute_dtype")}
        train = {k: v for k, v in m["train"].items() if k != "trained_groups"}
        self.cfg = ExperimentConfig.from_dict({"decoder": m["decoder"], "render": render,
                                               "signal": m["signal"], "train": train})
        with torch.device("meta"):
            module = Params(self.cfg)
        params = module.to_empty(device=ts.device)
        params.load_state_dict(ts.params, strict=True)
        self.state = {"params": params,
                      "opt": {g: adam_init(getattr(params, g)) for g, _, _ in OPT_GROUPS},
                      "z_shape": ts.z_shape.clone(), "z_app": ts.z_app.clone(), "step": 0}
        n = clip.n_frames
        ds = FrameDataset(
            poses=clip.poses, auds=clip.auds, exps=clip.exps,
            imgs_head=ts.imgs_head.cpu().numpy(), imgs_com=ts.imgs_com.cpu().numpy(),
            bc_img=clip.bc_img, sample_rects=np.zeros((n, 4), np.int32), hwfcxy=clip.hwfcxy,
            i_train=np.arange(n, dtype=np.int32), i_val=np.zeros(0, np.int32),
            near=clip.near, far=clip.far)
        self.step = make_train_step(self.cfg, ds, device=ts.device)
        self.data = dataset_to_device(ds, device=ts.device)

    def run(self, batch: dict) -> dict:
        return self.step.step_on_batch(self.state, self.data, batch)[1]

    def first_gradients(self, b1: float) -> Dict[str, torch.Tensor]:
        """Each trained leaf's gradient as the optimizer got it, from its first
        moment after one step: m / (1 - b1)."""
        return {f"{g}.{n}": m / (1.0 - b1) for g, st in self.state["opt"].items()
                for n, m in st["m"].items()}

    def parameters(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in self.state["params"].state_dict().items()}

    def close(self):
        self.state = self.step = self.data = None


def leaf_gap(got: Dict[str, float], want: Dict[str, float], keep: List[str]) -> float:
    """The worst leaf's |norm(program) - norm(reference)| over the larger of
    the reference's norm of that leaf and of the median leaf."""
    med = float(np.median([want[k] for k in keep]))
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in keep)


def norms(xs: Dict[str, torch.Tensor], names) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(xs[k].float())) for k in names}


def reference_data(ts: TrainSetup) -> dict:
    c = ts.clip
    dev = ts.device
    return {"auds": torch.from_numpy(c.auds).to(dev), "exps": torch.from_numpy(c.exps).to(dev),
            "poses": torch.from_numpy(c.poses).to(dev),
            "bc_img": torch.from_numpy(c.bc_img).to(dev), "imgs_head": ts.imgs_head,
            "imgs_com": ts.imgs_com, "hwf": (c.H, c.W, c.focal)}


def trained_leaves(ts: TrainSetup) -> List[str]:
    """The leaves whose optimizer groups step from the first step on."""
    groups = tuple(g + "." for g in ts.model["train"]["trained_groups"])
    return [k for k in ts.params if k.startswith(groups)]


def reference_side(ts: TrainSetup, batches, prec: str = "fp32", rows: Optional[int] = None):
    """(losses, first gradients' norms, changes' norms after the steps) of the
    reference's steps; ``prec`` and ``rows`` make it the control or a fault
    put in the program's place."""
    trained = trained_leaves(ts)
    with reference.strict_float32():
        losses, g1, p3 = reference.train_steps(ts.params, ts.model, reference_data(ts), batches,
                                               ts.z_shape, ts.z_app, trained, prec, rows)
    return losses, norms(g1, trained), norms({k: p3[k] - ts.params[k] for k in trained}, trained)


def program_side(prog: "TrainProgram", feed, ts: TrainSetup):
    """Drive the program through its first steps on the feed; returns the
    batches and (losses, first gradients' norms, changes' norms)."""
    trained = trained_leaves(ts)
    batches, losses = [], []
    for n in range(CHECKED_STEPS):
        batches.append(feed())
        losses.append(prog.run(batches[-1])["loss"])
        if n == 0:
            g1 = norms(prog.first_gradients(ts.model["train"]["adam_b1"]), trained)
    p = prog.parameters()
    d3 = norms({k: p[k] - ts.params[k] for k in trained}, trained)
    return batches, ([float(x) for x in losses], g1, d3)


def check_numbers(ref, got) -> dict:
    """The numbers ``correct`` compares: the largest relative gap of the
    checked steps' losses, and the worst leaf's gap of the first gradient's
    norm and of the parameters' change after the steps. Leaves whose
    reference gradient is under a thousandth of the median leaf's (unused by
    the loss: they move by rounding alone) are left out."""
    losses, g_ref, d_ref = ref
    lp, gp, dp = got
    med = float(np.median(list(g_ref.values())))
    keep = [k for k in g_ref if g_ref[k] >= 1e-3 * med]
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(lp, losses)),
            "grad1_gap": leaf_gap(gp, g_ref, keep),
            "delta3_gap": leaf_gap(dp, d_ref, keep)}


def run_window(prog: TrainProgram, feed: Batches, seconds: float, traced: bool, trace_s: float,
               i_print: int):
    """Steps back to back for ``seconds``, the loss read on the host every
    ``i_print`` steps; with ``traced`` a profiler over [seconds / 3,
    seconds / 3 + trace_s). Returns (steps [(t0, t1, traced)], end time,
    profiler and its window or None)."""
    steps = []
    prof, state, traced_window = None, "before", None
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        if t0 - t_start >= seconds:
            break
        if traced and state == "before" and t0 - t_start >= seconds / 3:
            prof, state = trace.Profiler(), "on"
            prof.start()
            t_on = t0 = time.perf_counter()
        metrics = prog.run(feed())
        t1 = time.perf_counter()
        steps.append((t0, t1, state == "on"))
        if len(steps) % i_print == 0:
            float(metrics["loss"])
        if state == "on" and time.perf_counter() - t_on >= trace_s:
            prof.stop_window()
            traced_window = (t_on, time.perf_counter())
            state = "after"
    if state == "on":
        prof.stop_window()
        traced_window = (t_on, time.perf_counter())
    if prog.step.device.type == "cuda":
        torch.cuda.synchronize(prog.step.device)
    return steps, time.perf_counter(), (prof, traced_window)
