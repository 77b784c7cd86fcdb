"""Ray-sharded data-parallel training over a torch.distributed mesh (port
of dfanerf_tpu/parallel/mesh.py).

- the mesh is one 'rays' axis over every rank of the process group; the
  parameters, the moments, the latents and the data are replicated
  (``replicate_state`` broadcasts rank 0's);
- every rank draws the same global batch from an identically seeded
  generator, and renders and backpropagates its slice of the rays,
  ``coords[r * n / W:(r + 1) * n / W]``;
- the gradients and the three losses go into one bucket (a parameter that
  took no part in the loss as zero) and one all-reduce sum divided by W
  gives the reference's pmean, equal on every rank; the staged Adam of
  train/optim.py then steps every rank's copy alike.

The step reproduces the reference's sharded step, quirks included
(ROADMAP.md queue 3): its key splits in three, so it has no sparsity prior;
it has no distortion term, no L1 loss, no clip and no grad_norm; the
signals are encoded outside the gradient, so the audio, expression and
attention nets get zero gradients (their groups' counters advance, their
parameters stay); the depths are [n_rand / W, S] and every shard uses the
same rows; the frame position is drawn over every training frame
(``len(ds.i_train)``) but indexes the speaking frames, clamped to the last
one as JAX's gather clamps; the signals' window is valid over
``len(ds.i_train)`` frames.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist

from dfanerf_torch.config import ExperimentConfig
from dfanerf_torch.core.sampling import stratified_z_vals
from dfanerf_torch.data.dataset import FrameDataset
from dfanerf_torch.parallel.distributed import mesh_device_type
from dfanerf_torch.spans import span
from dfanerf_torch.train.state import TrainState
from dfanerf_torch.train.step import (
    STAGES, TrainStep, device_generator, psnr, render_pixels, sample_pixel_coords, staged_adam,
)


def make_mesh(axis: str = "rays"):
    """The 1-D ``axis`` mesh over every rank of the process group."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(mesh_device_type(), (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def mesh_device(mesh) -> torch.device:
    """This rank's device of ``mesh``: its CUDA device under NCCL."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _state_tensors(state: TrainState) -> List[torch.Tensor]:
    params = state["params"]
    out = list(params.parameters()) + list(params.buffers())
    for o in state["opt"].values():
        out += list(o["m"].values()) + list(o["v"].values())
    return out + [state["z_shape"], state["z_app"]]


@torch.no_grad()
def replicate_state(state: TrainState, mesh) -> TrainState:
    """Rank 0's parameters, moments, latents, counters and step on every
    rank of ``mesh``, in place (one broadcast of a flat bucket)."""
    group = mesh.get_group()
    src = dist.get_global_rank(group, 0)
    tensors = _state_tensors(state)
    bucket = torch.cat([t.reshape(-1) for t in tensors])
    dist.broadcast(bucket, src=src, group=group)
    offset = 0
    for t in tensors:
        t.copy_(bucket[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    counters = [state["step"]] + [o["t"] for o in state["opt"].values()]
    dist.broadcast_object_list(counters, src=src, group=group)
    state["step"] = counters[0]
    for o, t in zip(state["opt"].values(), counters[1:]):
        o["t"] = t
    return state


def all_reduce_mean(params, losses: List[torch.Tensor], mesh) -> torch.Tensor:
    """The pmean over ``mesh`` of every parameter's gradient (None as zero)
    and of ``losses``, in one bucket: one all-reduce sum divided by the
    mesh's size. The parameters' ``.grad`` become views of the bucket;
    returns the mean losses [len(losses)]."""
    ps = list(params.parameters())
    bucket = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                        for p in ps] + [torch.stack(losses).detach()])
    dist.all_reduce(bucket, group=mesh.get_group())
    bucket.div_(mesh.size())
    offset = 0
    for p in ps:
        p.grad = bucket[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    return bucket[offset:]


class ShardedTrainStep(TrainStep):
    """The reference's mesh-sharded step (make_sharded_train_step) on this
    rank: ``step(state, data, generator)``, or ``draw_batch`` then
    ``step_on_batch`` as TrainStep's."""

    def __init__(self, cfg: ExperimentConfig, ds: FrameDataset, mesh):
        super().__init__(cfg, ds, device=mesh_device(mesh))
        self.mesh = mesh
        self.world = mesh.size()
        self.rank = mesh.get_local_rank()
        if cfg.train.n_rand % self.world:
            raise ValueError(f"n_rand={cfg.train.n_rand} does not divide over {self.world} ranks")
        # the frame position is drawn over every training frame; the
        # signals' window is valid over as many
        self.n_train = int(len(ds.i_train))

    def frame(self, pos: int) -> int:
        """The speaking training frame at drawn position ``pos``, clamped to
        the last one as the reference's gather clamps (ROADMAP.md queue 3)."""
        return int(self.i_train[min(pos, len(self.i_train) - 1)])

    def draw_batch(self, generator: torch.Generator) -> Dict:
        """{"img_i", "coords": [n_rand, 2], "z_vals": [n_rand / W, S]}, the
        same on every rank for generators seeded alike."""
        tcfg = self.cfg.train
        img_i = self.frame(int(torch.randint(self.n_train, (), generator=generator)))
        g = device_generator(generator, self.device)
        coords = sample_pixel_coords(g, self.H, self.W, tcfg.n_rand, tcfg.sample_rate,
                                     self.rects[img_i], device=self.device)
        z_vals = stratified_z_vals(self.near, self.far, tcfg.n_rand // self.world,
                                   self.cfg.render.n_samples,
                                   generator=g if tcfg.perturb else None, device=self.device)
        return {"img_i": img_i, "coords": coords, "z_vals": z_vals}

    def step_on_batch(self, state: TrainState, data: Dict, batch: Dict):
        """One step of this rank's ray slice, the gradients and losses
        averaged over the mesh; the state updated in place, as on every rank."""
        scfg = self.cfg.signal
        params, step = state["params"], state["step"]
        use_smo, use_exp = step >= scfg.nosmo_iters, step >= scfg.noexp_iters
        img_i = batch["img_i"]
        n = self.cfg.train.n_rand // self.world
        coords = batch["coords"][self.rank * n:(self.rank + 1) * n]
        for p in params.parameters():
            p.grad = None
        with span(STAGES[1]):
            with torch.no_grad():
                signal, signal_torso = self.signals(params, data, img_i, use_smo)
            outs, target_head, target_com = render_pixels(
                params, self.cfg.render, data, self.hwfcxy, img_i, coords, batch["z_vals"],
                signal, signal_torso, state["z_shape"], state["z_app"])
            loss_head = torch.mean((outs[0] - target_head) ** 2)
            loss_com = torch.mean((outs[1] - target_com) ** 2)
            loss = loss_head + loss_com
        with span(STAGES[2]):
            loss.backward()
            losses = all_reduce_mean(params, [loss, loss_head, loss_com], self.mesh)
        with span(STAGES[3]):
            lr = staged_adam(self.cfg, state, use_smo, use_exp)
            state["step"] = step + 1
            metrics = {"loss": losses[0], "loss_head": losses[1], "loss_com": losses[2],
                       "psnr_head": psnr(losses[1]), "psnr_com": psnr(losses[2]),
                       "lr": float(lr)}
        return state, metrics


def make_sharded_train_step(cfg: ExperimentConfig, ds: FrameDataset, mesh) -> ShardedTrainStep:
    """The mesh-sharded train step of ``cfg`` over ``ds`` on this rank of
    ``mesh`` (make_mesh), on the mesh's device; its data is
    train/step.py dataset_to_device's on that device."""
    return ShardedTrainStep(cfg, ds, mesh)

