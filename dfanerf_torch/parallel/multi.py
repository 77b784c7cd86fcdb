"""Multi-identity batched training, BASELINE config 5 (port of
dfanerf_tpu/parallel/multi.py).

One shared decoder trains on several identities per step (the reference's
``--n_object``, run_nerf_com_trainExpLater.py:743-931): object o renders
through latents 2o (head) and 2o + 1 (torso); object 0 speaks (audio and
expression signal into the 'head' branch), the others listen (the
signal-free 'head_listener' branch). With ``dynamic_speaker`` each frame's
branch follows its object's ``speak_frames`` instead, and every training
frame is drawn (the speaking filter applies only to the static mode).

The objects run in order, each with its own backward and staged Adam step,
so the groups' counters advance by n_object a step; each object draws its
frame and pixels (the reference's 3-way key split) and renders at
unperturbed depths. With a mesh each object's rays shard over it as in
parallel/mesh.py: a rank renders its slice at [n_rand / W, S] depths and
the gradients and losses are averaged over the mesh in one all-reduce.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from dfanerf_torch.config import ExperimentConfig
from dfanerf_torch.core.sampling import stratified_z_vals
from dfanerf_torch.data.dataset import FrameDataset, speaking_i_train
from dfanerf_torch.device import resolve_device
from dfanerf_torch.parallel.mesh import all_reduce_mean, mesh_device
from dfanerf_torch.train.signals import encode_signal, encode_signal_torso
from dfanerf_torch.train.state import TrainState
from dfanerf_torch.train.step import (
    dataset_to_device, device_generator, psnr, render_pixels, sample_pixel_coords, staged_adam,
)


def compute_speaker_ids(speak_frames: Sequence[np.ndarray]) -> list:
    """Per-frame speaker of each conversational pair of datasets (reference
    run_nerf_com_trainExpLater.py:485-489): ``speak[2i] + 2 speak[2i+1]``,
    values of 3 and over set to 0, minus 1; so 0 means dataset 2i speaks, 1
    dataset 2i+1, and -1 neither (or both)."""
    out = []
    for i in range(len(speak_frames) // 2):
        sid = (np.asarray(speak_frames[2 * i]).astype(np.int64)
               + 2 * np.asarray(speak_frames[2 * i + 1]).astype(np.int64))
        sid[sid >= 3] = 0
        out.append(sid - 1)
    return out


class _Object:
    """The host side of one identity: its camera, depths, training frames,
    face rects and speaking frames."""

    def __init__(self, ds: FrameDataset, dynamic_speaker: bool):
        self.hwfcxy = ds.hwfcxy
        self.H, self.W = int(ds.hwfcxy[0]), int(ds.hwfcxy[1])
        self.i_train = np.asarray(ds.i_train if dynamic_speaker else speaking_i_train(ds))
        self.n_train = len(self.i_train)
        self.near, self.far = float(ds.near), float(ds.far)
        self.rects = (np.asarray(ds.sample_rects) if ds.sample_rects is not None
                      else np.zeros((ds.n_frames, 4), np.int32))
        self.speak = None if ds.speak_frames is None else np.asarray(ds.speak_frames)


class MultiIdentityTrainStep:
    """``step(state, data_list, generator) -> (state, metrics)``, the state
    updated in place; or ``draw_batch(generator)`` (a batch per object) then
    ``step_on_batch(state, data_list, batches)``. Metrics: each object's
    ``loss_obj{o}`` and ``psnr_com_obj{o}``, and their ``loss`` summed."""

    def __init__(self, cfg: ExperimentConfig, datasets: Sequence[FrameDataset], mesh=None,
                 dynamic_speaker: bool = False, device=None):
        if cfg.train.n_object != len(datasets):
            raise ValueError(f"n_object={cfg.train.n_object} but {len(datasets)} datasets")
        if dynamic_speaker and any(ds.speak_frames is None for ds in datasets):
            raise ValueError("dynamic_speaker needs per-frame speak_frames on every dataset")
        self.cfg = cfg
        self.mesh = mesh
        self.dynamic_speaker = dynamic_speaker
        self.device = mesh_device(mesh) if mesh is not None else resolve_device(device)
        self.world = mesh.size() if mesh is not None else 1
        self.rank = mesh.get_local_rank() if mesh is not None else 0
        if cfg.train.n_rand % self.world:
            raise ValueError(f"n_rand={cfg.train.n_rand} does not divide over {self.world} ranks")
        self.objects = [_Object(ds, dynamic_speaker) for ds in datasets]

    def __call__(self, state: TrainState, data_list: List[Dict], generator: torch.Generator):
        return self.step_on_batch(state, data_list, self.draw_batch(generator))

    def draw_batch(self, generator: torch.Generator) -> List[Dict]:
        """{"img_i", "coords": [n_rand, 2], "z_vals": [n_rand / W, S]} for
        each object, drawn from the host generator."""
        tcfg, out = self.cfg.train, []
        for ob in self.objects:
            img_i = int(ob.i_train[int(torch.randint(ob.n_train, (), generator=generator))])
            g = device_generator(generator, self.device)
            coords = sample_pixel_coords(g, ob.H, ob.W, tcfg.n_rand, tcfg.sample_rate,
                                         ob.rects[img_i], device=self.device)
            out.append({"img_i": img_i, "coords": coords, "z_vals": self.z_vals(ob)})
        return out

    def z_vals(self, ob: _Object) -> torch.Tensor:
        return stratified_z_vals(ob.near, ob.far, self.cfg.train.n_rand // self.world,
                                 self.cfg.render.n_samples, device=self.device)

    def speaks(self, obj: int, img_i: int) -> bool:
        """Whether object ``obj`` renders frame img_i through the speaker's
        branch: object 0 always, or its speak_frames with dynamic_speaker."""
        if self.dynamic_speaker:
            return bool(self.objects[obj].speak[img_i] > 0)
        return obj == 0

    def object_loss(self, params, state: TrainState, data: Dict, obj: int, batch: Dict,
                    use_smo: bool):
        """(loss, loss_head, loss_com) of object ``obj``'s batch (this rank's
        slice with a mesh), the signals inside the gradient (reference :78)."""
        scfg, ob = self.cfg.signal, self.objects[obj]
        img_i = batch["img_i"]
        n = self.cfg.train.n_rand // self.world
        coords = batch["coords"][self.rank * n:(self.rank + 1) * n]
        signal_torso = encode_signal_torso(params, data["poses"], img_i, ob.n_train,
                                           scfg.smo_torso_size, use_smo, scfg.et_multires)
        if self.speaks(obj, img_i):
            signal = encode_signal(params, data["auds"], data["exps"], img_i, ob.n_train,
                                   scfg.smo_size, use_smo, scfg.audio_net, scfg.win_size)
            branch = "head"
        else:
            signal, branch = None, "head_listener"
        outs, target_head, target_com = render_pixels(
            params, self.cfg.render, data, ob.hwfcxy, img_i, coords, batch["z_vals"], signal,
            signal_torso, state["z_shape"], state["z_app"], obj=obj, head_branch=branch)
        loss_head = torch.mean((outs[0] - target_head) ** 2)
        loss_com = torch.mean((outs[1] - target_com) ** 2)
        return loss_head + loss_com, loss_head, loss_com

    def step_on_batch(self, state: TrainState, data_list: List[Dict], batches: List[Dict]):
        """One step over every object in order: each object's loss, backward
        (averaged over the mesh when there is one) and staged Adam step."""
        scfg = self.cfg.signal
        params, step = state["params"], state["step"]
        use_smo, use_exp = step >= scfg.nosmo_iters, step >= scfg.noexp_iters
        metrics = {}
        for obj, (data, batch) in enumerate(zip(data_list, batches)):
            for p in params.parameters():
                p.grad = None
            loss, loss_head, loss_com = self.object_loss(params, state, data, obj, batch,
                                                         use_smo)
            loss.backward()
            if self.mesh is not None:
                loss, loss_head, loss_com = all_reduce_mean(
                    params, [loss, loss_head, loss_com], self.mesh)
            staged_adam(self.cfg, state, use_smo, use_exp)
            metrics[f"loss_obj{obj}"] = loss.detach()
            metrics[f"psnr_com_obj{obj}"] = psnr(loss_com.detach())
        state["step"] = step + 1
        metrics["loss"] = sum(metrics[f"loss_obj{o}"] for o in range(len(self.objects)))
        return state, metrics


def make_multi_identity_train_step(cfg: ExperimentConfig, datasets: Sequence[FrameDataset],
                                   mesh=None, dynamic_speaker: bool = False, device=None):
    """The multi-identity step over ``datasets`` (one per object) and each
    object's device data: (step, data_list). With a ``mesh`` the step runs
    on this rank's device of it, else on ``device`` (default CUDA)."""
    step = MultiIdentityTrainStep(cfg, datasets, mesh=mesh, dynamic_speaker=dynamic_speaker,
                                  device=device)
    return step, [dataset_to_device(ds, step.device) for ds in datasets]
