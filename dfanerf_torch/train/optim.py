"""Staged Adam (port of dfanerf_tpu/train/optim.py): per-group Adam whose
groups are switched on by the step.

The reference trains five groups with their own Adam and steps a group
only once its stage has begun (run_nerf_com_trainExpLater.py:916-931). A
group that is off keeps its parameters, its moments and its step count.
The moments sit in a dict per group, keyed by the group module's parameter
names, so a checkpoint writes them under the reference's tree keys
(train/checkpoint.py). The update is written out over the group's tensors,
as the reference's is: ``torch.optim.Adam`` neither keeps that layout nor
rounds its bias corrections in float32.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn


def adam_init(module: nn.Module) -> Dict:
    """Zero moments for every parameter of ``module`` and a step count of 0."""
    return adam_state(dict(module.named_parameters()))


def adam_state(tensors: Dict[str, torch.Tensor]) -> Dict:
    """Zero moments for named tensors (parameters or not) and a step count of 0."""
    return {"m": {n: torch.zeros_like(p) for n, p in tensors.items()},
            "v": {n: torch.zeros_like(p) for n, p in tensors.items()},
            "t": 0}


@torch.no_grad()
def adam_update(opt: Dict, grads: Dict[str, Optional[torch.Tensor]],
                params: Dict[str, torch.Tensor], lr: float, gate: bool, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8) -> None:
    """One Adam step of a group, in place (reference :35): nothing moves when
    ``gate`` is off. A parameter without a gradient (``None``: it took no part
    in the loss) steps with a zero gradient, as the reference's does. The bias
    corrections are float32; lr is a float32 value."""
    if not gate:
        return
    t = opt["t"] + 1
    tf = np.float32(t)
    c1 = float(np.float32(1.0) - np.float32(b1) ** tf)
    c2 = float(np.float32(1.0) - np.float32(b2) ** tf)
    names = list(params)
    p = [params[n] for n in names]
    m = [opt["m"][n] for n in names]
    v = [opt["v"][n] for n in names]
    g = [grads[n] if grads.get(n) is not None else torch.zeros_like(params[n]) for n in names]
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - b1))
    g2 = torch._foreach_mul(g, 1.0 - b2)
    torch._foreach_mul_(g2, g)
    torch._foreach_mul_(v, b2)
    torch._foreach_add_(v, g2)
    upd = torch._foreach_div(m, c1)
    torch._foreach_mul_(upd, float(lr))
    den = torch._foreach_div(v, c2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(upd, den)
    torch._foreach_sub_(p, upd)
    opt["t"] = t


class DeviceAdam:
    """``adam_update``'s arithmetic over named tensors with the step count on
    the device, so a step issues no host work that depends on it and can be
    captured in a CUDA graph (the 3DMM tracker's and bundle adjustment's
    loops, pipeline/tracking.py). The bias corrections of steps 1..n_steps
    are float32 values computed on the host as ``adam_update`` computes
    them, and a step reads its pair from that table at the device count."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, n_steps: int,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = params
        self.lr, self.b1, self.b2, self.eps = float(lr), b1, b2, eps
        dev = next(iter(params.values())).device
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        corr = [[np.float32(1.0) - np.float32(b) ** np.float32(t) for b in (b1, b2)]
                for t in range(1, max(n_steps, 1) + 1)]
        self.corr = torch.tensor(np.asarray(corr, np.float32)).to(dev)
        self.t = torch.zeros(1, dtype=torch.int64, device=dev)

    def state(self):
        """Every tensor a step changes: the parameters, moments and count."""
        return [*self.params.values(), *self.m.values(), *self.v.values(), self.t]

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        c = torch.index_select(self.corr, 0, self.t)[0]
        c1, c2 = c[0], c[1]
        for n, p in self.params.items():
            g, m, v = grads[n], self.m[n], self.v[n]
            m.mul_(self.b1).add_(g * (1.0 - self.b1))
            v.mul_(self.b2).add_(g * (1.0 - self.b2) * g)
            upd = (m / c1).mul_(self.lr)
            p.sub_(upd.div_((v / c2).sqrt_().add_(self.eps)))
        self.t += 1


def exp_decay_lr(step: int, lrate: float, lrate_decay: int, decay_unit: int = 1500) -> np.float32:
    """lr(step) = lrate * 0.1^(step / (lrate_decay * decay_unit)) in float32
    (reference :88; run_nerf_com_trainExpLater.py:1081-1083)."""
    decay_steps = np.float32(lrate_decay * decay_unit)
    return np.float32(lrate) * np.power(np.float32(0.1), np.float32(step) / decay_steps)
