"""Expression disentanglement (port of dfanerf_tpu/pipeline/disentangle.py):
pipeline step 10's inference and the distangler's training.

The distangler splits a 79-dim 3DMM expression code into a mouth part and
an everything-else part (the "DFA" in DFA-NeRF): a 79 -> 128 -> 256 -> 256
trunk, then two linear branches (others: dim_o, mouth: dim_m; the shipped
checkpoints use 64/32). The concatenater maps (others, mouth) back to 79
dims; the mouth-keypoint net maps a mouth code to mouth landmark offsets
(Linear + BatchNorm + ReLU). The modules' keys are the reference's
network.py ones, so ``dis_ckpt.pth`` loads as it is.

Training (reference train_with_cycle.py:120-240) is mouth swap plus cycle
consistency: each batch splits in halves that swap mouth codes, supervised
through the 3DMM's landmark geometry (landmarks 31:51, the mouth, follow
the donor; 0:31 stay), then the swapped codes are re-disentangled and must
give back the original geometry. The reference leaves its swap loss out of
the backward (train_with_cycle.py:177); ``swap_weight`` 0 reproduces that,
its default 1.0 trains both, as the reference package's does.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dfanerf_torch.compat.torch_ckpt import _copy
from dfanerf_torch.device import resolve_device
from dfanerf_torch.models.layers import init_uniform_
from dfanerf_torch.models.perception.common import StateDict, load_net, put_bn, put_linear
from dfanerf_torch.pipeline.face3dmm import Face3DMM, forward_geo_sub
from dfanerf_torch.train.optim import adam_init, adam_update

MOUTH_IDX = (31, 51)   # landmark rows [31, 51) of the last-51 set
OTHER_IDX = (0, 31)


class Distangler(nn.Module):
    def __init__(self, input_dim: int = 79, dim_o: int = 64, dim_m: int = 32):
        super().__init__()
        self.fc1 = nn.Linear(input_dim, 128)
        self.fc2 = nn.Linear(128, 256)
        self.fc3 = nn.Linear(256, 256)
        self.branch1 = nn.Linear(256, dim_o)
        self.branch2 = nn.Linear(256, dim_m)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        h = F.relu(self.fc3(F.relu(self.fc2(F.relu(self.fc1(x))))))
        return self.branch1(h), self.branch2(h)


def load_distangler(spec: str, device=None) -> Distangler:
    """``dis_ckpt.pth`` (the branch widths read off it) or ``random:<seed>``,
    in eval mode on ``device`` (default CUDA)."""
    def build(sd):
        if not sd:
            return Distangler()
        return Distangler(int(sd["fc1.weight"].shape[1]), int(sd["branch1.weight"].shape[0]),
                          int(sd["branch2.weight"].shape[0]))

    return load_net(spec, build, device)


def distangler_state_dict_from_jax(params: Mapping) -> StateDict:
    """The reference's parameter tree (numpy leaves) -> this module's state
    dict: the inverse of ``distangler_from_torch``."""
    sd: StateDict = {}
    for k in ("fc1", "fc2", "fc3", "branch1", "branch2"):
        put_linear(sd, k, params[k])
    return sd


@torch.no_grad()
def disentangle_sequence(dis: Distangler, exps) -> Dict[str, np.ndarray]:
    """Per-frame exp [N, 79] -> the ``{id}_64_32.pt`` contract {'exp_o',
    'exp_m'} (numpy), computed on the net's device."""
    dev = next(dis.parameters()).device
    o, m = dis(torch.as_tensor(np.asarray(exps, np.float32)).to(dev))
    return {"exp_o": o.cpu().numpy(), "exp_m": m.cpu().numpy()}


class Concatenater(nn.Module):
    """(others [.., dim_o], mouth [.., dim_m]) -> a 79-dim expression code."""

    def __init__(self, dim_o: int = 64, dim_m: int = 32, output_dim: int = 79):
        super().__init__()
        self.fc1 = nn.Linear(dim_o + dim_m, 128)
        self.fc2 = nn.Linear(128, 256)
        self.fc3 = nn.Linear(256, output_dim)

    def forward(self, x_o, x_m) -> torch.Tensor:
        h = F.relu(self.fc2(F.relu(self.fc1(torch.cat([x_o, x_m], dim=-1)))))
        return self.fc3(h)


class MouthExp2KptsNet(nn.Module):
    """Mouth code [B, input_dims] -> mouth keypoint offsets [B, output_dims]
    through Linear + BatchNorm + ReLU layers. ``train=True`` normalises by
    the batch's mean and population variance; ``train=False`` by the
    running statistics. Neither mode updates the running statistics, as in
    the reference package (torch's BatchNorm momentum update is not used)."""

    def __init__(self, input_dims: int = 32, hidden_dims: int = 64, num_hidden_layers: int = 0,
                 output_dims: int = 40):
        super().__init__()
        self.input = nn.Linear(input_dims, hidden_dims)
        self.input_bn = nn.BatchNorm1d(hidden_dims)
        self.hidden = nn.ModuleList(
            [nn.Linear(hidden_dims, hidden_dims) for _ in range(num_hidden_layers)])
        self.hidden_bn = nn.ModuleList(
            [nn.BatchNorm1d(hidden_dims) for _ in range(num_hidden_layers)])
        self.output = nn.Linear(hidden_dims, output_dims)

    @staticmethod
    def _bn(bn: nn.BatchNorm1d, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            mean, var = x.mean(dim=0), x.var(dim=0, correction=0)
        else:
            mean, var = bn.running_mean, bn.running_var
        return bn.weight * (x - mean) / torch.sqrt(var + 1e-5) + bn.bias

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = F.relu(self._bn(self.input_bn, self.input(x), train))
        for lin, bn in zip(self.hidden, self.hidden_bn):
            h = F.relu(self._bn(bn, lin(h), train))
        return self.output(h)


def distangler_from_torch(sd: Mapping) -> StateDict:
    """The reference's Distangler state dict (pretrained_models/{64_32,32_16})
    -> this module's: float32 copies of the same keys."""
    return {f"{k}.{leaf}": _copy(sd[f"{k}.{leaf}"])
            for k in ("fc1", "fc2", "fc3", "branch1", "branch2") for leaf in ("weight", "bias")}


def concatenater_from_torch(sd: Mapping) -> StateDict:
    """The reference's Concatenater state dict -> this module's copies."""
    return {f"{k}.{leaf}": _copy(sd[f"{k}.{leaf}"])
            for k in ("fc1", "fc2", "fc3") for leaf in ("weight", "bias")}


def concatenater_state_dict_from_jax(params: Mapping) -> StateDict:
    """The reference package's concatenater tree -> Concatenater's state dict."""
    sd: StateDict = {}
    for k in ("fc1", "fc2", "fc3"):
        put_linear(sd, k, params[k])
    return sd


def mouth_exp2kpts_state_dict_from_jax(params: Mapping) -> StateDict:
    """The reference package's mouth-keypoint tree -> MouthExp2KptsNet's."""
    sd: StateDict = {}
    put_linear(sd, "input", params["input"])
    put_bn(sd, "input_bn", params["input_bn"])
    for i, (lin, bn) in enumerate(zip(params["hidden"], params["hidden_bn"])):
        put_linear(sd, f"hidden.{i}", lin)
        put_bn(sd, f"hidden_bn.{i}", bn)
    put_linear(sd, "output", params["output"])
    return sd


def make_disentangle_train_step(model: Face3DMM, lands_idx, lr: float = 1e-3, coord_dim: int = 2,
                                swap_weight: float = 1.0, use_vec_loss: bool = False,
                                use_exp_loss: bool = False, id_dim: int = 100):
    """The mouth-swap + cycle train step over an expression batch [B, 79].

    Returns (init, step). ``init(seed=0, dim_o=64, dim_m=32, device=None)``
    gives seeded nets, an ``nn.ModuleDict`` {"dis", "cat"} on ``device``
    (default CUDA), and their Adam state; ``step(params, opt, exp_batch,
    lr_now)`` takes one Adam step in place and returns the losses before it,
    {"swap", "cycle", "total"}. The 3DMM geometry is the model's, on its
    device, at zero identity."""
    mouth, other = slice(*MOUTH_IDX), slice(*OTHER_IDX)

    def geo(exp):
        return forward_geo_sub(model, exp.new_zeros((exp.shape[0], id_dim)), exp, lands_idx)

    def ll(a, b):
        return ((a[..., :coord_dim] - b[..., :coord_dim]) ** 2).mean()

    def losses(params, exp_batch):
        dis, cat = params["dis"], params["cat"]
        half = exp_batch.shape[0] // 2
        e1, e2 = exp_batch[:half], exp_batch[half:]
        o1, m1 = dis(e1)
        o2, m2 = dis(e2)
        e_1o2m, e_2o1m = cat(o1, m2), cat(o2, m1)
        g1, g2 = geo(e1).detach(), geo(e2).detach()
        g_sw1, g_sw2 = geo(e_1o2m), geo(e_2o1m)
        loss_swap = (ll(g_sw1[:, other], g1[:, other]) + ll(g_sw1[:, mouth], g2[:, mouth])
                     + ll(g_sw2[:, other], g2[:, other]) + ll(g_sw2[:, mouth], g1[:, mouth]))
        # cycle: re-disentangle the swapped codes, swap back, compare geometry
        o1b, m2b = dis(e_1o2m)
        o2b, m1b = dis(e_2o1m)
        e_back1, e_back2 = cat(o1b, m1b), cat(o2b, m2b)
        loss_cycle = ll(geo(e_back1), g1) + ll(geo(e_back2), g2)
        if use_vec_loss:
            loss_cycle = loss_cycle + ((o1b - o1).abs().mean() + (o2b - o2).abs().mean()
                                       + (m1b - m1).abs().mean() + (m2b - m2).abs().mean())
        if use_exp_loss:
            loss_cycle = loss_cycle + ((e1 - e_back1) ** 2).mean() + ((e2 - e_back2) ** 2).mean()
        return swap_weight * loss_swap + loss_cycle, loss_swap, loss_cycle

    def step(params: nn.ModuleDict, opt, exp_batch, lr_now) -> Dict[str, torch.Tensor]:
        total, loss_swap, loss_cycle = losses(params, exp_batch)
        named = dict(params.named_parameters())
        grads = torch.autograd.grad(total, list(named.values()))
        adam_update(opt, dict(zip(named, grads)), named, lr_now, True)
        return {"swap": loss_swap.detach(), "cycle": loss_cycle.detach(), "total": total.detach()}

    def init(seed: int = 0, dim_o: int = 64, dim_m: int = 32, device=None):
        g = torch.Generator().manual_seed(seed)
        params = nn.ModuleDict({"dis": Distangler(dim_o=dim_o, dim_m=dim_m),
                                "cat": Concatenater(dim_o=dim_o, dim_m=dim_m)})
        params = init_uniform_(params, g).to(resolve_device(device))
        return params, adam_init(params)

    return init, step
