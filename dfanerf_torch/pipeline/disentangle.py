"""Expression disentanglement at inference, pipeline step 10 (port of
dfanerf_tpu/pipeline/disentangle.py :41-65, :129-134, :221-227).

The distangler splits a 79-dim 3DMM expression code into a mouth part and
an everything-else part (the "DFA" in DFA-NeRF): a 79 -> 128 -> 256 -> 256
trunk, then two linear branches (others: dim_o, mouth: dim_m; the shipped
checkpoints use 64/32). Its keys are the reference's network.py
``Distangler``'s, so ``dis_ckpt.pth`` loads as it is. The concatenater,
the mouth-keypoint net and the mouth-swap training are not on the
preprocessing path and are not ported.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dfanerf_torch.models.perception.common import StateDict, load_net, put_linear


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
