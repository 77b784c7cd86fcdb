"""Train state (port of dfanerf_tpu/train/state.py).

``Params`` holds every network under the reference package's parameter-tree
keys (decoder, audnet, expnet, audattnet, poseattnet); the state adds each
optimizer group's Adam moments (``opt``, train/optim.py), the
per-(object, part) latents z_shape and z_app and the step counter, a host
int, so that the stage gates of a step need no device read.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from dfanerf_torch.config import ExperimentConfig
from dfanerf_torch.core.posenc import nerf_embed_dim
from dfanerf_torch.device import resolve_device
from dfanerf_torch.models import AudioAttNet, AudioNet, AudioNetW2L, Decoder, ExpressionEnc
from dfanerf_torch.models.layers import init_uniform_
from dfanerf_torch.train.optim import adam_init

TrainState = Dict[str, Any]

# optimizer groups: (params key, lr multiplier, gate kind); gate kinds:
# "always", "smo" (step >= nosmo_iters), "exp" (step >= noexp_iters)
OPT_GROUPS = (
    ("decoder", 1.0, "always"),
    ("audnet", 1.0, "always"),
    ("expnet", 1.0, "exp"),
    ("audattnet", 2.0, "smo"),
    ("poseattnet", 2.0, "smo"),
)


class Params(nn.Module):
    """Every network of one identity."""

    def __init__(self, cfg: ExperimentConfig):
        super().__init__()
        dim_et = 2 * nerf_embed_dim(cfg.signal.et_multires)
        self.decoder = Decoder(cfg.decoder)
        if cfg.signal.audio_net == "deepspeech":
            # 32 of the signal's dims come from the expression encoder
            self.audnet = AudioNet(dim_aud=cfg.signal.dim_signal - 32)
        else:
            self.audnet = AudioNetW2L()
        self.expnet = ExpressionEnc()
        self.audattnet = AudioAttNet(dim_aud=cfg.signal.dim_aud, seq_len=cfg.signal.smo_size)
        self.poseattnet = AudioAttNet(dim_aud=dim_et, seq_len=cfg.signal.smo_torso_size)


def init_train_state(cfg: ExperimentConfig, seed: int = 0, device=None) -> TrainState:
    """Seeded state with the reference package's shapes, on ``device``
    (default CUDA; see device.resolve_device). The weights come from a
    ``torch.Generator`` on the CPU, so they are the same on every device but
    differ from the JAX package's init for the same seed; tests convert
    JAX's state instead (compat/from_jax.py)."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    with torch.device("meta"):
        params = Params(cfg)
    params = init_uniform_(params.to_empty(device="cpu"), g)
    n_lat = cfg.train.n_object * 2  # (head, torso) latent pair per object
    params = params.to(device)
    return {
        "params": params,
        "opt": {name: adam_init(getattr(params, name)) for name, _, _ in OPT_GROUPS},
        "z_shape": torch.randn((n_lat, cfg.train.z_dim), generator=g).to(device),
        "z_app": torch.randn((n_lat, cfg.train.z_dim), generator=g).to(device),
        "step": 0,
    }
