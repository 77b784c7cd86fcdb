"""GhostNet face-landmark encoder-decoder (port of
dfanerf_tpu/models/perception/ghostnet_face.py; the module tree and keys are
lib/models/face_ghostnet.py's).

The eye net's GhostModule / GhostBottleneck encoder-decoder
(``ghostnet_eye.py``) with an RGB stem, the face set tables, the optional
extra encoder layers (``addition_encoder``: the first n of
``FACE_ENCODER_ADD_SETS``) and the deeper decoder table
(``addition_decoder``), and a 1x1 head to the landmarks' heatmaps. Each
decoder level is a bilinear upsampling (half-pixel centres, by the set's
stride) followed by a stride-1 bottleneck. ``GhostEncoderDecoder`` is the
skeleton, shared with the zoo's general eye net (``zoo_extra.py``).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dfanerf_torch.models.perception.common import ConvBN, StateDict, UpsampleLinear
from dfanerf_torch.models.perception.ghostnet_eye import (
    GhostBottleneck, _divisible, eye_net_state_dict_from_jax,
)

# (kernel, hidden, out, use_se, stride)
FACE_ENCODER_SETS = [
    (3, 16, 16, 0, 1),
    (3, 48, 24, 0, 2),
    (3, 72, 24, 0, 1),
    (5, 72, 40, 1, 2),
    (5, 120, 40, 1, 1),
    (3, 240, 80, 0, 2),
]
FACE_ENCODER_ADD_SETS = [
    (3, 200, 80, 0, 1),
    (3, 184, 80, 0, 1),
    (3, 184, 80, 0, 1),
    (3, 480, 112, 1, 1),
    (3, 672, 112, 1, 1),
]
FACE_DECODER_SETS = [  # the no-addition variant
    (4, 120, 40, 1, 2),
    (4, 72, 40, 1, 2),
    (4, 72, 24, 1, 2),
]
FACE_DECODER_ADD_SETS = [  # the ADDITION_DECODER_LAYER variant
    (4, 184, 80, 1, 2),
    (4, 120, 80, 1, 2),
    (4, 72, 40, 1, 2),
]


def _sets(addition_encoder: Optional[int], addition_decoder: bool):
    enc = list(FACE_ENCODER_SETS)
    if addition_encoder:
        assert addition_encoder < 6
        enc += FACE_ENCODER_ADD_SETS[:addition_encoder]
    dec = FACE_DECODER_ADD_SETS if addition_decoder else FACE_DECODER_SETS
    return enc, dec



def gaussian_kernel(channels: int, sigma: float) -> torch.Tensor:
    """The gaussian-modulation depthwise kernel [channels, 1, size, size],
    size = int(6 sigma + 1): an unnormalised gaussian centred in the window."""
    size = int(2 * (sigma * 3) + 1)
    x = torch.arange(size, dtype=torch.float32)
    y = x[:, None]
    g = torch.exp(-((x - size // 2) ** 2 + (y - size // 2) ** 2) / (2.0 * sigma ** 2))
    return g.expand(channels, 1, size, size)


class GhostEncoderDecoder(nn.Module):
    """Stem (3x3 / 2, 16 channels), ghost-bottleneck encoder, (upsampling +
    bottleneck) decoder, a 1x1 head to ``num_joints`` channels, and with
    ``gaussian_sigma`` > 0 the heatmaps smoothed by ``gaussian_kernel``
    (zero-padded, per channel)."""

    def __init__(self, in_ch: int, encoder_sets: Sequence, decoder_sets: Sequence,
                 num_joints: int, gaussian_sigma: float = 0.0):
        super().__init__()
        layers = [ConvBN(in_ch, 16, 3, 2, 1)]
        inp = 16
        for k, hidden, c, use_se, s in encoder_sets:
            layers.append(GhostBottleneck(inp, _divisible(hidden), _divisible(c), k, s, use_se))
            inp = _divisible(c)
        self.features = nn.Sequential(*layers)
        head = []
        for k, hidden, c, use_se, s in decoder_sets:
            head += [UpsampleLinear(s),
                     GhostBottleneck(inp, _divisible(hidden), _divisible(c), k, 1, use_se)]
            inp = _divisible(c)
        self.head = nn.Sequential(*head)
        self.final_layer = nn.Conv2d(inp, num_joints, 1)
        self.gaussian_sigma = gaussian_sigma

    def forward(self, x):
        x = self.final_layer(self.head(self.features(x)))
        if self.gaussian_sigma > 0:
            k = gaussian_kernel(x.shape[1], self.gaussian_sigma).to(x)
            x = F.conv2d(x, k, padding=k.shape[-1] // 2, groups=x.shape[1])
        return x


class FaceGhostNet(GhostEncoderDecoder):
    """[N, 3, 256, 256] -> heatmaps [N, num_joints, 64, 64] (the reference's
    output dict carries them under 'heatmap')."""

    def __init__(self, num_joints: int = 68, addition_encoder: Optional[int] = None,
                 addition_decoder: bool = False):
        super().__init__(3, *_sets(addition_encoder, addition_decoder), num_joints)


def face_ghostnet_state_dict_from_jax(params: Mapping) -> StateDict:
    """The inverse of the reference's ``face_ghostnet_from_torch`` (the eye
    net's layout)."""
    return eye_net_state_dict_from_jax(params)
