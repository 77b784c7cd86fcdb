"""Model zoo: the decoder and the signal encoders as ``nn.Module``s."""

from dfanerf_torch.models.decoder import Decoder, DecoderConfig, DeformationField
from dfanerf_torch.models.encoders import (
    AudioAttNet, AudioNet, AudioNetW2L, ExpressionEnc, ExpressionEncHalf,
)

__all__ = [
    "AudioAttNet",
    "AudioNet",
    "AudioNetW2L",
    "Decoder",
    "DecoderConfig",
    "DeformationField",
    "ExpressionEnc",
    "ExpressionEncHalf",
]
