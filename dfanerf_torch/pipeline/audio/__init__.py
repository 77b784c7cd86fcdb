"""Audio feature stack (port of dfanerf_tpu/pipeline/audio): the DSP
frontends (mel spectrogram, MFCC), the wav2exp AudioEncoder and the
DeepSpeech feature network (``pipeline.audio.deepspeech``)."""

from dfanerf_torch.pipeline.audio.frontend import (
    Wav2ExpHParams,
    interpolate_features,
    melspectrogram,
    mfcc,
    sliding_windows,
)
from dfanerf_torch.pipeline.audio.wav2exp import (
    apply_audio_encoder,
    audio_encoder_from_torch,
    init_audio_encoder,
    wav2exp_features,
)

__all__ = [
    "melspectrogram",
    "mfcc",
    "Wav2ExpHParams",
    "interpolate_features",
    "sliding_windows",
    "init_audio_encoder",
    "apply_audio_encoder",
    "audio_encoder_from_torch",
    "wav2exp_features",
]
