"""Preprocessing pipeline (port of dfanerf_tpu/pipeline): so far the audio
feature stack, ``pipeline.audio``."""
