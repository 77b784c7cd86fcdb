"""Preprocessing pipeline (port of dfanerf_tpu/pipeline): the DAG from a
video to an identity directory (``driver.py``, ``cli process``), its array
steps, the 3DMM and its tracker, the distangler, and the audio feature
stack, ``pipeline.audio``."""
