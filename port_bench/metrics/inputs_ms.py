"""Serving loop: the median over the traced frames of the host time a frame
spends on its inputs, ``render.signals`` (the signal encoders) and
``render.inputs`` (weight packing, rays, background). Moves fps."""

from port_bench.program_spans import median_per_frame


def read(run):
    return median_per_frame(run, {"render.signals", "render.inputs"})
