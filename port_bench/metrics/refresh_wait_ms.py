"""Occupancy and refresh: the host's wait at a refresh frame, the median
over the traced refresh frames of the frame's summed ``occupancy.download``
spans (the flags' copies to the host, each waiting for the work queued
before it). Moves frame_ms_p95."""

from port_bench.program_spans import median_per_refresh_frame


def read(run):
    return median_per_refresh_frame(run, {"occupancy.download"})
