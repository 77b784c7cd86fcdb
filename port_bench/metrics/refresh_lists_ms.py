"""Occupancy and refresh: the host's work on the flags at a refresh frame,
the median over the traced refresh frames of the frame's summed
``occupancy.lists`` spans (tile classes or pair lists built on the host and
uploaded). Moves frame_ms_p95."""

from port_bench.program_spans import median_per_refresh_frame


def read(run):
    return median_per_refresh_frame(run, {"occupancy.lists"})
