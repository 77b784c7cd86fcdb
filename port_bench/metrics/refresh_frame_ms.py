"""Occupancy and refresh: the median latency, dispatch to pixels on the host,
of the window's refresh frames (those after which the renderer's state
reads age 1). Moves frame_ms_p95."""

import statistics


def read(run):
    ms = [f.ms for f in run.frames if f.refreshed]
    return statistics.median(ms) if ms else None
