"""Kernel wrappers: the weight blobs re-laid per served frame, the mean over
the traced frames of the count of ``kernel.blobs`` spans (one field's
weights staged for one launch). Moves fps."""

import statistics

from port_bench.program_spans import frames_with_spans


def read(run):
    frames = frames_with_spans(run)
    if frames is None:
        return None
    return statistics.mean(sum(s[0] == "kernel.blobs" for s in sp) for _, sp in frames)
