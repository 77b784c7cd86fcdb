"""Serving loop: the median host time of a frame's calls into the program
(signals and render) before its output is waited for, over the window.
Moves fps."""

import statistics


def read(run):
    if not run.frames:
        return None
    return statistics.median((f.t1 - f.t0) * 1e3 for f in run.frames)
