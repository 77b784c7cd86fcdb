"""Training step: the median host time to issue a step (the program's call
returns before its device work is done) over the window. Moves
train_rays_per_s."""

import statistics


def read(run):
    if not run.steps:
        return None
    return statistics.median((b - a) * 1e3 for a, b, _ in run.steps)
