"""Kernel build and load: the seconds the program spent building (nvcc, a
checkout's first run) and loading its kernel libraries before the first
timed frame, its ``kernel.build`` and ``kernel.load`` spans, which it keeps
whether or not it records (dfanerf_torch/ops/_build.py LOADS). Moves
setup_s."""


def read(run):
    try:
        from dfanerf_torch.ops import _build
    except ImportError:
        return None
    loads = getattr(_build, "LOADS", None)
    if not loads:
        return None
    t_start = int(run.t_start * 1e9)
    return sum(t1 - t0 for _, t0, t1 in loads if t1 <= t_start) * 1e-9
