"""Kernel wrappers: the median over the traced frames of the host time in
the kernel bindings' calls, each frame's outermost ``kernel.*`` spans
summed (operand checks, the weight re-lay, the launch). Moves fps."""

import statistics

from port_bench.program_spans import frames_with_spans, outermost


def read(run):
    frames = frames_with_spans(run)
    if frames is None:
        return None
    return statistics.median(sum(s[4] - s[3] for s in outermost(sp, "kernel.")) * 1e-6
                             for _, sp in frames)
