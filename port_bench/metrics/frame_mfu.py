"""The whole frame's share of the card's bf16 peak: the field FLOPs of the
(ray, sample) points that the traced frames' listed blocks hold (the lists
and flags in the renderer's state after each frame), at the decoder's live
widths (port_bench/counts.py), over the traced window's time. Occupancy,
refresh and the far plane count as no work. Moves fps."""

from port_bench import counts
from port_bench.serve import work_flops


def read(run):
    tr = run.trace
    frames = [f for f in run.frames if f.traced and f.work is not None]
    if tr is None or not frames:
        return None
    flops = sum(work_flops(k, fields, blocks) for f in frames for k, fields, _, blocks in f.work)
    if flops <= 0:
        return None
    return 100.0 * flops / counts.PEAK_BF16_FLOPS / tr.window_s
