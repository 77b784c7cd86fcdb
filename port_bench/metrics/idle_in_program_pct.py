"""Device: the share of the traced window in which the device is idle while
the serving thread is inside the program, 100 x (idle time under an open
outermost program span) / window. The spans move onto the trace's clock by
the offset that placed the window's first frame (Profiler.reduce). The rest
of device_idle_pct.serve is idle time in the benchmark's own loop and in
the copy of each frame to the host. Moves fps."""

import bisect

from port_bench.program_spans import recorded


def read(run):
    tr, record = run.trace, recorded()
    traced = [f for f in run.frames if f.traced]
    if tr is None or not record or not traced or tr.window_s <= 0:
        return None
    serving = {s[1] for s in record if s[0] == "render.frame"}
    offset = tr.start - int(round(traced[0].t0 * 1e9))
    busy = tr.busy_intervals()
    starts = [s for s, _ in busy]
    idle = 0
    for name, tid, depth, t0, t1 in record:
        if depth or tid not in serving:
            continue
        a, b = max(t0 + offset, tr.start), min(t1 + offset, tr.end)
        if b <= a:
            continue
        covered = 0
        for s, e in busy[max(bisect.bisect_right(starts, a) - 1, 0):]:
            if s >= b:
                break
            covered += max(0, min(e, b) - max(s, a))
        idle += (b - a) - covered
    return 100.0 * idle * 1e-9 / tr.window_s
