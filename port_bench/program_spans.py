"""The program's own spans in a traced run (dfanerf_torch/spans.py): the
port records them while a torch profiler runs, so the frames of the traced
window carry them with no switch of the benchmark's, and the readers take
them from the process after the window. A program without the span API (an
older checkout) gives None, and each reader then reports nothing.

A frame's spans are the serving thread's (the thread that reads them, which
served the frames) that lie inside its [t0, t1], the benchmark's call into
the program; times are perf_counter_ns, the clock of Frame.t0 and t1.
"""

import statistics
import threading

SLACK_NS = 1000  # Frame times are perf_counter floats; spans are ns


def recorded():
    """The process's span record, or None without the span API."""
    try:
        from dfanerf_torch import spans
    except ImportError:
        return None
    return spans.recorded()


def frames_with_spans(run):
    """[(frame, [its spans])] of the traced frames, or None where no span was
    recorded."""
    record = recorded()
    traced = [f for f in run.frames if f.traced]
    me = threading.get_ident()
    own = sorted((s for s in record or () if s[1] == me), key=lambda s: s[3])
    if not own or not traced:
        return None
    out = []
    for f in traced:
        a, b = int(f.t0 * 1e9) - SLACK_NS, int(f.t1 * 1e9) + SLACK_NS
        out.append((f, [s for s in own if a <= s[3] and s[4] <= b]))
    return out


def ms(spans, names) -> float:
    """Summed milliseconds of the spans named in ``names``."""
    return sum(s[4] - s[3] for s in spans if s[0] in names) * 1e-6


def outermost(spans, prefix: str):
    """The spans whose name starts with ``prefix`` and that lie in no other
    such span."""
    out = []
    for s in sorted((s for s in spans if s[0].startswith(prefix)), key=lambda s: (s[3], -s[4])):
        if not out or s[3] >= out[-1][4]:
            out.append(s)
    return out


def median_per_frame(run, names):
    """The median over the traced frames of each frame's summed ms of the
    spans named in ``names``, or None."""
    frames = frames_with_spans(run)
    if frames is None:
        return None
    return statistics.median(ms(sp, names) for _, sp in frames)


def median_per_refresh_frame(run, names):
    """The median over the traced refresh frames (Frame.refreshed) of each
    one's summed ms of the spans named in ``names``, or None."""
    frames = frames_with_spans(run)
    if frames is None:
        return None
    per = [ms(sp, names) for f, sp in frames if f.refreshed]
    return statistics.median(per) if per else None
