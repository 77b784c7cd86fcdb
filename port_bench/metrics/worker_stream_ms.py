"""Refresh worker: device time on streams other than the serving thread's
(the worker's own CUDA stream) per served frame of the traced window.
Moves frame_ms_p95."""


def read(run):
    tr = run.trace
    frames = [f for f in run.frames if f.traced]
    if tr is None or tr.serving_stream is None or not frames:
        return None
    other = sum(min(e, tr.end) - max(s, tr.start) for _, s, e, st in tr.ops
                if st != tr.serving_stream and e > tr.start and s < tr.end) * 1e-9
    if other <= 0:
        return None
    return other * 1e3 / len(frames)
