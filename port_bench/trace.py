"""The traced run's reading of the device: a ``torch.profiler`` window (CUDA
activity only, CUPTI) over part of the measured window, reduced in memory
to the device's operations (name, start, end, stream), the benchmark's own
host spans around its calls into the program (moved onto the trace's clock
by a marker kernel launched on an idle device), the device's busy time, and
the breakdown the result line carries. Nothing is written to disk.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import List, Optional, Tuple

import torch


def kernel_base(name: str) -> str:
    """A device operation's function name without return type, namespaces,
    template arguments and parameters: 'void (anonymous
    namespace)::pair_field_kernel<8>(Params)' -> 'pair_field_kernel'."""
    if name.startswith(("Memcpy", "Memset")):
        return " ".join(name.split()[:2])
    head = re.split(r"[<(]", name.replace("(anonymous namespace)::", ""), maxsplit=1)[0]
    head = head.strip().split(" ")[-1] if head.strip() else name
    return head.split("::")[-1]


@dataclasses.dataclass
class Trace:
    ops: List[Tuple[str, int, int, int]]      # device operations: name, start ns, end ns, stream
    spans: List[Tuple[str, int, int]]         # the benchmark's spans: name, start ns, end ns
    start: int                                # the traced window, ns
    end: int
    serving_stream: Optional[int] = None      # the stream of the serving thread's work

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-9

    def busy_intervals(self, stream: Optional[int] = None):
        """The union of device-operation intervals inside the window, sorted."""
        iv = sorted((max(s, self.start), min(e, self.end)) for _, s, e, st in self.ops
                    if e > self.start and s < self.end and (stream is None or st == stream))
        merged: List[List[int]] = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernel_seconds(self, base: str, stream: Optional[int] = None) -> float:
        """Summed time of the device operations named ``base`` in the window."""
        return sum(min(e, self.end) - max(s, self.start) for n, s, e, st in self.ops
                   if kernel_base(n) == base and e > self.start and s < self.end
                   and (stream is None or st == stream)) * 1e-9

    def breakdown(self) -> dict:
        """The 10 device operations that took most time, and the 10 longest
        idle gaps, each named by the innermost span the host was in."""
        by_name = {}
        for n, s, e, _ in self.ops:
            if e > self.start and s < self.end:
                k = kernel_base(n)
                by_name[k] = by_name.get(k, 0.0) + (min(e, self.end) - max(s, self.start)) * 1e-9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        busy = self.busy_intervals()
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        named = []
        for s, e in gaps:
            mid = (s + e) // 2
            inside = [sp for sp in self.spans if sp[1] <= mid < sp[2]]
            host = min(inside, key=lambda sp: sp[2] - sp[1])[0] if inside else "host"
            named.append([host, (e - s) * 1e-9])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}


def _ns(evt, which: str) -> int:
    if hasattr(evt, f"{which}_ns"):
        return int(getattr(evt, f"{which}_ns")())
    if which == "start":
        return int(evt.start_us() * 1000)
    return int((evt.start_us() + evt.duration_us()) * 1000)


class Profiler:
    """A profiler window over the device. ``start`` launches a marker kernel on
    the idle device right after reading the host clock: its start on the
    trace's clock, less that reading, moves host times onto the trace, and
    its stream is the serving thread's."""

    def __init__(self):
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.t_mark = 0

    def start(self):
        self.prof.start()
        torch.cuda.synchronize()
        self.t_mark = time.perf_counter_ns()
        torch.cuda._sleep(1000)

    def stop_window(self):
        torch.cuda.synchronize()
        self.prof.stop()

    def reduce(self, spans: List[Tuple[str, float, float]], t0: float, t1: float) -> Trace:
        """The window [t0, t1] (host perf_counter seconds) as a Trace, with
        the host spans (name, start s, end s) on the trace's clock."""
        ops = []
        for evt in self.prof.profiler.kineto_results.events():
            if evt.device_type() == torch.autograd.DeviceType.CUDA:
                ops.append((evt.name(), _ns(evt, "start"), _ns(evt, "end"),
                            int(evt.device_resource_id())))
        marker = [op for op in ops if "sleep" in op[0] or "spin" in op[0]]
        if not marker:
            raise RuntimeError("the trace holds no marker kernel: CUPTI saw no device activity")
        mark = min(marker, key=lambda op: op[1])
        offset = mark[1] - self.t_mark

        def on_trace(t: float) -> int:
            return int(round(t * 1e9)) + offset

        return Trace(ops=[op for op in ops if op not in marker],
                     spans=[(n, on_trace(a), on_trace(b)) for n, a, b in spans],
                     start=on_trace(t0), end=on_trace(t1), serving_stream=mark[3])
