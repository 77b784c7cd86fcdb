"""Run kind ``serve``: one client in a closed loop over the seeded clip,
through the cell's serving path (``paths/<path>.py``, which the mix names or
its render flags select: ``serve.resolve_path``). Set-up makes the weights,
the clip and the path's program and renders the warm frames; the window
serves frames back to back; after it, the kept frames are compared with the
path's plain reference frames."""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from port_bench import serve
from port_bench.harness import (TRACE_SECONDS, Cell, all_within, checked, device_info,
                                load_reader, metric)


def run(cell: Cell, seed: int, seconds: float, traced: bool, device, t_proc: float,
        size: Optional[dict] = None, program=None) -> dict:
    """One serving run. ``size`` and ``program`` (a Program factory) are the
    tests' small frames and broken programs."""
    path = serve.resolve_path(cell)
    split = {"imports": time.perf_counter() - t_proc}
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    split["cuda_context"] = time.perf_counter() - t_proc - sum(split.values())
    st = path.prepare(cell.model, cell.mix, seed, device, size)
    split["weights_clip_calibration"] = time.perf_counter() - t_proc - sum(split.values())
    prog = (program or path.Program)(st)
    warm = int((size or {}).get("warm_frames", cell.mix["warm_frames"]))
    c_ref = serve.warm_up(prog, warm)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    split["renderer_and_warm_frames"] = time.perf_counter() - t_proc - sum(split.values())
    setup_s = time.perf_counter() - t_proc

    t_start = time.perf_counter()
    frames, kept, prof = serve.run_window(prog, warm, seconds, traced,
                                          min(TRACE_SECONDS, seconds / 3), seed,
                                          int(cell.mix["check"]["frames"]), c_ref)
    t_end = frames[-1].t2
    dev_info = device_info(device, cell.chips)
    swaps = getattr(prog.render, "cache", {}).get("swaps")
    tr = prof.reduce(*serve.host_spans(frames)) if prof is not None else None
    if tr is not None:
        dev_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
    which = [(frames[j].c, frames[j].c_ref) for j in sorted(kept)]
    kept = [kept[j] for j in sorted(kept)]
    prog_kind = prog.kind
    prog.close()
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = serve.compare(kept, path.reference_frames(st, which))

    values = {"setup_s": setup_s,
              "fps": len(frames) / (t_end - t_start),
              "frame_ms_p95": float(np.percentile([f.ms for f in frames], 95))}
    if traced:
        run = SimpleNamespace(frames=frames, trace=tr, kind=prog_kind, cell=cell,
                              t_start=t_start, t_end=t_end, swaps=swaps)
        values = {m["name"]: load_reader(cell.root, m["name"])(run) for m in cell.per_layer}
    checks = checked(numbers, cell.mix["check"]["limits"])
    result = {"correct": all_within(checks), "attempted": len(frames), "failed": 0,
              "metrics": metric(cell, values, traced), "device": dev_info}
    if tr is not None:
        result["breakdown"] = tr.breakdown()
    result.update(setup_split=split, swaps=swaps, calibration=st.calibration,
                  refreshes=sum(f.refreshed for f in frames), readings=numbers,
                  checks=checks)
    return result
