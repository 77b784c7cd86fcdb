"""Run kind ``train``: training steps back to back on a seeded synthetic
identity. Set-up drives the one state the window trains through its first
steps; the plain reference follows those steps after the window."""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace
from typing import Optional

import torch

from port_bench import train
from port_bench.harness import (TRACE_SECONDS, Cell, all_within, checked, device_info,
                                load_reader, metric)


def run(cell: Cell, seed: int, seconds: float, traced: bool, device, t_proc: float,
        size: Optional[dict] = None, program=None) -> dict:
    """One training run. ``size`` and ``program`` (a TrainProgram factory)
    are the tests' small sizes and broken steps."""
    split = {"imports": time.perf_counter() - t_proc}
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    split["cuda_context"] = time.perf_counter() - t_proc - sum(split.values())
    ts = train.prepare(cell.model, cell.mix, seed, device, size)
    split["weights_identity"] = time.perf_counter() - t_proc - sum(split.values())
    prog = (program or train.TrainProgram)(ts)
    feed = train.Batches(ts, seed)
    batches, got = train.program_side(prog, feed, ts)
    for _ in range(int((size or {}).get("warm_steps", cell.mix["warm_steps"]))):
        prog.run(feed())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    split["step_and_warm_steps"] = time.perf_counter() - t_proc - sum(split.values())
    setup_s = time.perf_counter() - t_proc

    t_start = time.perf_counter()
    steps, t_end, (prof, tw) = train.run_window(prog, feed, seconds, traced,
                                                 min(TRACE_SECONDS, seconds / 3),
                                                 int(cell.model["train"]["i_print"]))
    dev_info = device_info(device, cell.chips)
    tr = None
    if prof is not None:
        spans = [("train.step", a, b) for a, b, on in steps if on]
        tr = prof.reduce(spans, *tw)
        dev_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
    prog.close()
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = train.check_numbers(train.reference_side(ts, batches), got)

    values = {"setup_s": setup_s, "train_rays_per_s": len(steps) * ts.n_rand / (t_end - t_start)}
    if traced:
        run = SimpleNamespace(steps=steps, trace=tr, cell=cell, n_rand=ts.n_rand,
                              n_samples=ts.model["render"]["n_samples"])
        values = {m["name"]: load_reader(cell.root, m["name"])(run) for m in cell.per_layer}
    checks = checked(numbers, cell.mix["check"]["limits"])
    result = {"correct": all_within(checks), "attempted": len(steps), "failed": 0,
              "metrics": metric(cell, values, traced), "device": dev_info}
    if tr is not None:
        result["breakdown"] = tr.breakdown()
    result.update(setup_split=split, losses=got[0], readings=numbers, checks=checks)
    return result
