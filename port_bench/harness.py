"""One run of one cell: the cell's configuration, traffic mix and metric
readers are found by the names in BENCHMARK.json (``configs/<file>``,
``traffic/<mix>.json``, ``metrics/<metric>.py``); the mix's ``kind``
(``serve`` or ``train``) drives the program; the result is one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dfanerf_tpu")
TRACE_SECONDS = 4.0  # the profiled part of a traced window


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    model: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path = HERE.parent


def load_cell(root: Path, name: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    model = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "port_bench" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moves = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moves)]
    return Cell(name, int(w["chips"]), model, mix, e2e, per_layer, root)


def load_reader(root: Path, name: str) -> Callable:
    """``read(run)`` of port_bench/metrics/<name>.py under ``root``."""
    path = root / "port_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that a run may not hold, compared whole."""
    return sorted({k.split(".")[0] for k, v in list(sys.modules.items())
                   if v is not None and k.split(".")[0] in FORBIDDEN})


def device_info(device: torch.device, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def metric(cell: Cell, values: Dict[str, float], traced: bool) -> dict:
    """The cell's end-to-end metrics (untraced) or its per-layer metrics that
    found something to read (traced), each with its unit."""
    out = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = values.get(m["name"])
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def checked(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number (each that has a limit) beside its limit, an
    upper bound."""
    return {k: {"value": float(numbers[k]), "limit": limits[k]} for k in limits}


def all_within(checks: Dict[str, dict]) -> bool:
    return bool(checks) and all(c["limit"] is not None and c["value"] <= c["limit"]
                                for c in checks.values())


# ---------------------------------------------------------------- serving

def run_serve(cell: Cell, seed: int, seconds: float, traced: bool, device, t_proc: float,
              size: Optional[dict] = None, program=None) -> dict:
    """One serving run. ``size`` and ``program`` (a Program factory) are the
    tests' small frames and broken programs."""
    from port_bench import serve

    split = {"imports": time.perf_counter() - t_proc}
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    split["cuda_context"] = time.perf_counter() - t_proc - sum(split.values())
    st = serve.prepare(cell.model, cell.mix, seed, device, size)
    split["weights_clip_calibration"] = time.perf_counter() - t_proc - sum(split.values())
    prog = (program or serve.Program)(st)
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
    numbers = serve.compare(kept, serve.reference_frames(st, prog_kind, which))

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


# ---------------------------------------------------------------- training

def run_train(cell: Cell, seed: int, seconds: float, traced: bool, device, t_proc: float,
              size: Optional[dict] = None, program=None) -> dict:
    """One training run: set-up drives the state through its first steps,
    the window trains the same state, the reference follows the first steps
    after it."""
    from port_bench import train

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


RUNS = {"serve": run_serve, "train": run_train}


def parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_proc: float) -> int:
    args = parse(argv)
    cell = load_cell(HERE.parent, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    result = RUNS[cell.mix["kind"]](cell, args.seed, args.seconds, bool(args.trace),
                                         torch.device("cuda", 0), t_proc)
    found = forbidden_modules()
    if found:
        print(f"port_bench: the run loaded {found}, which the port may not use", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']:.6g} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
