"""One run of one cell: the cell's configuration, traffic mix and metric
readers are found by the names in BENCHMARK.json (``configs/<file>``,
``traffic/<mix>.json``, ``metrics/<metric>.py``); the mix's ``kind`` names
the run's shape (``kinds/<kind>.py``, such as ``serve`` or ``train``),
whose ``run`` drives the program; the result is one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

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


def load_named(root: Path, folder: str, name: str) -> ModuleType:
    """The module port_bench/<folder>/<name>.py under ``root``, loaded from its
    file; stops, naming the file it looked for, where there is none."""
    path = root / "port_bench" / folder / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"port_bench: no {folder[:-1]} {name!r}: looked for {path}")
    key = f"port_bench_{folder}_{name.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod  # dataclasses and pickling look a class's module up by name
    spec.loader.exec_module(mod)
    return mod


def load_reader(root: Path, name: str) -> Callable:
    """``read(run)`` of port_bench/metrics/<name>.py under ``root``."""
    return load_named(root, "metrics", name).read


def load_kind(cell: Cell) -> ModuleType:
    """The run kind of the cell's mix, port_bench/kinds/<kind>.py under the
    cell's root: its ``run(cell, seed, seconds, traced, device, t_proc,
    size=None, program=None)`` makes one run and returns its result line."""
    return load_named(cell.root, "kinds", cell.mix["kind"])


def run(cell: Cell, seed: int, seconds: float, traced: bool, device, t_proc: float,
        size: Optional[dict] = None, program=None) -> dict:
    """One run of the cell by its kind. ``size`` and ``program`` (a program
    factory) are the tests' small sizes and broken programs."""
    return load_kind(cell).run(cell, seed, seconds, traced, device, t_proc, size, program)


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
    kind = load_kind(cell)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    result = kind.run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                      t_proc)
    found = forbidden_modules()
    if found:
        print(f"port_bench: the run loaded {found}, which the port may not use", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']:.6g} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
