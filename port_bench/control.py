"""Readings that the limits of ``correct`` are set from, for one cell over
many seeds in one process. For each seed, the program's numbers against the
plain reference and the control's: the plain reference in float8 e4m3
products, one precision below the configuration's bf16, put in the
program's place. Serving: a short window at the cell's own load, the frames
picked as a run picks them. Training: the first three steps; besides the
control, the fault of half the batch left out (the reference put in the
program's place on the first half of each batch's rows) and, as a second
witness, the program's own float32 path. One JSON line per seed:

    python3 port_bench/control.py --workload <cell> --seeds 1 2 3 --seconds 3 [--control-seeds 3]
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from port_bench import harness, serve, train  # noqa: E402


def readings(cell, seed: int, seconds: float, device, size=None, control: bool = True) -> dict:
    """{"program": numbers, "control": numbers or None} of one seed, on the
    cell's serving path."""
    path = serve.resolve_path(cell)
    st = path.prepare(cell.model, cell.mix, seed, device, size)
    prog = path.Program(st)
    warm = int((size or {}).get("warm_frames", cell.mix["warm_frames"]))
    c_ref = serve.warm_up(prog, warm)
    frames, kept, _ = serve.run_window(prog, warm, seconds, False, 0.0, seed,
                                       int(cell.mix["check"]["frames"]), c_ref)
    which = [(frames[j].c, frames[j].c_ref) for j in sorted(kept)]
    kept = [kept[j] for j in sorted(kept)]
    prog.close()
    del prog
    gc.collect()
    refs = path.reference_frames(st, which)
    out = {"seed": seed, "frames": len(frames), "program": serve.compare(kept, refs),
           "control": None}
    if control:
        low = path.reference_frames(st, which, prec="fp8")
        out["control"] = serve.compare([x[0] for x in low], refs)
    return out


def train_readings(cell, seed: int, device, size=None, control: bool = True) -> dict:
    """The training cell's numbers of one seed: program, control, half-batch
    fault and the program's float32 path, each against the reference."""
    ts = train.prepare(cell.model, cell.mix, seed, device, size)
    prog = train.TrainProgram(ts)
    batches, got = train.program_side(prog, train.Batches(ts, seed), ts)
    prog.close()
    ref = train.reference_side(ts, batches)
    out = {"seed": seed, "program": train.check_numbers(ref, got)}
    f32 = train.TrainSetup(**dict(ts.__dict__, model=dict(
        ts.model, render=dict(ts.model["render"], compute_dtype="float32"))))
    prog = train.TrainProgram(f32)
    _, got32 = train.program_side(prog, train.Batches(f32, seed), f32)
    prog.close()
    out["program_float32"] = train.check_numbers(ref, got32)
    if control:
        out["control"] = train.check_numbers(ref, train.reference_side(ts, batches, "fp8"))
        out["half_batch"] = train.check_numbers(
            ref, train.reference_side(ts, batches, rows=ts.n_rand // 2))
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control-seeds", type=int, default=3,
                   help="the first this many seeds also read the control")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    for k, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        if cell.mix["kind"] == "train":
            r = train_readings(cell, seed, torch.device("cuda", 0), control=k < args.control_seeds)
        else:
            r = readings(cell, seed, args.seconds, torch.device("cuda", 0),
                         control=k < args.control_seeds)
        r["s"] = time.perf_counter() - t0
        print(json.dumps(dict(r, workload=args.workload)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
