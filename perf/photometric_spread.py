"""How far the photometric refinement's 50 steps move when only rounding
changes, on the CPU.

    python3 perf/photometric_spread.py [--runs K] [--card] [--short-only]

chip_smoke.py phase_tracking_tools holds the card's 50-step
refine_photometric against the CPU's. The objective is discontinuous (a
pixel's validity, splat weight > 1e-4, and its bilinear cells flip as the
points move) and Adam's steps have a fixed size wherever a gradient is near
zero, so 50 chained steps amplify a rounding difference far past the first
step's. This script measures that amplification on the CPU alone, on
chip_smoke's setup (_photometric_setup at PHOTO_LR), between runs that
differ only in rounding: thread counts 4, 1, 2 and 8 (another float32
summation order, the kind of difference the card has from the CPU), and
the first of them with the target images multiplied by 1 + 1e-6 * N(0, 1)
(seeds 1..K).

First it runs 1..SHORT steps at each thread count and on two perturbed
image sets and prints, after each count, the largest distance from the
4-thread run over max(1, the value's scale): how many steps stay together
(chip_smoke.py's PHOTO_TIGHT_STEPS).
Then PHOTO_STEPS steps: for each refined parameter (tex, light, euler,
trans) each run's largest distance from the 4-thread run, and the final
loss's relative distance; last, one JSON line of the largest of each over
all runs (chip_smoke.py's PHOTO_SPREAD).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the refinement's setup and its step count)
from dfanerf_torch.pipeline.photometric import refine_photometric  # noqa: E402

PARAMS = ("tex", "light", "euler", "trans")
THREADS = (4, 1, 2, 8)
SHORT = 8


def _dist(x, ref):
    """Largest distance of x from ref over max(1, ref's largest magnitude)."""
    return float((x - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--card", action="store_true",
                    help="also run the short chains on the CUDA card, from the same inputs")
    ap.add_argument("--short-only", action="store_true",
                    help=f"only the chains of 1..{SHORT} steps")
    a = ap.parse_args()
    on, _, _ = chip_smoke._photometric_setup("cpu")
    args = on("cpu")

    def refine(threads, run_args, n):
        torch.set_num_threads(threads)
        return refine_photometric(*run_args, n_iters=n, lr=chip_smoke.PHOTO_LR)

    def perturbed(seed):
        g = torch.Generator().manual_seed(seed)
        return args[:-1] + (args[-1] * (1 + 1e-6 * torch.randn(args[-1].shape, generator=g)),)

    short = {"threads": [(n, args) for n in THREADS[1:]],
             "images": [(4, perturbed(seed)) for seed in (1, 2)]}
    if a.card:
        short["card"] = [(4, on("cuda"))]
    for n in range(1, SHORT + 1):
        first = refine(4, args, n)
        far = {group: {k: float(f"{max(_dist(o[k].cpu(), first[k]) for o in outs):.3g}")
                       for k in PARAMS + ("loss",)}
               for group, outs in ((g, [refine(t, r, n) for t, r in v]) for g, v in short.items())}
        print(f"[spread] {n} steps: largest distance from the 4-thread run over max(1, its "
              f"scale), other thread counts, images x (1 + 1e-6 N) (seeds 1, 2)"
              f"{', the card' if a.card else ''}: {json.dumps(far)}", flush=True)
    if a.short_only:
        return 0
    t = time.time()
    base = refine(4, args, chip_smoke.PHOTO_STEPS)
    print(f"[spread] 4 threads, images as set up: loss {float(base['loss']):.6g} "
          f"({time.time() - t:.1f} s)", flush=True)
    runs = [(f"{n} threads", n, args) for n in THREADS[1:]]
    runs += [(f"images x (1 + 1e-6 N), seed {seed}", 4, perturbed(seed))
             for seed in range(1, a.runs + 1)]
    worst = dict.fromkeys(PARAMS + ("loss",), 0.0)
    for label, threads, run_args in runs:
        t = time.time()
        out = refine(threads, run_args, chip_smoke.PHOTO_STEPS)
        d = {k: float((out[k] - base[k]).abs().max()) for k in PARAMS}
        d["loss"] = abs(float(out["loss"]) / float(base["loss"]) - 1)
        worst = {k: max(worst[k], d[k]) for k in worst}
        print(f"[spread] {label}: loss {float(out['loss']):.6g}; apart from the first run by "
              f"{json.dumps({k: float(f'{v:.4g}') for k, v in d.items()})} "
              f"({time.time() - t:.1f} s)", flush=True)
    print(json.dumps({"largest": {k: float(f"{v:.4g}") for k, v in worst.items()},
                      "runs": len(runs), "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
