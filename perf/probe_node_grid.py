"""The occupancy node-grid kernel against its plain versions, on one NVIDIA GPU.

    python3 perf/probe_node_grid.py [--grid-res 48] [--rounds 5]

Builds dfanerf_torch/ops/csrc/node_grid.cu (ops/_build.py) and prints its
ptxas lines and each kernel's HGMMA count. Then, on seeded full-width bf16
weights of both fields (the torso with its deformation net) and a node grid
spanning a box about the size of the serving cells' (lo, span fixed below),
at ``--grid-res`` and at grid_res - 2 (at 48: 92^3 nodes, a ragged last
chunk of 64):

- the kernel's densities against ``node_grid_rows`` (the kernel's own
  semantics in plain PyTorch, float32 sums of the bf16 products, TF32 off)
  and against ``node_density_reference`` (the eager z-group loop the serving
  renderers ran before the kernel): the largest difference of each;
- ms a field: the kernel through its binding (which re-lays the weight
  blobs at every call, as the renderers call it), the bare launch (blobs
  staged once) and the eager loop, by CUDA events, medians over
  ``--rounds`` rounds that alternate their order; the operation bound at
  the bf16 peak (``field_flops_per_sample(branch, color=False)`` a node)
  and the kernel's share of it, bare.

Exits 1 if the kernel holds no HGMMA, or a density differs from the
kernel's semantics by more than SEMANTICS_TOL or from the eager loop by more
than chip_smoke.NODE_TOL. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (peak, SASS reader, NODE_TOL)
from dfanerf_torch.core.rays import linspace  # noqa: E402
from dfanerf_torch.models import Decoder, DecoderConfig  # noqa: E402
from dfanerf_torch.models.layers import init_uniform_  # noqa: E402
from dfanerf_torch.ops import _build, occupancy  # noqa: E402
from dfanerf_torch.ops.fused_render import _slot_tables, field_flops_per_sample  # noqa: E402
from dfanerf_torch.ops.pack import pack_field_weights  # noqa: E402

LO = (-0.35, -0.4, -0.55)
SPAN = (0.7, 0.75, 0.9)
# the kernel against its own semantics: the same bf16 rounding points, so
# only the float32 sum order of a product and a rare flipped bf16 rounding
# after it separate them
SEMANTICS_TOL = 1e-3
REPS = 3


def _fields(dev):
    g = torch.Generator().manual_seed(1)
    dec = init_uniform_(Decoder(DecoderConfig()), g).to(dev)
    vecs = [torch.randn(n, generator=g).to(dev) for n in (96, 42, 256, 256)]
    return {"head": pack_field_weights(dec, vecs[0], vecs[2], vecs[3], "head"),
            "torso": pack_field_weights(dec, vecs[1], vecs[2], vecs[3], "torso")}


def _ms(fn):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def _build_report() -> bool:
    _build.build(["node_grid"])
    path = _build.library_path("node_grid")
    log = path.with_suffix(".log")
    for line in (log.read_text().splitlines() if log.exists() else []):
        if any(w in line for w in ("registers", "spill", "stack", "serializ")):
            print(f"[build] node_grid: {line.strip()}", flush=True)
    tool = chip_smoke._cuobjdump()
    if tool is None:
        print("[build] no cuobjdump: SASS not read", flush=True)
        return True
    ok = True
    for fn, (hgmma, hmma) in chip_smoke._sass_counts(tool, path).items():
        print(f"[build] node_grid: {fn}: {hgmma} HGMMA, {hmma} HMMA", flush=True)
        ok &= hgmma > 0
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--grid-res", type=int, default=48)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    ok = _build_report()
    dev = torch.device("cuda", torch.cuda.current_device())
    fields = _fields(dev)
    lo, span = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (LO, SPAN))
    for grid_res in (args.grid_res, args.grid_res - 2):
        gf = grid_res * occupancy.SUPERSAMPLE
        nodes = torch.arange(gf ** 3, device=dev)
        for branch, pw in fields.items():
            for act in ("relu", "softplus"):
                got = occupancy.node_grid_kernel(pw, branch, lo, span, grid_res, act)
                sem = occupancy.node_grid_rows(pw, branch, lo, span, grid_res, nodes, act)
                ref = occupancy.node_density_reference(pw, branch, lo, span, grid_res, act)
                torch.cuda.synchronize()
                d_sem = float((got.reshape(-1) - sem).abs().max())
                d_ref = float((got - ref).abs().max())
                print(f"[check] grid {grid_res} ({gf}^3 = {gf ** 3} nodes, "
                      f"{gf ** 3 % 128} in the last chunk) {branch} {act}: kernel vs its "
                      f"semantics max {d_sem:.3e}, vs the eager loop max {d_ref:.3e} (density "
                      f"range {float(ref.min()):.4f} .. {float(ref.max()):.4f})", flush=True)
                if not (d_sem < SEMANTICS_TOL and d_ref < chip_smoke.NODE_TOL):
                    ok = False
        if grid_res != args.grid_res:
            continue
        k = occupancy.node_grid_kernel
        g = linspace(0.0, 1.0, gf, device=dev)
        freq, phase = _slot_tables(dev)
        out = torch.empty((gf, gf, gf), device=dev)
        for branch, pw in fields.items():
            w, b = k.blobs(pw, branch, dev)
            times = {"kernel": [], "bare": [], "eager": []}
            calls = {"kernel": lambda: k(pw, branch, lo, span, grid_res),
                     "bare": lambda: k.launch("node_grid_launch", dev, int(branch == "torso"), g,
                                              lo, span, freq, phase, w, b, out, gf, 0),
                     "eager": lambda: occupancy.node_density_reference(pw, branch, lo, span,
                                                                       grid_res)}
            for r in range(args.rounds):
                for name in (("kernel", "bare", "eager") if r % 2 == 0
                             else ("eager", "bare", "kernel")):
                    times[name].append(_ms(calls[name]))
            if not torch.equal(out, k(pw, branch, lo, span, grid_res)):
                ok = False
                print(f"[time] {branch}: the bare launch's densities differ", flush=True)
            bound = gf ** 3 * field_flops_per_sample(branch, color=False) \
                / chip_smoke.PEAK_BF16_FLOPS * 1e3
            med = {name: statistics.median(v) for name, v in times.items()}
            print(f"[time] grid {grid_res} {branch}: " + "; ".join(
                f"{name} {med[name]:.3f} ms ({', '.join(f'{t:.3f}' for t in times[name])})"
                for name in times) + f"; bound {bound:.3f} ms at bf16 peak, share bare "
                f"{bound / med['bare']:.1%}, wrapped {bound / med['kernel']:.1%}; eager / "
                f"wrapped {med['eager'] / med['kernel']:.1f}x", flush=True)
    print(f"[probe] {'ok' if ok else 'FAILED'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
