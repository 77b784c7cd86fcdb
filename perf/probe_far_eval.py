"""Where the time of the far-plane kernels goes, on one NVIDIA GPU.

    python3 perf/probe_far_eval.py [--parent DIR]

Builds dfanerf_torch/ops/csrc/far_eval.cu once as shipped and once per
schedule probe: a copy of the source with the csrc headers it includes
pasted in place of their includes, changed by text substitution, built with
the shipped nvcc flags into build/probe/, one nvcc per build, all at once.
With --parent, also builds DIR's far_eval.cu as it is (DIR: another
checkout of the repository, e.g. the parent commit unpacked by git
archive), fed the blob layout its own library reports. Needs a CUDA device
and nvcc.

The probes change only the schedule, so every build computes the shipped
values bit for bit (checked):
- ``stagger``: each block's producer starts (blockIdx.x % 16) microseconds
  late. Every block walks the same weight slabs in the same order, so
  without it the 132 blocks may read each slab from L2 at once;
- ``per_chunk``: one block per 128-ray chunk (1,583 blocks at 450x450)
  instead of one per SM striding over the chunks, so every chunk pays the
  bias staging, ring_init and a cold ring.

For each build and kernel (far_head, far_torso, far_joint), on seeded
full-width bf16 weights and the rays of one 450x450 frame: ms of a bare
launch with the blobs staged once (CUDA events over LAUNCHES launches,
medians over rounds that alternate the order of the builds), share of the
operation bound and the L2 weight rate. For the shipped library also ms
through the package's wrappers (ops/far_eval.py), which stage the weight
blobs again at every call, as the renderer calls them.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (bounds, checks and the L2 rate)
from dfanerf_torch.models import Decoder, DecoderConfig  # noqa: E402
from dfanerf_torch.models.layers import init_uniform_  # noqa: E402
from dfanerf_torch.ops import _build  # noqa: E402
from dfanerf_torch.ops.far_eval import (  # noqa: E402
    far_head_kernel, far_joint_kernel, far_torso_kernel,
)
from dfanerf_torch.ops.fused_render import _slot_tables, field_flops_per_sample  # noqa: E402
from dfanerf_torch.ops.fused_render import view_bias  # noqa: E402
from dfanerf_torch.ops.pack import pack_field_weights  # noqa: E402

N = 450 * 450
FAR = 0.9
ROUNDS = 3
LAUNCHES = 20
PROBE_DIR = REPO / "build" / "probe"
PRODUCER = "    if (threadIdx.x == NCONS) {\n"
GRID = "  const int grid = n_chunks < sms ? n_chunks : sms;\n"
PROBES = {
    "shipped": [],
    "stagger": [(PRODUCER, PRODUCER + "      __nanosleep((blockIdx.x % 16) * 1000);\n")],
    "per_chunk": [(GRID, "  const int grid = n_chunks;\n")],
}
_INCLUDE = re.compile(r'^#include "([^"]+)"\n', re.M)
PTR = ctypes.c_void_p
LAUNCHERS = {"far_eval_launch": [ctypes.c_int, PTR, PTR, ctypes.c_float] + [PTR] * 6
             + [ctypes.c_int, ctypes.c_int, PTR],
             "far_joint_launch": [PTR] * 4 + [ctypes.c_float] + [PTR] * 9
             + [ctypes.c_int, ctypes.c_int, PTR]}


def inlined(path: Path, seen=None) -> str:
    """The source at ``path`` with every local #include pasted in, once."""
    seen = set() if seen is None else seen

    def paste(m):
        header = path.parent / m.group(1)
        if header in seen:
            return ""
        seen.add(header)
        return inlined(header, seen)

    return _INCLUDE.sub(paste, path.read_text())


def build_probes(parent=None):
    """Build every probe (and the parent's source), one nvcc each, all at
    once; return name -> .so path."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    shipped = inlined(_build.CSRC / "far_eval.cu")
    sources = {}
    for name, subs in PROBES.items():
        src = shipped
        for old, new in subs:
            if src.count(old) != 1:
                raise SystemExit(f"probe substitution matches {src.count(old)} times: {old!r}")
            src = src.replace(old, new)
        sources[name] = src
    if parent is not None:
        sources["parent"] = inlined(Path(parent) / "dfanerf_torch/ops/csrc/far_eval.cu")
    procs = {}
    for name, src in sources.items():
        tag = hashlib.sha256((src + " ".join(_build.NVCC_FLAGS)).encode()).hexdigest()[:16]
        cu, so = PROBE_DIR / f"far_eval-{tag}.cu", PROBE_DIR / f"libfar_eval-{tag}.so"
        cu.write_text(src)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"probe build {name!r} failed:\n{log}")
    return {name: so for name, (so, _) in procs.items()}


class Build:
    """Bare launches of one build's three kernels, the blobs staged once
    in the layout the library reports."""

    def __init__(self, path: Path, ops):
        self.lib, layout = _build.load(path, "far_eval", LAUNCHERS)
        self.ops = ops
        self.blobs = {}
        for i, br in enumerate(("head", "torso")):
            w, b = _build.weight_blobs(ops["pw"][br], br)
            if w.numel() != layout[2 * i]:
                w = _build.ring_blob(w, br)
            self.blobs[br] = (w, b)
        self.stream = torch.cuda.current_stream().cuda_stream
        self.sh = torch.empty((N, 1), dtype=torch.float32, device="cuda")
        self.ct = torch.empty((N, 3), dtype=torch.float32, device="cuda")

    def _check(self, err):
        if err != 0:
            raise SystemExit(f"probe_far_eval: launch failed with cudaError {err}")

    def run(self, kernel):
        """Launch; the outputs are the build's own buffers, overwritten by its
        next launch."""
        o = self.ops
        freq, phase = _slot_tables(o["o"].device)
        sh, ct = self.sh, self.ct
        p = [x.data_ptr() for x in (o["o"], o["d"], o["vr"], freq, phase)]
        (wh, bh), (wt, bt) = ((w.data_ptr(), b.data_ptr()) for w, b in self.blobs.values())
        if kernel == "far_joint":
            self._check(self.lib.far_joint_launch(p[0], p[1], p[0], p[1], FAR, p[2], p[3], p[4],
                                                  wh, bh, wt, bt, sh.data_ptr(), ct.data_ptr(),
                                                  N, 0, self.stream))
            return sh, ct
        torso = kernel == "far_torso"
        out = ct if torso else sh
        self._check(self.lib.far_eval_launch(int(torso), p[0], p[1], FAR, p[2] if torso else None,
                                             p[3], p[4], wt if torso else wh, bt if torso else bh,
                                             out.data_ptr(), N, 0, self.stream))
        return out


def operands():
    g = torch.Generator().manual_seed(2)
    dec = init_uniform_(Decoder(DecoderConfig()), g).cuda()
    vecs = [torch.randn(k, generator=g).cuda() for k in (96, 42, 256, 256)]
    pw = {br: pack_field_weights(dec, vecs[i], vecs[2], vecs[3], br)
          for i, br in ((0, "head"), (1, "torso"))}
    o = (torch.randn(N, 3, generator=g) * 0.05).cuda()
    d = (torch.randn(N, 3, generator=g) * 0.2 + torch.tensor([0.0, 0.0, -1.0])).cuda()
    return {"pw": pw, "o": o, "d": d, "vr": view_bias(pw["torso"], d).to(torch.bfloat16)}


def wrapper_run(ops, kernel):
    pw, o, d, vr = ops["pw"], ops["o"], ops["d"], ops["vr"]
    if kernel == "far_head":
        return far_head_kernel(pw["head"], o, d, FAR)
    if kernel == "far_torso":
        return far_torso_kernel(pw["torso"], o, d, FAR, vr)
    return far_joint_kernel(pw["head"], pw["torso"], o, d, o, d, FAR, vr)


def time_ms(fn) -> float:
    fn()
    return chip_smoke._cuda_ms(fn, LAUNCHES)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="another checkout whose far_eval.cu is timed beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_far_eval: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    ops = operands()
    builds = {name: Build(path, ops) for name, path in build_probes(args.parent).items()}
    kernels = ("far_head", "far_torso", "far_joint")
    ref = wrapper_run(ops, "far_joint")  # sh, ct of the package's kernels
    for kernel in kernels:
        for name, b in builds.items():
            got = b.run(kernel)
            sh, ct = (got if kernel == "far_joint" else
                      (got, ref[1]) if kernel == "far_head" else (ref[0], got))
            if name == "parent":
                chip_smoke._check_far(f"{kernel}: parent vs shipped", sh, ct, *ref)
                continue
            same = torch.equal(sh, ref[0]) and torch.equal(ct, ref[1])
            print(f"{kernel}: {name} bit-equal to the package's kernel: {same}", flush=True)
            if not same:
                raise SystemExit("probe_far_eval: a build disagrees with the shipped kernel")
    flops = {"far_head": N * field_flops_per_sample("head", color=False),
             "far_torso": N * field_flops_per_sample("torso", sigma=False)}
    flops["far_joint"] = flops["far_head"] + flops["far_torso"]
    order = list(builds)
    for kernel in kernels:
        times = {name: [] for name in builds}
        for r in range(ROUNDS):
            for name in (order if r % 2 == 0 else order[::-1]):
                times[name].append(time_ms(lambda: builds[name].run(kernel)))
        wrapped = time_ms(lambda: wrapper_run(ops, kernel))
        bound = flops[kernel] / chip_smoke.PEAK_BF16_FLOPS * 1e3
        for name, t in times.items():
            ms = statistics.median(t)
            rate = chip_smoke._far_l2_rate(kernel, N, ms) if name != "parent" else float("nan")
            print(f"{kernel} {name}: {ms:.4f} ms (rounds {', '.join(f'{x:.4f}' for x in t)}); "
                  f"{bound / ms:.1%} of the {bound:.4f} ms bound; L2 weight rate {rate:.3f} TB/s",
                  flush=True)
        print(f"{kernel} through the wrapper (blobs staged at each call): {wrapped:.4f} ms",
              flush=True)


if __name__ == "__main__":
    main()
