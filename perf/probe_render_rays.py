"""Where the time of the render_rays kernel goes, on one NVIDIA GPU.

    python3 perf/probe_render_rays.py [--parent DIR]

Builds dfanerf_torch/ops/csrc/render_rays.cu once as shipped and once per
timing probe: a copy of the source, with the csrc headers it includes
(field_wgmma.cuh, field_common.cuh) pasted in place of their includes, and
with one kind of work removed by text substitution (PROBES below; "no
epilogue" also lets the compiler stop waiting for each layer's wgmma chain,
"epilogue of one column" keeps that wait and drops the epilogue's work), built
with the shipped nvcc flags into build/probe/. With --parent, also builds
DIR's render_rays.cu as it is (DIR: another checkout of the repository,
e.g. the parent commit unpacked by git archive) and times it beside the
others, fed the blob layout its library reports. Times every build on the main path's operands: one
450x450 frame of the synthetic scene, 64 samples, both fields, bf16, with
seeded random weights, as chip_smoke.py renders it. The probes compute
wrong colours on purpose; only their times are read. Also times the
shipped kernel on one wave of tiles (one tile per SM) to show the cost of
the last, partly filled wave. For each build it prints the L2 weight rate:
the weight bytes a frame streams (both fields' ring slabs and narrow rows
once per 128-row chunk, as the mma.sync kernel also reads them) over the
kernel time. Times are CUDA events, medians over rounds that alternate the
order of the builds. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import dfanerf_torch.render.renderer as renderer  # noqa: E402
from dfanerf_torch.config import ExperimentConfig, RenderConfig  # noqa: E402
from dfanerf_torch.data.synthetic import make_synthetic_scene  # noqa: E402
from dfanerf_torch.ops import _build  # noqa: E402
from dfanerf_torch.ops.fused_render import (  # noqa: E402
    R_T, S_SLAB, RenderRaysKernel, prepare_render_operands,
)
from dfanerf_torch.train.state import init_train_state  # noqa: E402

H = W = 450
N_SAMPLES = 64
ROUNDS = 4
LAUNCHES = 2
PROBE_DIR = REPO / "build" / "probe"

# (old, new) substitutions; each old text must occur exactly once.
NO_RING_WAIT = [  # no weight stream: the producer copies nothing, consumers wait for nothing
    ("    mbar_wait(full(stage), phase);\n    return base + stage * SLAB_BYTES;",
     "    return base + stage * SLAB_BYTES;"),
    ("        mbar_wait(empty(stage), phase ^ 1);\n"
     "        bulk_load(base + stage * SLAB_BYTES, w + i * SLAB, SLAB_BYTES, full(stage));\n", ""),
]
NO_WGMMA = [(  # wgmma dropped; one XOR fold per A fragment keeps its ldmatrix live
    "      wgmma_rs(acc, a, desc_b(stage + kk * 256, SBO), 1);",
    "      acc[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ stage) & 0x007fffffu);",
)]
STORE = "        *dst = v;"
# no layer stores: bias, relu, rounding and stores gone
NO_EPILOGUE = [(STORE, "        (void)dst;")]
# one column stored: every wgmma chain still waited for
ONE_COLUMN = [(STORE, "        if (col == 0) " + STORE.strip())]
# the PE writes its argument (wg_encode only: wg_encode_perz reads z[row])
NO_SINE = [("      const float pts = o[k] + d[k] * zs;\n"
            "      const float arg = pts * freq[c] + phase[c];\n      v = sinf(arg);",
            "      const float pts = o[k] + d[k] * zs;\n"
            "      const float arg = pts * freq[c] + phase[c];\n      v = arg;")]
PROBES = {
    "shipped": [],
    "no ring wait": NO_RING_WAIT,
    "no wgmma": NO_WGMMA,
    "neither ring wait nor wgmma": NO_RING_WAIT + NO_WGMMA,
    "no epilogue": NO_EPILOGUE,
    "epilogue of one column": ONE_COLUMN,
    "no PE sine": NO_SINE,
}
_INCLUDE = re.compile(r'^#include "([^"]+)"\n', re.M)


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


def patched_source(subs) -> str:
    src = inlined(_build.CSRC / "render_rays.cu")
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"probe substitution matches {src.count(old)} times: {old!r}")
        src = src.replace(old, new)
    return src


def build_probes(parent=None):
    """Build every probe (and the parent's shipped source), one nvcc each, all
    at once; return name -> .so path."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    sources = {name: patched_source(subs) for name, subs in PROBES.items()}
    if parent is not None:
        sources["parent"] = inlined(Path(parent) / "dfanerf_torch/ops/csrc/render_rays.cu")
    procs = {}
    for name, src in sources.items():
        tag = hashlib.sha256((src + " ".join(_build.NVCC_FLAGS)).encode()).hexdigest()[:16]
        cu, so = PROBE_DIR / f"render_rays-{tag}.cu", PROBE_DIR / f"librender_rays-{tag}.so"
        cu.write_text(src)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"probe build {name!r} failed:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "wgmma" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)
    return {name: so for name, (so, _) in procs.items()}


class ProbeKernel(RenderRaysKernel):
    """The shipped wrapper over a probe build's library."""

    def __init__(self, path: Path):
        super().__init__()
        self._path = path

    def _library(self):
        return self._path


def main_path_operands():
    """The kernel operands of frame 0 of chip_smoke.py's main path."""
    cfg = ExperimentConfig(render=RenderConfig(
        n_samples=N_SAMPLES, concate_bg=True, compute_dtype="bfloat16", use_fused_kernel=True,
        spatial_tiles=True))
    scene = make_synthetic_scene(n_frames=8, H=H, W=W, seed=0)
    state = init_train_state(cfg, seed=0, device="cuda")
    auds, exps, poses = (torch.from_numpy(x).cuda() for x in (scene.auds, scene.exps, scene.poses))
    sig, sig_t = renderer.encode_frame_signals(state["params"], auds, exps, poses, 0,
                                               scene.n_frames, cfg, True)
    captured = {}
    real = renderer.fused_render_rays

    def capture(*args, **kw):
        captured["ops"] = prepare_render_operands(*args, **kw)
        n = args[2].shape[0]
        return args[2].new_zeros((n, 3)), args[2].new_zeros((n, 3))

    renderer.fused_render_rays = capture
    try:
        render = renderer.make_frame_renderer(cfg, scene.hwfcxy, scene.near, scene.far)
        render(state["params"], state["z_shape"], state["z_app"], poses[0], poses[0], sig, sig_t,
               torch.from_numpy(scene.bc_img).cuda())
    finally:
        renderer.fused_render_rays = real
    return captured["ops"]


def first_tiles(ops, tiles: int):
    """The operands of the first ``tiles`` ray tiles."""
    n = tiles * R_T
    per_ray = {k: getattr(ops, k)[:n] for k in
               ("rays_o", "rays_d", "rays_o_t", "rays_d_t", "vr_h", "vr_t", "bc")}
    return dataclasses.replace(ops, **per_ray, dists_h=ops.dists_h[:, :n].contiguous(),
                               dists_t=ops.dists_t[:, :n].contiguous(), occ=ops.occ[:tiles])


def time_ms(kernel, ops) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LAUNCHES):
        kernel(ops)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / LAUNCHES


def weight_bytes_per_chunk() -> int:
    """Weight bytes one 128-row chunk of both fields streams from L2: the
    staged blobs (ring slabs and narrow rows), bf16."""
    return sum(_build.staged_weight_bytes(branch) for branch in ("head", "torso"))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="another checkout whose render_rays.cu is timed beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_render_rays: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    kernels = {name: ProbeKernel(path) for name, path in build_probes(args.parent).items()}
    ops = main_path_operands()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = {name: (k, ops) for name, k in kernels.items()}
    cases[f"shipped, first {sms} tiles (one wave)"] = (kernels["shipped"], first_tiles(ops, sms))
    times = {name: [] for name in cases}
    for name, (k, o) in cases.items():
        _, _, slabs = k(o)  # warm-up
        torch.cuda.synchronize()
        if int(slabs.sum()) != o.n_tiles * o.n_slabs:
            raise SystemExit(f"{name}: {int(slabs.sum())} of {o.n_tiles * o.n_slabs} slabs ran")
    order = list(cases)
    for r in range(ROUNDS):
        for name in (order if r % 2 == 0 else order[::-1]):
            times[name].append(time_ms(*cases[name]))
    medians = {name: statistics.median(t) for name, t in times.items()}
    per_chunk = weight_bytes_per_chunk()
    streamed = {name: o.n_tiles * o.n_slabs * 2 * S_SLAB * per_chunk
                for name, (_, o) in cases.items()}
    rates = {name: streamed[name] / (medians[name] * 1e-3) / 1e12 for name in cases}
    print(f"operands: {ops.n_tiles} tiles of {R_T} rays, {ops.n_slabs} slabs, every slab run; "
          f"{sms} SMs, so {-(-ops.n_tiles // sms)} waves of one tile per SM; "
          f"{per_chunk} weight bytes per 128-row chunk, {streamed['shipped'] / 1e9:.2f} GB a frame",
          flush=True)
    for name, t in times.items():
        print(f"{name}: median {medians[name]:.3f} ms per launch, L2 weight rate "
              f"{rates[name]:.3f} TB/s (none streamed where the probe removes the ring's copies); "
              f"runs {', '.join(f'{x:.3f}' for x in t)}", flush=True)
    print(json.dumps({"card": smi, "ms": medians, "l2_weight_tb_s": rates}), flush=True)


if __name__ == "__main__":
    main()
