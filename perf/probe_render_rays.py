"""Where the time of the render_rays kernel goes, on one NVIDIA GPU.

    python3 perf/probe_render_rays.py

Builds dfanerf_torch/ops/csrc/render_rays.cu once as shipped and once per
timing probe: a copy of the source, with its shared field code
(csrc/field_mlp.cuh) pasted in place of the include, and with one kind of
work removed by text substitution (PROBES below), built with the shipped
nvcc flags into build/probe/. Times every build on the main path's operands: one 450x450
frame of the synthetic scene, 64 samples, both fields, bf16, with seeded
random weights, as chip_smoke.py renders it. The probes compute wrong
colours on purpose; only their times are read. Also times the shipped kernel
on one wave of tiles (one tile per SM) to show the cost of the last, partly
filled wave. Times are CUDA events, medians over rounds that alternate the
order of the builds. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
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
    R_T, RenderRaysKernel, prepare_render_operands,
)
from dfanerf_torch.train.state import init_train_state  # noqa: E402

H = W = 450
N_SAMPLES = 64
ROUNDS = 4
LAUNCHES = 2
PROBE_DIR = REPO / "build" / "probe"

# (old, new) substitutions; each old text must occur exactly once.
NO_WEIGHT_LOADS = [(  # B fragments read zeros from registers instead of L2
    "  return __ldg(reinterpret_cast<const unsigned int*>(p));",
    "  return 0u;",
)]
NO_PRODUCTS = [  # mma.sync dropped; one XOR fold per operand keeps its loads live
    ("  uint32_t b[2][NT][2];\n", "  uint32_t b[2][NT][2];\n  uint32_t fold = 0u;\n"),
    ("#pragma unroll\n"
     "      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, b[cur][nt][0], b[cur][nt][1]);\n"
     "    }\n"
     "  }\n",
     "      fold ^= a[0] ^ a[1] ^ a[2] ^ a[3];\n"
     "    }\n"
     "#pragma unroll\n"
     "    for (int nt = 0; nt < NT; ++nt) fold ^= b[cur][nt][0] ^ b[cur][nt][1];\n"
     "  }\n"
     "  acc[0][0][0] += __uint_as_float(fold & 0x007fffffu);\n"),
    ("    mma_bf16(d, a, b0, b1);",
     "    d[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1) & 0x007fffffu);"),
]
NO_SINE = [("      v = sinf(arg);", "      v = arg;")]  # the PE writes its argument
PROBES = {
    "shipped": [],
    "no weight loads": NO_WEIGHT_LOADS,
    "no tensor-core products": NO_PRODUCTS,
    "neither weight loads nor products": NO_WEIGHT_LOADS + NO_PRODUCTS,
    "no PE sine": NO_SINE,
}


def patched_source(subs) -> str:
    src = (_build.CSRC / "render_rays.cu").read_text()
    include = '#include "field_mlp.cuh"'
    if src.count(include) != 1:
        raise SystemExit(f"render_rays.cu includes field_mlp.cuh {src.count(include)} times")
    src = src.replace(include, (_build.CSRC / "field_mlp.cuh").read_text())
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"probe substitution matches {src.count(old)} times: {old!r}")
        src = src.replace(old, new)
    return src


def build_probes():
    """Build every probe, one nvcc each, all at once; return name -> .so path."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in PROBES.items():
        src = patched_source(subs)
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_render_rays: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    kernels = {name: ProbeKernel(path) for name, path in build_probes().items()}
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
    print(f"operands: {ops.n_tiles} tiles of {R_T} rays, {ops.n_slabs} slabs, every slab run; "
          f"{sms} SMs, so {-(-ops.n_tiles // sms)} waves of one tile per SM", flush=True)
    for name, t in times.items():
        print(f"{name}: median {medians[name]:.3f} ms per launch; runs "
              f"{', '.join(f'{x:.3f}' for x in t)}", flush=True)
    print(json.dumps({"card": smi, "ms": medians}), flush=True)


if __name__ == "__main__":
    main()
