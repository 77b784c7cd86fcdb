"""Where the time of the pair field kernels goes, and whether two pairs per
block pay, on one NVIDIA GPU.

    python3 perf/probe_pair_field.py

Builds dfanerf_torch/ops/csrc/pair_field.cu once as shipped and once per
timing probe: a copy of the source with its shared field code
(csrc/field_mlp.cuh) pasted in place of the include, changed by text
substitution (and, for the interleaved modes, probe kernels added), built
with the shipped nvcc flags into build/probe/, one nvcc per build, all at
once. Each copy instantiates only the kernel its mode launches. Times every
build on the main path's operands: the pair lists of one 450x450 frame at
64 samples (frame 0 of chip_smoke.py's pair path: its recipe, scene and
seeded weights, 8 samples per slab), head then torso, as one frame runs
them. Times are CUDA events, medians over rounds that alternate the order
of the builds. Needs a CUDA device and nvcc.

The modes, the counterparts of the TPU timing probes:
- what each piece of the kernel costs (benchmarks/probe_kernel_parts.py):
  ``shipped`` (also the single-pair schedule below), ``nope`` (the PE
  writes its argument, no sine), ``nobias`` (no bias anywhere), ``norelu``
  (no relu in the trunk and the deformation net), ``bf16ep`` (the relu
  layers' bias add and relu in packed bf16) and ``norgb`` (no colour head);
- whether two pairs per block pay on this card
  (benchmarks/probe_pair_sched.py): ``single`` is ``shipped`` (one pair per
  block, K blocks); ``cat2`` runs the pair2 kernel at 8 samples per slab
  (the even pairs in A, the odd ones in B, ceil(K/2) blocks, each walking
  A's 16 chunks then B's); ``ilv2`` interleaves the two pairs inside every
  chunk: two chains of 128 rows do not fit the 227 KB of shared memory
  beside each other (the field takes 166 KB for one), so each 128-row
  chunk holds 64 rays of pair A and 64 of pair B at one sample and runs
  through every layer together (32 chunks per block); ``zip2`` is ``ilv2``
  with every layer split into its A and B halves, each half's products
  then its epilogue, so that A's epilogue can overlap B's mma.sync (each
  half loads the layer's weight fragments again); ``ilv2bf`` is ``ilv2``
  with the ``bf16ep`` epilogues.

Only ``shipped`` and ``cat2`` compute the kernel's values: the shipped
build must equal the package's pair_field_kernel bit for bit, and cat2 the
shipped one. Every other probe computes wrong values on purpose (the
interleaved modes read tile A's view bias for B's rows, for instance);
only their times are read, as with the TPU probes, whose docstrings warn
that such standalone variants need confirming in place.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the pair path's recipe, scene and weights)
import dfanerf_torch.render.renderer as renderer  # noqa: E402
from dfanerf_torch.config import ExperimentConfig, RenderConfig  # noqa: E402
from dfanerf_torch.core.rays import linspace  # noqa: E402
from dfanerf_torch.models import DecoderConfig  # noqa: E402
from dfanerf_torch.ops import _build  # noqa: E402
from dfanerf_torch.ops.fused_render import R_T, field_flops_per_sample, view_bias  # noqa: E402
from dfanerf_torch.ops.pair_field import (  # noqa: E402
    Pair2FieldKernel, PairFieldKernel, _empty_buffers, _slot_tables, pair_field_eval_reference,
    pair_field_kernel,
)

ROUNDS = 3
LAUNCHES = 2
SP = 8
PROBE_DIR = REPO / "build" / "probe"


def _sub(old, new, count=1):
    return (old, new, count)


# each kernel copy instantiates only what its mode launches
SP4 = ("  if (sp == 4) kernel = torso ? pair_field_kernel<true, 4> : "
       "pair_field_kernel<false, 4>;\n")
SP8 = ("  if (sp == 8) kernel = torso ? pair_field_kernel<true, 8> : "
       "pair_field_kernel<false, 8>;\n")
PAIR2_LAUNCH = ("  return launch(torso ? pair2_field_kernel<true> : pair2_field_kernel<false>, p2, "
                "n_a, stream);")
SINGLE_ONLY = [_sub(SP4, ""),
               _sub(PAIR2_LAUNCH, "  return static_cast<int>(cudaErrorInvalidValue);")]
PAIR2_AT_8 = [_sub(SP4, ""), _sub(SP8, ""),
              _sub("    eval_pair<TORSO, 4>(p, t, j, smem);",
                   "    eval_pair<TORSO, 8>(p, t, j, smem);"),
              _sub("  if (sp != 4 || (n_b", "  if (sp != 8 || (n_b")]
ILV2_AT_8 = [_sub(SP4, ""), _sub(SP8, ""), _sub("  if (sp != 4 || (n_b", "  if (sp != 8 || (n_b"),
             _sub(PAIR2_LAUNCH, "  return launch(torso ? ilv2_kernel<true> : ilv2_kernel<false>, "
                                "p2, n_a, stream);")]

RELU_EPILOGUE = ("          x0 = fmaxf(x0 + bias[col], 0.f);\n"
                 "          x1 = fmaxf(x1 + bias[col + 1], 0.f);")
NO_SINE = [_sub("      v = sinf(arg);", "      v = arg;")]
NO_BIAS = [
    _sub(RELU_EPILOGUE, "          x0 = fmaxf(x0, 0.f);\n          x1 = fmaxf(x1, 0.f);"),
    _sub("acc[mt][nt][i] = fmaxf(acc[mt][nt][i] + bias[n0 + nt * 8 + q * 2 + (i & 1)], 0.f);",
         "acc[mt][nt][i] = fmaxf(acc[mt][nt][i], 0.f);"),
    _sub("          x0 = x0 + bp[col];\n          x1 = x1 + bp[col + 1];", ""),
    _sub("x0 = fmaxf((x0 + bias[col]) + v.x, 0.f);", "x0 = fmaxf(x0 + v.x, 0.f);"),
    _sub("x1 = fmaxf((x1 + bias[col + 1]) + v.y, 0.f);", "x1 = fmaxf(x1 + v.y, 0.f);"),
    _sub("x0 = ((x0 + bias[col]) + bp[col]) + p0;", "x0 = x0 + p0;"),
    _sub("x1 = ((x1 + bias[col + 1]) + bp[col + 1]) + p1;", "x1 = x1 + p1;"),
    _sub("density_act(d[0] + b[B_SF], softplus)", "density_act(d[0], softplus)"),
    _sub("density_act(d[2] + b[B_SF], softplus)", "density_act(d[2], softplus)"),
    _sub("expf(-(d[e] + b[B_OUT + c]))", "expf(-d[e])"),
    _sub("expf(-(d[2 + e] + b[B_OUT + c]))", "expf(-d[2 + e])"),
]
NO_RELU = [
    _sub(RELU_EPILOGUE, "          x0 = x0 + bias[col];\n          x1 = x1 + bias[col + 1];"),
    _sub("acc[mt][nt][i] = fmaxf(acc[mt][nt][i] + bias[n0 + nt * 8 + q * 2 + (i & 1)], 0.f);",
         "acc[mt][nt][i] = acc[mt][nt][i] + bias[n0 + nt * 8 + q * 2 + (i & 1)];"),
]
BF16_EPILOGUE = [_sub(
    RELU_EPILOGUE,
    "          const __nv_bfloat162 hb = __hmax2(\n"
    "              __hadd2(__floats2bfloat162_rn(x0, x1),\n"
    "                      __floats2bfloat162_rn(bias[col], bias[col + 1])),\n"
    "              __float2bfloat162_rn(0.f));\n"
    "          x0 = __low2float(hb);\n          x1 = __high2float(hb);")]
NO_RGB = [_sub("  color_head<KIN>(h, spare, w, b, vr, ray0, rgb, warp, lane);\n}", "}")]

# zip2: every layer in two 64-row halves, products then epilogue per half
ZIP_LAYERS = [
    _sub("template <int K, int NT>\n"
         "__device__ __forceinline__ void warp_gemm(float (&acc)[8][NT][4],",
         "template <int K, int NT, int MT = 8>\n"
         "__device__ __forceinline__ void warp_gemm(float (&acc)[MT][NT][4],"),
    _sub("    for (int mt = 0; mt < 8; ++mt) {\n      uint32_t a[4];",
         "    for (int mt = 0; mt < MT; ++mt) {\n      uint32_t a[4];"),
    _sub("  float acc[8][NT][4];\n"
         "#pragma unroll\n"
         "  for (int mt = 0; mt < 8; ++mt)\n"
         "#pragma unroll\n"
         "    for (int nt = 0; nt < NT; ++nt)\n"
         "#pragma unroll\n"
         "      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;\n"
         "  const int n0 = warp * NT * 8, g = lane >> 2, q = lane & 3;\n"
         "  warp_gemm<K, NT>(acc, A, lda, W, n0, lane);\n"
         "  if (MODE == SKIP) {\n"
         "#pragma unroll\n"
         "    for (int mt = 0; mt < 8; ++mt)",
         "  const int n0 = warp * NT * 8, g = lane >> 2, q = lane & 3;\n"
         "#pragma unroll\n"
         "  for (int half = 0; half < 2; ++half) {\n"
         "  float acc[4][NT][4];\n"
         "#pragma unroll\n"
         "  for (int mt = 0; mt < 4; ++mt)\n"
         "#pragma unroll\n"
         "    for (int nt = 0; nt < NT; ++nt)\n"
         "#pragma unroll\n"
         "      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;\n"
         "  warp_gemm<K, NT, 4>(acc, A + half * 64 * lda, lda, W, n0, lane);\n"
         "  if (MODE == SKIP) {\n"
         "#pragma unroll\n"
         "    for (int mt = 0; mt < 4; ++mt)"),
    _sub("    warp_gemm<KP, NT>(acc, P, LDP, Wp, n0, lane);",
         "    warp_gemm<KP, NT, 4>(acc, P + half * 64 * LDP, LDP, Wp, n0, lane);"),
    _sub("#pragma unroll\n  for (int mt = 0; mt < 8; ++mt) {\n#pragma unroll\n"
         "    for (int nt = 0; nt < NT; ++nt) {\n      const int col = n0 + nt * 8 + q * 2;",
         "#pragma unroll\n  for (int mt = 0; mt < 4; ++mt) {\n#pragma unroll\n"
         "    for (int nt = 0; nt < NT; ++nt) {\n      const int col = n0 + nt * 8 + q * 2;"),
    _sub("        const int row = mt * 16 + g + h * 8;\n        float x0 = acc[mt][nt][2 * h]",
         "        const int row = half * 64 + mt * 16 + g + h * 8;\n"
         "        float x0 = acc[mt][nt][2 * h]"),
    _sub("        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);\n"
         "      }\n    }\n  }\n}\n",
         "        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);\n"
         "      }\n    }\n  }\n  }\n}\n"),
]

# ilv2, zip2, ilv2bf: each 128-row chunk holds 64 rays of pair A (rows
# 0:64) and 64 of pair B (rows 64:128) at one sample
ILV2_KERNEL = r'''
__device__ __forceinline__ void encode2(bf16* P, const float* o, const float* d, float za,
                                        float zb, const float* freq, const float* phase,
                                        int ray_a, int ray_b, int tid) {
  for (int idx = tid; idx < M * PEW; idx += NTHR) {
    const int row = idx >> 6, c = idx & (PEW - 1);
    float v = 0.f;
    if (c < 60) {
      const bool in_b = row >= 64;
      const int k = ((in_b ? ray_b - 64 : ray_a) + row) * 3 + c % 3;
      v = sinf((o[k] + d[k] * (in_b ? zb : za)) * freq[c] + phase[c]);
    }
    P[row * LDP + c] = __float2bfloat16_rn(v);
  }
}

template <bool TORSO>
__global__ void __launch_bounds__(NTHR, 1) ilv2_kernel(const Params2 p2) {
  const Params& p = p2.a;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem + SM_X);
  bf16* Y = reinterpret_cast<bf16*>(smem + SM_Y);
  bf16* P = reinterpret_cast<bf16*>(smem + SM_P);
  float* sig = reinterpret_cast<float*>(smem + SM_SIG);
  float* rgb = reinterpret_cast<float*>(smem + SM_RGB);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, k = blockIdx.x;
  const bool has_b = k < p2.n_b;
  const int ta = p.t_idx[k], ja = p.j_idx[k];
  const int tb = has_b ? p2.tb_idx[k] : ta, jb = has_b ? p2.jb_idx[k] : ja;
#pragma unroll 1
  for (int c = 0; c < 4 * 8; ++c) {
    const int s = c >> 2, q = c & 3;
    const int ray_a = ta * RT + q * 64, ray_b = tb * RT + q * 64;
    encode2(P, p.o, p.d, p.z[ja * 8 + s], p.z[jb * 8 + s], p.freq, p.phase, ray_a, ray_b, tid);
    __syncthreads();
    const int ray_v = ta * RT + (q >> 1) * M;  // view bias rows of tile A only
    if constexpr (TORSO) {
      deform(X, Y, P, p.w, p.b, warp, lane);
      trunk_and_heads<DEF>(X, Y, P, p.w, p.b, p.vr, ray_v, p.softplus, sig, rgb, warp, lane);
    } else {
      trunk_and_heads<PEW>(X, Y, P, p.w, p.b, p.vr, ray_v, p.softplus, sig, rgb, warp, lane);
    }
    __syncthreads();
    if (tid < 64 || (tid < M && has_b)) {
      const bool in_b = tid >= 64;
      const int o = ((in_b ? jb : ja) * 8 + s) * p.row_stride + (in_b ? ray_b - 64 : ray_a) + tid;
      (in_b ? p2.sig_b : p.sig)[o] = sig[tid];
      (in_b ? p2.r_b : p.r)[o] = __float2bfloat16_rn(rgb[tid * 3]);
      (in_b ? p2.g_b : p.g)[o] = __float2bfloat16_rn(rgb[tid * 3 + 1]);
      (in_b ? p2.bl_b : p.bl)[o] = __float2bfloat16_rn(rgb[tid * 3 + 2]);
    }
  }
}

'''

# mode -> (substitutions, probe kernels added, launched as pair2)
MODES = {
    "shipped": (SINGLE_ONLY, "", False),
    "nope": (SINGLE_ONLY + NO_SINE, "", False),
    "nobias": (SINGLE_ONLY + NO_BIAS, "", False),
    "norelu": (SINGLE_ONLY + NO_RELU, "", False),
    "bf16ep": (SINGLE_ONLY + BF16_EPILOGUE, "", False),
    "norgb": (SINGLE_ONLY + NO_RGB, "", False),
    "cat2": (PAIR2_AT_8, "", True),
    "ilv2": (ILV2_AT_8, ILV2_KERNEL, True),
    "zip2": (ILV2_AT_8 + ZIP_LAYERS, ILV2_KERNEL, True),
    "ilv2bf": (ILV2_AT_8 + BF16_EPILOGUE, ILV2_KERNEL, True),
}


def patched_source(subs, added: str) -> str:
    src = (_build.CSRC / "pair_field.cu").read_text()
    include = '#include "field_mlp.cuh"'
    if src.count(include) != 1:
        raise SystemExit(f"pair_field.cu includes field_mlp.cuh {src.count(include)} times")
    src = src.replace(include, (_build.CSRC / "field_mlp.cuh").read_text())
    for old, new, count in subs:
        if src.count(old) != count:
            raise SystemExit(f"probe substitution matches {src.count(old)} times, not {count}: "
                             f"{old!r}")
        src = src.replace(old, new)
    anchor = "template <typename P>\nint launch("
    return src.replace(anchor, added + anchor) if added else src


def build_probes():
    """Build every mode, one nvcc each, all at once; return name -> .so path."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (subs, added, _) in MODES.items():
        src = patched_source(subs, added)
        tag = hashlib.sha256((src + " ".join(_build.NVCC_FLAGS)).encode()).hexdigest()[:16]
        cu, so = PROBE_DIR / f"pair_field-{tag}.cu", PROBE_DIR / f"libpair_field-{tag}.so"
        cu.write_text(src)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"probe build {name!r} failed:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)
    return {name: so for name, (so, _) in procs.items()}


class ProbePair(PairFieldKernel):
    """The shipped single-pair wrapper over a probe build's library."""

    def __init__(self, path: Path):
        super().__init__()
        self._path = path

    def _library(self):
        return self._path

    def run(self, op):
        return self(op["pw"], op["branch"], op["o"], op["d"], op["vr"], op["z"], op["t"],
                    op["j"], op["act"], SP)


class ProbePair2(Pair2FieldKernel):
    """The packed-2 launch over a probe build's library at 8 samples per
    slab (the shipped wrapper takes 4 only)."""

    def __init__(self, path: Path):
        super().__init__()
        self._path = path

    def _library(self):
        return self._path

    def run(self, op):
        dev = op["o"].device
        w, b = self.blobs(op["pw"], op["branch"], dev)
        n_rows = op["o"].shape[0] + R_T
        J = op["z"].shape[0] // SP
        bufs_a, bufs_b = (_empty_buffers(J, n_rows, dev, sp=SP) for _ in range(2))
        freq, phase = _slot_tables(dev)
        ta, ja, tb, jb = op["split"]
        self.launch("pair2_field_launch", dev, int(op["branch"] == "torso"), op["o"], op["d"],
                    op["z"], op["vr"], freq, phase, ta, ja, tb, jb, w, b, *bufs_a, *bufs_b,
                    ta.shape[0], tb.shape[0], n_rows, int(op["act"] == "softplus"), SP)
        return bufs_a, bufs_b


def main_path_operands():
    """Both fields' operands at frame 0 of chip_smoke.py's pair path: its
    lists after the refresh, the gathered union tiles' rays, view biases."""
    cfg = ExperimentConfig(decoder=DecoderConfig(density_activation="softplus"),
                           render=RenderConfig(**chip_smoke.PAIR_RENDER))
    scene, args = chip_smoke._pair_scene(cfg)
    render = renderer.make_frame_renderer(cfg, scene.hwfcxy, scene.near, scene.far)
    render(*args(0))
    c = render.cache
    pw_h, pw_t, ro, rd, ro_t, rd_t, _ = render.inputs_fn(*args(0))
    T = ro.shape[0] // R_T

    def gather(x):
        return x.reshape(T, R_T, -1).index_select(0, c["tiles_sel"]).reshape(-1, 3).contiguous()

    z = linspace(scene.near, scene.far, chip_smoke.N_SAMPLES, device="cuda")
    ops = []
    for branch, pw, o, d, (t, j) in (("head", pw_h, ro, rd, c["lists"][0]),
                                     ("torso", pw_t, ro_t, rd_t, c["lists"][1])):
        o, d = gather(o), gather(d)
        ops.append({"branch": branch, "pw": pw, "o": o, "d": d, "t": t, "j": j, "z": z,
                    "vr": view_bias(pw, d).to(torch.bfloat16).contiguous(),
                    "act": cfg.decoder.density_activation, "k_u": len(c["tiles_u"]),
                    "split": tuple(x.contiguous() for x in (t[0::2], j[0::2], t[1::2], j[1::2]))})
    return ops


def listed(op, t, j):
    J = op["z"].shape[0] // SP
    m = torch.zeros((J, SP, op["k_u"] + 1, R_T), dtype=torch.bool, device="cuda")
    m[j.long(), :, t.long(), :] = True
    return m.reshape(J, SP, -1)


def check_values(kernels, ops):
    """The shipped build against the package's kernel, and cat2's quartets
    against the shipped build's, bit for bit on the listed blocks."""
    for op in ops:
        got = kernels["shipped"].run(op)
        want = pair_field_kernel(op["pw"], op["branch"], op["o"], op["d"], op["vr"], op["z"],
                                 op["t"], op["j"], op["act"], SP)
        two = kernels["cat2"].run(op)
        ta, ja, tb, jb = op["split"]
        m = listed(op, op["t"], op["j"])
        same = all(torch.equal(g[m], w[m]) for g, w in zip(got, want))
        cat = all(torch.equal(q[m], w[m]) for quartet, m in ((two[0], listed(op, ta, ja)),
                                                            (two[1], listed(op, tb, jb)))
                  for q, w in zip(quartet, got))
        print(f"{op['branch']}: {op['t'].numel()} pairs of {op['k_u']} tiles; shipped build "
              f"bit-equal to pair_field_kernel {same}; cat2 bit-equal to shipped {cat}",
              flush=True)
        if not (same and cat):
            raise SystemExit("probe_pair_field: a value build disagrees")


def time_ms(kernel, ops) -> float:
    """One frame's pair work (head, then torso), per launch pair."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LAUNCHES):
        for op in ops:
            kernel.run(op)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / LAUNCHES


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_pair_field: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    paths = build_probes()
    kernels = {name: (ProbePair2 if MODES[name][2] else ProbePair)(path)
               for name, path in paths.items()}
    ops = main_path_operands()
    check_values(kernels, ops)
    for k in kernels.values():  # warm-up
        for op in ops:
            k.run(op)
    torch.cuda.synchronize()
    times = {name: [] for name in kernels}
    order = list(kernels)
    for r in range(ROUNDS):
        for name in (order if r % 2 == 0 else order[::-1]):
            times[name].append(time_ms(kernels[name], ops))
    medians = {name: statistics.median(t) for name, t in times.items()}
    flops = sum(op["t"].numel() * SP * R_T * field_flops_per_sample(op["branch"]) for op in ops)
    base = medians["shipped"]
    plain_ms = sum(chip_smoke._cuda_call(lambda: pair_field_eval_reference(
        op["pw"], op["branch"], op["o"], op["d"], op["vr"], op["z"], op["t"], op["j"], op["act"],
        SP))[1] for op in ops)
    print(f"operands: head {ops[0]['t'].numel()} and torso {ops[1]['t'].numel()} listed pairs of "
          f"{SP} samples on {ops[0]['k_u']} tiles; {flops / 1e12:.3f} TFLOP at live widths -> "
          f"{flops / chip_smoke.PEAK_BF16_FLOPS * 1e3:.3f} ms at bf16 peak; the plain version "
          f"(pair_field_eval_reference, one call per field) {plain_ms:.1f} ms", flush=True)
    for name, t in times.items():
        print(f"{name}: median {medians[name]:.3f} ms per frame's pairs "
              f"({medians[name] - base:+.3f} ms against shipped); runs "
              f"{', '.join(f'{x:.3f}' for x in t)}", flush=True)
    print(json.dumps({"card": smi, "ms": medians, "plain_ms": plain_ms,
                      "bound_ms": flops / chip_smoke.PEAK_BF16_FLOPS * 1e3}), flush=True)


if __name__ == "__main__":
    main()
