"""Where the time of the pair field kernels goes, and whether two pairs per
block pay, on one NVIDIA GPU.

    python3 perf/probe_pair_field.py [--parent DIR]

Builds dfanerf_torch/ops/csrc/pair_field.cu once as shipped and once per
timing probe: a copy of the source with the csrc headers it includes
(field_wgmma.cuh, field_common.cuh) pasted in place of their includes,
changed by text substitution, built with the shipped nvcc flags into
build/probe/, one nvcc per build, all at once. Each copy instantiates only
the kernel its mode launches. With --parent, also builds DIR's
pair_field.cu as it is (DIR: another checkout of the repository, e.g. the
parent commit unpacked by git archive), fed the blob layout its own library
reports. Times every build on the main path's operands: the pair lists of
one 450x450 frame at 64 samples (frame 0 of chip_smoke.py's pair path: its
recipe, scene and seeded weights, 8 samples per slab), head then torso, as
one frame runs them, and prints each build's L2 weight rate: the weight
bytes those pairs stream (each field's staged ring slabs and narrow rows
once per 128-row chunk) over the kernel time. Times are CUDA events,
medians over rounds that alternate the order of the builds. Needs a CUDA
device and nvcc.

The modes, the counterparts of the TPU timing probes:
- what each piece of the kernel costs (benchmarks/probe_kernel_parts.py):
  ``shipped`` (also the single-pair schedule below), ``nope`` (the PE
  writes its argument, no sine), ``nowait`` (no weight stream: the producer
  copies nothing and the consumers wait for no stage), ``nowgmma`` (no
  wgmma: the A fragments are loaded and folded, the weights still stream),
  ``noepi`` (the layers' epilogues store nothing, so nothing waits for
  their wgmma chains either) and ``onecol`` (each epilogue stores one
  column: every chain is still waited for, the epilogue work is gone);
- whether two pairs per block pay on this card
  (benchmarks/probe_pair_sched.py): ``single`` is ``shipped`` (one pair per
  block, K blocks); ``cat2`` runs the pair2 kernel at 8 samples per slab
  (the even pairs in A, the odd ones in B, ceil(K/2) blocks, each walking
  A's 16 chunks then B's).

Only ``shipped``, ``parent`` and ``cat2`` compute the kernel's values: the
shipped build must equal the package's pair_field_kernel bit for bit, and
cat2 the shipped one; the parent is held to the shipped build within
chip_smoke.py's pair bars. Every other probe computes wrong values on
purpose; only their times are read, as with the TPU probes, whose
docstrings warn that such standalone variants need confirming in place.
"""

from __future__ import annotations

import argparse
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
              _sub("    eval_pair<TORSO, 4>(p, t, j, smem, ring);",
                   "    eval_pair<TORSO, 8>(p, t, j, smem, ring);"),
              _sub("ring.produce(p2.a.w, TORSO ? NS_TORSO : NS_HEAD, pairs * 2 * 4);",
                   "ring.produce(p2.a.w, TORSO ? NS_TORSO : NS_HEAD, pairs * 2 * 8);"),
              _sub("  if (sp != 4 || (n_b", "  if (sp != 8 || (n_b")]

NO_SINE = [_sub("      const float pts = o[k] + d[k] * zs;\n"
                "      const float arg = pts * freq[c] + phase[c];\n      v = sinf(arg);",
                "      const float pts = o[k] + d[k] * zs;\n"
                "      const float arg = pts * freq[c] + phase[c];\n      v = arg;")]
NO_RING_WAIT = [
    _sub("    mbar_wait(full(stage), phase);\n    return base + stage * SLAB_BYTES;",
         "    return base + stage * SLAB_BYTES;"),
    _sub("        mbar_wait(empty(stage), phase ^ 1);\n"
         "        bulk_load(base + stage * SLAB_BYTES, w + i * SLAB, SLAB_BYTES, full(stage));\n",
         ""),
]
NO_WGMMA = [_sub(
    "      wgmma_rs(acc, a, desc_b(stage + kk * 256, SBO), 1);",
    "      acc[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ stage) & 0x007fffffu);")]
STORE = "        *dst = v;"
NO_EPILOGUE = [_sub(STORE, "        (void)dst;")]
ONE_COLUMN = [_sub(STORE, "        if (col == 0) " + STORE.strip())]

# mode -> (substitutions, launched as pair2)
MODES = {
    "shipped": (SINGLE_ONLY, False),
    "nope": (SINGLE_ONLY + NO_SINE, False),
    "nowait": (SINGLE_ONLY + NO_RING_WAIT, False),
    "nowgmma": (SINGLE_ONLY + NO_WGMMA, False),
    "noepi": (SINGLE_ONLY + NO_EPILOGUE, False),
    "onecol": (SINGLE_ONLY + ONE_COLUMN, False),
    "cat2": (PAIR2_AT_8, True),
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
    src = inlined(_build.CSRC / "pair_field.cu")
    for old, new, count in subs:
        if src.count(old) != count:
            raise SystemExit(f"probe substitution matches {src.count(old)} times, not {count}: "
                             f"{old!r}")
        src = src.replace(old, new)
    return src


def build_probes(parent=None):
    """Build every mode (and the parent's shipped source), one nvcc each, all
    at once; return name -> .so path."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    sources = {name: patched_source(subs) for name, (subs, _) in MODES.items()}
    if parent is not None:
        sources["parent"] = inlined(Path(parent) / "dfanerf_torch/ops/csrc/pair_field.cu")
    procs = {}
    for name, src in sources.items():
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
            if "registers" in line or "spill" in line or "wgmma" in line:
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
        if "parent" in kernels:
            chip_smoke._check_buffers(f"{op['branch']}: parent build vs shipped",
                                      kernels["parent"].run(op), got, m)


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


def weight_bytes_per_chunk(branch: str) -> int:
    """Weight bytes one 128-row chunk of the field streams from L2: its
    staged blob (ring slabs and narrow rows), bf16."""
    return _build.staged_weight_bytes(branch)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="another checkout whose pair_field.cu is timed beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_pair_field: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    paths = build_probes(args.parent)
    kernels = {name: (ProbePair2 if name in MODES and MODES[name][1] else ProbePair)(path)
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
    streamed = sum(op["t"].numel() * 2 * SP * weight_bytes_per_chunk(op["branch"]) for op in ops)
    rates = {name: streamed / (ms * 1e-3) / 1e12 for name, ms in medians.items()}
    base = medians["shipped"]
    plain_ms = sum(chip_smoke._cuda_call(lambda: pair_field_eval_reference(
        op["pw"], op["branch"], op["o"], op["d"], op["vr"], op["z"], op["t"], op["j"], op["act"],
        SP))[1] for op in ops)
    print(f"operands: head {ops[0]['t'].numel()} and torso {ops[1]['t'].numel()} listed pairs of "
          f"{SP} samples on {ops[0]['k_u']} tiles; {flops / 1e12:.3f} TFLOP at live widths -> "
          f"{flops / chip_smoke.PEAK_BF16_FLOPS * 1e3:.3f} ms at bf16 peak; "
          f"{streamed / 1e9:.2f} GB of weights streamed; the plain version "
          f"(pair_field_eval_reference, one call per field) {plain_ms:.1f} ms", flush=True)
    for name, t in times.items():
        print(f"{name}: median {medians[name]:.3f} ms per frame's pairs "
              f"({medians[name] - base:+.3f} ms against shipped), L2 weight rate "
              f"{rates[name]:.3f} TB/s; runs {', '.join(f'{x:.3f}' for x in t)}", flush=True)
    print(json.dumps({"card": smi, "ms": medians, "plain_ms": plain_ms,
                      "bound_ms": flops / chip_smoke.PEAK_BF16_FLOPS * 1e3,
                      "l2_weight_tb_s": rates}), flush=True)


if __name__ == "__main__":
    main()
