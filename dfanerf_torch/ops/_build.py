"""Build the port's CUDA kernels with nvcc into plain-C shared libraries.

Each ``csrc/<name>.cu`` becomes ``build/kernels/lib<name>-<digest>.so`` at the
repository root, where the digest covers the source, every ``csrc`` header it
includes (``#include "x.cuh"``, followed through headers) and the flags, so an
edited source or header is rebuilt and a stale library is never loaded. Sources build
in parallel, one nvcc process each. The wrappers load the libraries with
ctypes through ``Binding``, which also lays out a field's weights for the
kernels (``weight_blobs``, re-laid into the weight ring's slabs of the wgmma
core, csrc/field_wgmma.cuh, by ``ring_blob``) and launches them; nothing is
built when a module is imported. Spans: ``kernel.build`` (an nvcc run),
``kernel.load``, ``kernel.blobs`` and ``kernel.<binding>`` around each
binding's call; every build and load of the process is also kept in
``LOADS``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Sequence, Tuple

import torch

from dfanerf_torch.spans import span

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("render_rays", "pair_field", "far_eval", "sigma_head", "render_head", "pair_hier",
           "pair_perz", "node_grid")
LAYOUT_SIZES = 5  # ints a library's <name>_layout writes: weight and bias blob sizes, smem
# --fmad=false: the kernels mirror their plain versions' float32 rounding
# (see the note in csrc/render_rays.cu); -Xptxas -v reports registers, shared
# memory and spills into the build log; --split-compile=0 compiles a
# source's kernels concurrently on every core, which halves the build of the
# sources with six instantiations (render_rays, pair_field) and leaves their
# SASS as it was without it.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v", "--split-compile=0",
)


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return found


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def local_includes(path: Path) -> List[Path]:
    """The headers of ``path``'s directory that it includes, directly or
    through other such headers, in first-include order."""
    seen: List[Path] = []
    todo = [path]
    while todo:
        for name in _INCLUDE.findall(todo.pop(0).read_text()):
            header = path.parent / name
            if header.exists() and header not in seen:
                seen.append(header)
                todo.append(header)
    return seen


def library_path(name: str, csrc: Path = CSRC) -> Path:
    source = csrc / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes())
    for header in local_includes(source):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def load(path: Path, name: str,
         launchers: Dict[str, Sequence]) -> Tuple[ctypes.CDLL, Tuple[int, ...]]:
    """Load the library of kernel source ``name`` from ``path``; type its
    launch functions (``launchers``: function name -> ctypes argtypes, each
    returning a cudaError_t as int) and read its ``<name>_layout`` sizes."""
    lib = ctypes.CDLL(str(path))
    layout = getattr(lib, f"{name}_layout")
    layout.argtypes = [ctypes.POINTER(ctypes.c_int)]
    layout.restype = ctypes.c_int
    for fn, argtypes in launchers.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    sizes = (ctypes.c_int * LAYOUT_SIZES)()
    layout(sizes)
    return lib, tuple(sizes)


# Every kernel.build and kernel.load of the process, recorded or not:
# (name, t0 ns, t1 ns) on time.perf_counter_ns's clock. Each library is built
# at most once and loaded once a binding, so the list stays short.
LOADS: List[Tuple[str, int, int]] = []


@contextmanager
def _logged(name: str) -> Iterator[None]:
    """``span(name)``, its interval also kept in LOADS."""
    t0 = time.perf_counter_ns()
    with span(name):
        yield
    LOADS.append((name, t0, time.perf_counter_ns()))


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Build the named kernels that are not built yet; return their paths.

    Raises RuntimeError with nvcc's output if a build fails."""
    paths = {name: library_path(name) for name in names}
    todo = {name: path for name, path in paths.items() if not path.exists()}
    if not todo:
        return paths
    with _logged("kernel.build"):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        compiler = nvcc()
        procs = {}
        for name, path in todo.items():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True), tmp)
        failed = []
        for name, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            todo[name].with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, todo[name])
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def weight_blobs(pw: Dict[str, torch.Tensor], branch: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flatten one field's packed operands into the kernels' blobs: bf16
    matrices stored [out][in], fp32 biases (layout in csrc/field_common.cuh,
    shared by every kernel of the port)."""
    k_in = 64 if branch == "head" else 128
    shapes = {
        "w_in": (k_in, 256), "w_blocks": (7, 256, 256), "w_skip": (k_in, 256),
        "w_sf": (256, 384), "w_out": (256, 128),
    }
    if branch == "torso":
        shapes.update({"d_w1": (64, 128), "d_wk": (4, 128, 128), "d_wskip": (64, 128),
                       "d_wout": (128, 128)})
    for key, shape in shapes.items():
        w = pw[key]
        if w.dtype != torch.bfloat16 or tuple(w.shape) != shape:
            raise ValueError(
                f"{branch} {key}: the CUDA kernel takes bf16 {shape}, got "
                f"{w.dtype} {tuple(w.shape)} (pack with param_dtype=torch.bfloat16)")

    def t(w):
        return w.transpose(-1, -2).reshape(-1)

    mats = [t(pw["w_in"]), t(pw["w_blocks"]), t(pw["w_skip"]), t(pw["w_sf"]),
            t(pw["w_out"][:, :8])]
    biases = [pw["b_in"], pw["b_blocks"].reshape(-1), pw["b_skip"], pw["b_sf"], pw["b_out"][:8]]
    if branch == "torso":
        mats += [t(pw["d_w1"]), t(pw["d_wk"]), t(pw["d_wskip"]), t(pw["d_wout"])]
        biases += [pw["d_b1"], pw["d_bk"].reshape(-1), pw["d_bskip"], pw["d_bout"], pw["sig_pad"]]
    return (torch.cat(mats).contiguous(),
            torch.cat([b.to(torch.float32) for b in biases]).contiguous())


# The wgmma core's weight ring (csrc/field_wgmma.cuh): a stage holds SLAB
# bf16 values, one k-slab of a layer's [out][in] matrix, [256][32] or
# [128][64].
SLAB = 8192
HID, DEF, PEW = 256, 128, 64


def _blob_offsets(k_in: int) -> Dict[str, int]:
    """Element offsets of a field's matrices in its ``weight_blobs`` blob
    (csrc/field_common.cuh WOff, and the torso's deform net after them)."""
    o = {"in": 0, "blk": HID * k_in}
    o["skip"] = o["blk"] + 7 * HID * HID
    o["sf"] = o["skip"] + HID * k_in
    o["out"] = o["sf"] + 384 * HID
    o["end"] = o["out"] + 8 * HID
    o["d_w1"] = o["end"]
    o["d_wk"] = o["d_w1"] + DEF * PEW
    o["d_wskip"] = o["d_wk"] + 4 * DEF * DEF
    o["d_wout"] = o["d_wskip"] + DEF * PEW
    o["torso_end"] = o["d_wout"] + DEF * DEF
    return o


def ring_layers(branch: str) -> List[Tuple[int, int, int]]:
    """(offset into the ``weight_blobs`` blob, N out, K in) of each matrix a
    128-row chunk of the field streams through the ring, in the order its
    layers consume them: the torso's deform net (d_w1, d_wk 0-2, d_wskip,
    d_wk 3, d_wout), then the trunk (input layer, blocks 0-3, skip, blocks
    4-6, the view-feature rows 128:384 of w_sf)."""
    k_in = PEW if branch == "head" else DEF
    o = _blob_offsets(k_in)
    layers = []
    if branch == "torso":
        wk = [(o["d_wk"] + i * DEF * DEF, DEF, DEF) for i in range(4)]
        layers += [(o["d_w1"], DEF, PEW), *wk[:3], (o["d_wskip"], DEF, PEW), wk[3],
                   (o["d_wout"], DEF, DEF)]
    blocks = [(o["blk"] + i * HID * HID, HID, HID) for i in range(7)]
    layers += [(o["in"], HID, k_in), *blocks[:4], (o["skip"], HID, k_in), *blocks[4:],
               (o["sf"] + 128 * HID, HID, HID)]
    return layers


def stage_matrix(w: torch.Tensor) -> torch.Tensor:
    """One [N][K] matrix as K / KS ring slabs of depth KS = SLAB / N, each in
    wgmma's no-swizzle K-major canonical layout: value (n, k) of slab k // KS
    at ((n // 8) * KS / 8 + (k % KS) // 8) * 64 + (n % 8) * 8 + k % 8."""
    n, k = w.shape
    ks = SLAB // n
    return (w.reshape(n // 8, 8, k // ks, ks // 8, 8).permute(2, 0, 3, 1, 4).reshape(-1))


def staged_weight_bytes(branch: str, color: bool = True) -> int:
    """Bytes of a field's staged weight blob (``ring_blob``) that one 128-row
    chunk of the field streams from L2 in the wgmma core: the whole blob; with
    ``color=False``, what a density-only chunk (sigma_head, pair_sigma)
    streams: the trunk's slabs, without the view feature's, and the sigma
    rows."""
    layers = ring_layers(branch) if color else ring_layers(branch)[:-1]
    return 2 * (sum(n * k for _, n, k in layers) + (2 if color else 1) * 8 * HID)


def ring_blob(w: torch.Tensor, branch: str) -> torch.Tensor:
    """The wgmma core's staged weight blob of a field from its
    ``weight_blobs`` blob ``w``: the ring slabs of ``ring_layers`` in order,
    then the sigma rows 0:8 of w_sf and the rgb rows 0:8 of w_out, [8][256]
    each (read by the narrow mma.sync heads straight from L2)."""
    o = _blob_offsets(PEW if branch == "head" else DEF)
    parts = [stage_matrix(w[off:off + n * k].reshape(n, k)) for off, n, k in ring_layers(branch)]
    parts += [w[o["sf"]:o["sf"] + 8 * HID], w[o["out"]:o["out"] + 8 * HID]]
    return torch.cat(parts).contiguous()


def check_cuda_operands(name: str, operands: Dict[str, Tuple]) -> torch.device:
    """The CUDA device of a kernel's operands (name -> (tensor, shape,
    dtype)); raises unless each lies on it, contiguous, with that shape and
    dtype."""
    dev = next(iter(operands.values()))[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    for key, (x, shape, dtype) in operands.items():
        if (x.device != dev or tuple(x.shape) != tuple(shape) or x.dtype != dtype
                or not x.is_contiguous()):
            raise ValueError(f"{name} {key}: expected contiguous {dtype} {tuple(shape)} on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    return dev


_WORKER = threading.local()


@contextmanager
def worker_launches() -> Iterator[None]:
    """Within this block, launches made by this thread count in each
    binding's ``worker_launches`` instead of ``launches``: the async refresh
    worker's launches, kept apart from the served frames'."""
    _WORKER.on = True
    try:
        yield
    finally:
        _WORKER.on = False


class Binding:
    """ctypes binding of kernel library ``name``, built and loaded at its
    first use (never at import), under a lock, so two threads never build or
    load it twice. ``launches`` counts the launches of the kernel the
    subclass wraps, and ``variant_launches`` those of each template
    instantiation a launch names; a launch inside ``worker_launches()``
    counts in ``worker_launches`` instead. ``launch`` raises them
    where the kernel is launched, under the same lock, and nothing else
    does. A subclass's call runs inside the span ``kernel.<binding>``, the
    subclass's name in snake case less "Kernel" (RenderRaysKernel:
    ``kernel.render_rays``)."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        call = cls.__dict__.get("__call__")
        if call is None:
            return
        name = "kernel." + re.sub(r"(?<!^)(?=[A-Z])", "_",
                                  cls.__name__.removesuffix("Kernel")).lower()

        @functools.wraps(call)
        def traced(self, *args, **kw):
            with span(name):
                return call(self, *args, **kw)

        cls.__call__ = traced

    def __init__(self, name: str, launchers: Dict[str, Sequence]):
        self.name = name
        self.launches = 0
        self.variant_launches: Dict[str, int] = {}
        self.worker_launches = 0
        self._launchers = launchers
        self._lib = None
        self._layout = None
        self._lock = threading.Lock()

    def _library(self) -> Path:
        """Path of the built shared library (built on first use)."""
        return build([self.name])[self.name]

    def _load(self) -> ctypes.CDLL:
        if self._lib is None:
            with self._lock:
                if self._lib is None:
                    path = self._library()
                    with _logged("kernel.load"):
                        lib, self._layout = load(path, self.name, self._launchers)
                    self._lib = lib
        return self._lib

    def _count_launch(self, variant: str = None) -> None:
        """Count one launch of this thread (see the class docstring)."""
        with self._lock:
            if getattr(_WORKER, "on", False):
                self.worker_launches += 1
                return
            self.launches += 1
            if variant is not None:
                self.variant_launches[variant] = self.variant_launches.get(variant, 0) + 1

    def blobs(self, pw: Dict[str, torch.Tensor], branch: str,
              dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """One field's staged weight blob (``weight_blobs`` re-laid by
        ``ring_blob``) and bias blob, checked against the sizes the library
        reports (its ``<name>_layout``: head weight, head bias, torso weight,
        torso bias)."""
        self._load()
        with span("kernel.blobs"):
            w, b = weight_blobs(pw, branch)
            w = ring_blob(w, branch)
        sizes = self._layout[2:4] if branch == "torso" else self._layout[0:2]
        for blob, size in zip((w, b), sizes):
            if blob.numel() != size or blob.device != dev:
                raise ValueError(f"weight blob of {blob.numel()} on {blob.device}, kernel expects "
                                 f"{size} on {dev}")
        return w, b

    def launch(self, fn: str, dev: torch.device, *args, variant: str = None) -> None:
        """Call the library's launch function ``fn`` on the current stream of
        ``dev``: tensors pass as their data pointers, other arguments as
        they are, the stream last. Raises on a nonzero cudaError; counts the
        launch, and under ``variant`` when one is named."""
        lib = self._load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn)(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args],
                               stream)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch {fn} failed with cudaError {err}")
        self._count_launch(variant)
