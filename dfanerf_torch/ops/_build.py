"""Build the port's CUDA kernels with nvcc into plain-C shared libraries.

Each ``csrc/<name>.cu`` becomes ``build/kernels/lib<name>-<digest>.so`` at the
repository root, where the digest covers the source, every ``csrc`` header it
includes (``#include "x.cuh"``, followed through headers) and the flags, so an
edited source or header is rebuilt and a stale library is never loaded. Sources build
in parallel, one nvcc process each. The wrappers load the libraries with
ctypes; nothing is built when a module is imported.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("render_rays", "pair_field", "far_eval")
# --fmad=false: the kernels mirror their plain versions' float32 rounding
# (see the note in csrc/render_rays.cu); -Xptxas -v reports registers, shared
# memory and spills into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
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


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Build the named kernels that are not built yet; return their paths.

    Raises RuntimeError with nvcc's output if a build fails."""
    paths = {name: library_path(name) for name in names}
    todo = {name: path for name, path in paths.items() if not path.exists()}
    if not todo:
        return paths
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
