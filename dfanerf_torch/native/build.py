"""Build and load the port's C++ host extensions (port of
dfanerf_tpu/native/build.py).

``<name>.cpp`` beside this file becomes ``build/native/lib<name>-<digest>.so``
at the repository root, the digest covering the source and the flags, so an
edited source is rebuilt and a stale library is never loaded. The build
runs at the first ``load_library`` call, never at import; a failed build
raises with g++'s output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# no -march=native, so the library runs on any x86-64 host that loads it;
# no contraction into FMAs, so the IoU rounds as numpy's does
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
_LOADED = {}
_LOCK = threading.Lock()


def library_path(name: str) -> Path:
    digest = hashlib.sha256((SRC_DIR / f"{name}.cpp").read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``<name>.cpp`` if its library is not built yet, then load it."""
    with _LOCK:
        if name in _LOADED:
            return _LOADED[name]
        path = library_path(name)
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            out = subprocess.run(["g++", *CXX_FLAGS, str(SRC_DIR / f"{name}.cpp"), "-o", str(tmp)],
                                 capture_output=True, text=True)
            if out.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed to build {name}.cpp:\n{out.stdout}{out.stderr}")
            os.replace(tmp, path)
        _LOADED[name] = ctypes.CDLL(str(path))
        return _LOADED[name]
