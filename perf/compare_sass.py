"""Compare the SASS of every kernel of this checkout with a parent checkout's.

    python3 perf/compare_sass.py --parent DIR

(GPU machine only: needs nvcc and cuobjdump.) Builds the kernel libraries of
this checkout (ops/_build.py, into build/kernels/ as chip_smoke.py does) and
those of the checkout at DIR (its dfanerf_torch/ops/csrc, with this
checkout's flags, into build/sass_parent/), disassembles both with
`cuobjdump -sass` and compares each kernel function, matched by name across
libraries, instruction by instruction (addresses, encodings and the
anonymous namespace's per-file hash left out). A kernel whose instructions
are identical computes the same values bit for bit as its parent. Prints one
line per kernel: identical, differing (with the count of differing
instructions, and the pairs themselves where there are few), or present on
one side only.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

from dfanerf_torch.ops import _build  # noqa: E402

_FUNC = re.compile(r"\s*Function : (\S+)")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
SHOW = 32  # differing instructions printed, pair by pair, up to this many
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")


def _cuobjdump() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "cuobjdump")):
            return os.path.join(root, "bin", "cuobjdump")
    raise SystemExit("compare_sass: no cuobjdump")


def _build_parent(csrc: Path, out: Path) -> list:
    """The parent's libraries, one nvcc per source, all at once."""
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sorted(csrc.glob("*.cu")):
        lib = out / f"lib{src.stem}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        procs.append((lib, subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                            stderr=subprocess.PIPE, text=True)))
    for lib, proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"compare_sass: building {lib.name} failed:\n{err}")
    return [lib for lib, _ in procs]


def _functions(libs) -> dict:
    """{kernel name (per-file hash left out): (library, [instructions])}."""
    tool = _cuobjdump()
    funcs = {}
    for lib in libs:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                              check=True).stdout
        current = None
        for line in sass.splitlines():
            m = _FUNC.match(line)
            if m:
                current = _ANON.sub("", m.group(1))
                funcs[current] = (re.sub(r"^lib|(-[0-9a-f]+)?\.so$", "", Path(lib).name), [])
                continue
            m = _INSN.search(line)
            if m and current is not None:
                funcs[current][1].append(_ANON.sub("", m.group(1)))
    return funcs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="root of the parent checkout")
    args = ap.parse_args()
    mine = _functions(_build.build().values())
    parent = _functions(_build_parent(Path(args.parent) / "dfanerf_torch" / "ops" / "csrc",
                                      HERE / "build" / "sass_parent"))
    for name in sorted(set(mine) | set(parent)):
        if name not in parent or name not in mine:
            side = "this checkout" if name in mine else "the parent"
            print(f"[sass] {name}: only in {side}", flush=True)
            continue
        (lib_a, a), (lib_b, b) = mine[name], parent[name]
        n_diff = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
        state = "identical" if n_diff == 0 else f"DIFFERS in {n_diff} instructions"
        print(f"[sass] {name} ({lib_a}; parent {lib_b}): {len(a)} vs {len(b)} instructions, "
              f"{state}", flush=True)
        if 0 < n_diff <= SHOW and len(a) == len(b):
            for x, y in zip(a, b):
                if x != y:
                    print(f"[sass]   {x}   (parent: {y})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
