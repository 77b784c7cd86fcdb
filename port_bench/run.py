"""Run one cell of BENCHMARK.json once and print its result as the last line
of standard output:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (dfanerf_torch), on a
machine with the CUDA cards the cell asks for. The program builds its kernels
into build/kernels inside the checkout on a cell's first run there.
"""

import time

T_PROC = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    from port_bench.harness import main

    sys.exit(main(sys.argv[1:], T_PROC))
