"""The benchmark of dfanerf_torch on NVIDIA H100 cards: ``python3 port_bench/run.py``
runs one cell of BENCHMARK.json once (see run.py)."""
