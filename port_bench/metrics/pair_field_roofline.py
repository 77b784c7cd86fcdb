"""Pair field kernels: pair_field launches of the served frames against their
roofline, over the listed pairs, with chip_smoke.py's byte model
(port_bench/counts.py pair_bytes). The refresh worker's launches, on its own
stream, are left out. Moves fps."""

from port_bench import counts
from port_bench.serve import roofline_share


def read(run):
    return roofline_share(run, "pair_field_kernel",
                          lambda fields, tiles, blocks: counts.pair_bytes(tiles, blocks, 8, fields))
