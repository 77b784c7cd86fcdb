"""Hierarchical kernels: pair_field_perz launches against their roofline,
over the listed fine pairs. Moves fps."""

from port_bench import counts
from port_bench.serve import roofline_share


def read(run):
    return roofline_share(run, "pair_field_perz_kernel",
                          lambda fields, tiles, blocks: counts.perz_bytes(tiles, blocks))
