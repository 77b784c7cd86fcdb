"""Dense kernel: render_rays launches against their roofline, counted over
the flagged (tile, slab) blocks of each class segment. Moves fps."""

from port_bench import counts
from port_bench.serve import roofline_share


def read(run):
    return roofline_share(run, "render_rays_kernel",
                          lambda fields, tiles, blocks: counts.render_rays_bytes(tiles, fields))
