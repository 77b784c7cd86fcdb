"""Serving path ``pairs``: the head+torso renderer on pair lists
(``make_frame_renderer`` with ``occ_pair_compaction``), ``pair_field`` over
each field's listed (tile, slab) pairs of the union tiles. Its reference is
the no-skip frame: it does not follow the pair lists, so only numbers that
need no skip decisions (``nonfinite_px``) hold this path to it. A cell that
compares pixels on the pair path brings a path whose reference follows its
lists."""

from port_bench import counts, serve
from port_bench.serve import prepare  # noqa: F401  (both fields calibrated)

KERNELS = {"pair_field_kernel": serve.Kernel(
    counts.field_flops_per_sample,
    lambda fields, tiles, blocks: counts.pair_bytes(tiles, blocks, 8, fields))}


class Program(serve.Program):
    kind = "pairs"

    def work(self) -> list:
        """One launch a field over the union tiles and its listed pairs."""
        cache = self.render.cache
        k_u = len(cache["tiles_u"])
        return [("pair_field_kernel", b, k_u, int(t.numel()))
                for b, (t, _) in zip(("head", "torso"), cache["lists"])]


reference_frames = serve.no_skip_frames
