"""Serving path ``tile_classes``: the shipped head+torso renderer
(``make_frame_renderer`` with ``occ_tile_compaction``), ``render_rays`` over
each class segment of the tiles (both fields, head, torso) under the node
grid's (tile, slab) flags, refreshed every ``occ_refresh_every`` frames. The
reference builds the node grid, the flags and the classes itself at the same
refresh frames."""

from port_bench import counts, reference, serve
from port_bench.serve import prepare  # noqa: F401  (both fields calibrated)

BOX_EPS = 0.05  # a box bound within this many node steps of a node may be decided either way

KERNELS = {"render_rays_kernel": serve.Kernel(
    counts.render_flops_per_sample,
    lambda fields, tiles, blocks: counts.render_rays_bytes(tiles, fields))}


class Program(serve.Program):
    kind = "tile_classes"

    def __init__(self, st):
        super().__init__(st)
        self._class_work = (None, None)

    def work(self) -> list:
        """A ``render_rays`` launch a class segment: its tiles and flagged
        (tile, slab) blocks, from the renderer's classes."""
        cache = self.render.cache
        key = cache["order"]
        if self._class_work[0] is not key:  # the flags changed: a refresh frame
            fields = ("both", "head", "torso")
            w = [("render_rays_kernel", fields[i], k, int(cache["occs"][i].sum()))
                 for i, k in enumerate(cache["ks"]) if k]
            self._class_work = (key, w)
        return self._class_work[1]


def reference_frames(st, frames, prec="fp32"):
    """The reference's frames under its own flags and classes, decided at
    each frame's refresh frame."""
    hwf = (st.clip.H, st.clip.W, st.clip.focal)
    dec, rcfg, margin = st.model["decoder"], st.render, serve.margin(st)
    return serve.frames_under_refresh(
        st, frames,
        lambda fr, masks: reference.head_torso_skip_frame(st.params, dec, rcfg, fr, masks, hwf,
                                                          margin, prec),
        lambda fr: reference.class_masks(reference.decisions(st.params, dec, rcfg, fr, hwf,
                                                             margin, BOX_EPS, prec)))
