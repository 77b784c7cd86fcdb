"""Serving path ``hier_pairs``: the hierarchical head on pair lists
(``make_head_hierarchical_renderer`` with ``occ_pair_compaction`` and
``occ_sigma_thresh`` > 0): ``pair_sigma`` over the coarse pairs, the
resample, ``pair_field_perz`` over the fine pairs. The reference builds the
coarse grid and flags, the coarse pass, the resample, the fine flags and the
prunes itself at the same refresh frames, and ANDs them with that frame's
lists."""

from port_bench import counts, reference, serve
from port_bench.serve import prepare  # noqa: F401  (the head alone calibrated)

BOX_EPS = 0.25  # node steps; the fine depths follow the coarse densities' rounding


def _sigma_bytes(fields, k_u, K, n_samples=64):
    """Bytes ``pair_sigma`` must move over K listed pairs of k_u union tiles
    (chip_smoke.py's ``bytes_c``): the rays, the shared depths, the pair
    list, the field's packed weights but the view layer, and the density of
    each listed block."""
    return (2 * k_u * 256 * 3 * 4 + n_samples * 4 + 2 * K * 4 + counts.packed_bytes(fields)
            + K * 8 * 256 * 4)


KERNELS = {
    "pair_sigma_kernel": serve.Kernel(
        lambda fields: counts.field_flops_per_sample(fields, sigma=True, color=False),
        _sigma_bytes),
    "pair_field_perz_kernel": serve.Kernel(
        counts.field_flops_per_sample,
        lambda fields, tiles, blocks: counts.perz_bytes(tiles, blocks)),
}


class Program(serve.Program):
    kind = "hier_pairs"

    def work(self) -> list:
        """One launch of each pass over the union tiles and its listed pairs."""
        cache = self.render.cache
        if cache.get("empty"):
            return []
        k_u = len(cache["tiles_u"])
        return [("pair_sigma_kernel", "head", k_u, int(cache["ti_c"].numel())),
                ("pair_field_perz_kernel", "head", k_u, int(cache["ti_f"].numel()))]


def reference_frames(st, frames, prec="fp32"):
    """The reference's frames under its own refresh state, built at each
    frame's refresh frame."""
    hwf = (st.clip.H, st.clip.W, st.clip.focal)
    dec, rcfg, margin = st.model["decoder"], st.render, serve.margin(st)
    return serve.frames_under_refresh(
        st, frames,
        lambda fr, state: reference.head_hier_skip_frame(st.params, dec, rcfg, fr, state, hwf,
                                                         prec),
        lambda fr: reference.hier_refresh(st.params, dec, rcfg, fr, hwf, margin, BOX_EPS, prec))
