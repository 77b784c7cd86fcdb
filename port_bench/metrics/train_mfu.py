"""The training step's share of the card's bf16 peak: three times the forward
FLOPs of both fields at every (ray, sample) of the traced steps (the step's
rays by the samples a ray, at the decoder's live widths,
port_bench/counts.py), over the traced window. Moves train_rays_per_s."""

from port_bench import counts


def read(run):
    tr = run.trace
    n = sum(1 for *_, on in run.steps if on)
    if tr is None or n == 0:
        return None
    flops = 3 * n * run.n_rand * run.n_samples * counts.render_flops_per_sample("both")
    return 100.0 * flops / counts.PEAK_BF16_FLOPS / tr.window_s
