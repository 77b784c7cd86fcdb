"""Device idle share of the traced training window: 100 x (1 - busy / window),
busy being the union of the device operations' intervals (torch.profiler,
CUPTI). Moves train_rays_per_s."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
