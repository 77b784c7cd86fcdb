"""The yardstick's arithmetic, frozen here so that a change to the program
cannot move it: the matrix-product FLOPs of one field at one (ray, sample)
at the decoder's live widths, the bytes each kernel must move, and the
published peaks of one H100 SXM card.

Copied from dfanerf_torch/ops/fused_render.py (``field_flops_per_sample``,
``render_flops_per_sample``) and chip_smoke.py (``_pair_bytes``,
``_render_rays_bytes``); port_bench/tests/test_bench_counts.py holds them
equal to the program's at the published widths.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core peak and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

PE_DIM, TORSO_SIGNAL_DIM, HIDDEN, DEFORM_HIDDEN = 60, 42, 256, 64
RAYS_PER_TILE, SAMPLES_PER_SLAB = 256, 8


def field_flops_per_sample(branch: str, sigma: bool = True, color: bool = True) -> int:
    """Matrix-product FLOPs of one field at one (ray, sample) at live widths:
    the PE's 60 rows, the torso trunk's 60 + 42 input rows, the deformation
    net as two 64-wide chains, the sigma column, the 256 view-feature
    columns and the 3 colour columns. ``sigma`` / ``color`` select the heads
    a kernel computes."""
    if branch not in ("head", "torso"):
        raise ValueError(f"unknown branch {branch!r}")
    k_in = PE_DIM if branch == "head" else PE_DIM + TORSO_SIGNAL_DIM
    macs = k_in * HIDDEN * 2 + 7 * HIDDEN * HIDDEN
    if sigma:
        macs += HIDDEN
    if color:
        macs += HIDDEN * HIDDEN + HIDDEN * 3
    if branch == "torso":
        dh = DEFORM_HIDDEN
        macs += PE_DIM * 2 * dh + 4 * 2 * dh * dh + PE_DIM * dh + dh * k_in
    return 2 * macs


def render_flops_per_sample(fields: str = "both") -> int:
    """The dense kernel's work at one (ray, sample) of a slab it runs."""
    return sum(field_flops_per_sample(b) for b in ("head", "torso") if fields in ("both", b))


def blob_sizes(branch: str):
    """(bf16 elements, float32 elements) of a field's weight and bias blobs as
    the pair kernels read them (the program's ``weight_blobs`` layout)."""
    k_in = 64 if branch == "head" else 128
    w = HIDDEN * k_in * 2 + 7 * HIDDEN * HIDDEN + 384 * HIDDEN + 8 * HIDDEN
    b = HIDDEN + 7 * HIDDEN + HIDDEN + 384 + 8
    if branch == "torso":
        d = 2 * DEFORM_HIDDEN
        w += d * 64 * 2 + 4 * d * d + d * d
        b += d * 4 + 4 * d
    return w, b


def packed_bytes(branch: str) -> int:
    """Bytes of a field's packed operands the dense kernel reads (every
    packed tensor but the view layer, which the wrapper folds per ray)."""
    k_in = 64 if branch == "head" else 128
    bf16 = HIDDEN * k_in * 2 + 7 * HIDDEN * HIDDEN + HIDDEN * 384 + HIDDEN * 128
    f32 = HIDDEN + 7 * HIDDEN + HIDDEN + 384 + 128
    if branch == "torso":
        d = 2 * DEFORM_HIDDEN
        bf16 += 64 * d * 2 + 4 * d * d + d * d
        f32 += 8 * d  # d_b1, d_bk (4), d_bskip, d_bout, sig_pad
    return 2 * bf16 + 4 * f32


def pair_bytes(k_u: int, K: int, sp: int, branch: str, n_samples: int = 64) -> int:
    """Bytes a pair kernel must move over K listed pairs of k_u gathered
    tiles at sp samples a slab: the rays and view bias, the shared depths,
    the pair list, the weight and bias blobs, and the listed blocks of the
    four output buffers (chip_smoke.py ``_pair_bytes``)."""
    w, b = blob_sizes(branch)
    return (2 * k_u * 256 * 3 * 4 + k_u * 256 * 256 * 2 + n_samples * 4 + 2 * K * 4
            + w * 2 + b * 4 + K * sp * 256 * (4 + 3 * 2))


def perz_bytes(k_u: int, K: int) -> int:
    """``pair_bytes`` for the fine pass at per-ray depths: each listed block
    reads its own 8 x 256 float32 depths instead of the shared ones."""
    w, b = blob_sizes("head")
    return (2 * k_u * 256 * 3 * 4 + k_u * 256 * 256 * 2 + 2 * K * 4 + K * 8 * 256 * 4
            + w * 2 + b * 4 + K * 8 * 256 * (4 + 3 * 2))


def render_rays_bytes(n_tiles: int, fields: str, n_samples: int = 64) -> int:
    """Bytes ``render_rays`` must move over n_tiles tiles (chip_smoke.py
    ``_render_rays_bytes``): rays, depths, dists, view biases, the
    background, flags, the packed weights of the fields it evaluates, the
    outputs and the slab counts."""
    n_pad, S = n_tiles * 256, n_samples
    weights = sum(packed_bytes(b) for b in ("head", "torso") if fields in ("both", b))
    return (4 * n_pad * 3 * 4 + S * 4 + 2 * S * n_pad * 4 + 2 * n_pad * 256 * 2 + n_pad * 3 * 4
            + n_tiles * (S // 8) * 4 + weights + 2 * n_pad * 3 * 4 + n_tiles * 4)


def roofline_pct(flops: float, n_bytes: float, seconds: float):
    """Share of the roofline bound, in %: the larger of flops / peak and
    bytes / bandwidth over the measured seconds. None without a time."""
    if seconds <= 0 or (flops <= 0 and n_bytes <= 0):
        return None
    return 100.0 * max(flops / PEAK_BF16_FLOPS, n_bytes / PEAK_HBM_BYTES) / seconds
