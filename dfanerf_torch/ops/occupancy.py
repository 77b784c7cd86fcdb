"""Conservative per-(field, tile, slab) occupancy flags (port of
dfanerf_tpu/ops/fused_render.py :374-600).

The reference computes these in XLA, outside any kernel. For each (tile,
slab) the samples of a TILE x TILE pixel tile lie inside the convex hull of
its 4 corner rays at the slab's z extremes, so the axis-aligned box of those
8 points bounds them; a flag is set when the box meets an occupied voxel of
a dilated density grid, found with one summed-area-table query.

The density at the grid's fine nodes has two implementations:

- ``node_grid_kernel``: the hand-written CUDA kernel csrc/node_grid.cu, one
  launch per field over the whole grid, bound with ctypes and built at first
  launch. It counts its launches in ``node_grid_kernel.launches``.
- ``node_density_reference``: the plain PyTorch version, the reference's
  grid in z-groups of 8 slices (bounding the [8 Gf^2, 384] trunk
  intermediate).

``node_density`` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises. ``node_grid_rows`` is the
kernel's own semantics in plain PyTorch (its PE, its bf16 rounding points,
its point arithmetic), for the tests.

Flags must equal the reference's exactly, so every step keeps its rounding:
the grid nodes come from the XLA-rounded ``linspace`` (a product, then a
sum, on both paths), the pooling and dilation are max-pools, the table is an
integer cumsum, and the box bounds are the same float32 expressions in the
same order. What can differ is the float32 sum order of the bf16 trunk
products and, in the kernel, the PE's rounding (its cos half is a sin at a
phase of pi/2, and the torso's deformation adds the bf16 PE, as the render
kernels do), which move a node's density by a few ulps: a node within that
distance of ``sigma_thresh * 0.25`` can flip.

The reference's knobs that its renderer never sets are constants here: 16x16
tiles (``TILE``, the layout of ``spatial_tile_permutation``), 2 fine nodes per
grid step (``SUPERSAMPLE``) and bf16 trunk products for the grid.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from dfanerf_torch.core.posenc import sincos_posenc
from dfanerf_torch.core.rays import linspace
from dfanerf_torch.ops import _build
from dfanerf_torch.ops.fused_render import (
    PE_PAD, R_T, S_SLAB, TILE, _deform, _mm_cast, _mm_kernel, _slot_tables, _trunk, density_act,
    pe_replicate, sigma_only,
)
from dfanerf_torch.ops.sigma_head import sigma_rows

SUPERSAMPLE = 2  # fine density nodes per grid step along each axis
MAX_FINE = 1290  # the kernel's largest fine grid side (gf^3 nodes fit an int; its launch checks)
_ROWS = 65536  # nodes per group in node_grid_rows (bounds its activation memory)


def packed_sigma_xla(pw: Dict[str, torch.Tensor], pts: torch.Tensor, branch: str,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Density-only packed forward (reference :374): pts [N, 3] -> [N] raw
    sigma (before the density activation). Matrix inputs are rounded to
    ``dtype`` (the grid's bf16; the background epilogue's follows the packed
    weights) with float32 accumulation, as the reference's dots."""
    pe = sincos_posenc(pts.float(), 10, 2.0)
    pe = torch.cat([pe, pe.new_zeros((pe.shape[0], PE_PAD - pe.shape[1]))], dim=-1)
    mm = _mm_cast(dtype)
    x = _deform(pw, pe, mm) if branch == "torso" else pe
    return _trunk(sigma_only(pw), x, mm)[:, 0]


def _check(branch: str, act: str) -> None:
    if branch not in ("head", "torso"):
        raise ValueError(f"unknown branch {branch!r}")
    if act not in ("relu", "softplus"):
        raise ValueError(f"unknown density activation {act!r}")


def node_density_reference(pw, branch: str, lo: torch.Tensor, span: torch.Tensor,
                           grid_res: int, act: str = "relu") -> torch.Tensor:
    """Plain PyTorch version of the node grid: density (after the
    activation) at the (grid_res * SUPERSAMPLE)^3 fine nodes spanning [lo,
    lo + span], axes (z, y, x) (reference :407-423)."""
    gf = grid_res * SUPERSAMPLE
    g_fine = linspace(0.0, 1.0, gf, device=lo.device)
    gy, gx = torch.meshgrid(g_fine, g_fine, indexing="ij")
    zc = 8 if gf % 8 == 0 else 4
    slabs = []
    for z_group in g_fine.reshape(gf // zc, zc):
        pts = lo + torch.stack(
            [gx.expand(zc, gf, gf), gy.expand(zc, gf, gf),
             z_group[:, None, None].expand(zc, gf, gf)], dim=-1).reshape(-1, 3) * span
        slabs.append(density_act(packed_sigma_xla(pw, pts, branch), act).reshape(zc, gf, gf))
    return torch.cat(slabs)


@torch.no_grad()
def node_grid_rows(pw, branch: str, lo: torch.Tensor, span: torch.Tensor, grid_res: int,
                   nodes: torch.Tensor, act: str = "relu") -> torch.Tensor:
    """The kernel's semantics in plain PyTorch at the flat fine-node indices
    ``nodes`` [N] of the (z, y, x) grid: the point lo + g * span, the PE as
    one sin(p * freq + phase) over the slot tables rounded to bf16, the
    torso's deformation on it, the trunk and the sigma column with
    activations rounded to bf16, and the density activation -> [N]."""
    _check(branch, act)
    gf = grid_res * SUPERSAMPLE
    g = linspace(0.0, 1.0, gf, device=lo.device)
    freq, phase = _slot_tables(lo.device)
    pw_s = sigma_only(pw)
    out = []
    for rows in nodes.split(_ROWS):
        idx = torch.stack([rows % gf, rows // gf % gf, rows // (gf * gf)], dim=-1)
        pts = lo + g[idx] * span
        x = torch.sin(pe_replicate(pts) * freq + phase).to(torch.bfloat16)
        if branch == "torso":
            x = _deform(pw, x, _mm_kernel)
        out.append(sigma_rows(pw_s, x, act))
    return torch.cat(out)


class NodeGridKernel(_build.Binding):
    """ctypes binding of csrc/node_grid.cu."""

    def __init__(self):
        ptr = ctypes.c_void_p
        super().__init__("node_grid", {
            "node_grid_launch": [ctypes.c_int] + [ptr] * 8 + [ctypes.c_int] * 2 + [ptr]})

    def __call__(self, pw, branch: str, lo: torch.Tensor, span: torch.Tensor, grid_res: int,
                 act: str = "relu") -> torch.Tensor:
        """Launch on the current stream; same operands and result as
        ``node_density_reference``."""
        _check(branch, act)
        gf = grid_res * SUPERSAMPLE
        if not 2 <= gf <= MAX_FINE:
            raise ValueError(f"node grid of {gf}^3 fine nodes: the kernel takes 2 to {MAX_FINE}")
        dev = _build.check_cuda_operands("node_grid_kernel", {
            "lo": (lo, (3,), torch.float32), "span": (span, (3,), torch.float32)})
        w, b = self.blobs(pw, branch, dev)
        freq, phase = _slot_tables(dev)
        out = torch.empty((gf, gf, gf), dtype=torch.float32, device=dev)
        self.launch("node_grid_launch", dev, int(branch == "torso"),
                    linspace(0.0, 1.0, gf, device=dev), lo, span, freq, phase, w, b, out, gf,
                    int(act == "softplus"))
        return out


node_grid_kernel = NodeGridKernel()


def node_density(pw, branch: str, lo: torch.Tensor, span: torch.Tensor, grid_res: int,
                 act: str = "relu") -> torch.Tensor:
    """Density (after the activation) at the (grid_res * SUPERSAMPLE)^3 fine
    nodes spanning [lo, lo + span], axes (z, y, x): the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check(branch, act)
    dev = lo.device
    if dev.type == "cuda":
        return node_grid_kernel(pw, branch, lo, span, grid_res, act)
    if dev.type != "cpu":
        raise ValueError(f"node_density runs on cpu or cuda tensors, got {dev}")
    return node_density_reference(pw, branch, lo, span, grid_res, act)


def _occupancy_sat(node_on: torch.Tensor) -> torch.Tensor:
    """Occupied fine nodes [Gf]^3 (bool) -> 3D summed-area table [G+1]^3
    (reference :389): max-pooled down to G^3 and dilated 3^3 (zero padding)
    before the table, which has axes (z, y, x)."""
    occ = F.max_pool3d(node_on.float()[None, None], SUPERSAMPLE, SUPERSAMPLE)
    # values are >= 0, so max-pooling's implicit -inf padding equals zeros
    occ = F.max_pool3d(occ, 3, 1, padding=1)[0, 0].to(torch.int32)
    sat = F.pad(occ, (1, 0, 1, 0, 1, 0))
    return sat.cumsum(0).cumsum(1).cumsum(2)


def _sat_box_any(sat: torch.Tensor, i_lo: torch.Tensor, i_hi: torch.Tensor) -> torch.Tensor:
    """Any-occupied query over inclusive node boxes (reference :439).
    i_lo/i_hi [..., 3] in (x, y, z) order; the table's axes are (z, y, x)."""
    a0, a1 = i_lo[..., 2].long(), i_hi[..., 2].long() + 1
    b0, b1 = i_lo[..., 1].long(), i_hi[..., 1].long() + 1
    c0, c1 = i_lo[..., 0].long(), i_hi[..., 0].long() + 1

    def s(a, b, c):
        return sat[a, b, c]

    count = (s(a1, b1, c1) - s(a0, b1, c1) - s(a1, b0, c1) - s(a1, b1, c0)
             + s(a0, b0, c1) + s(a0, b1, c0) + s(a1, b0, c0) - s(a0, b0, c0))
    return count > 0


def flags_from_nodes(node_on: torch.Tensor, i_lo: torch.Tensor, i_hi: torch.Tensor) -> torch.Tensor:
    """[T, J] bool: which (tile, slab) boxes meet the dilated grid of the
    occupied fine nodes ``node_on`` [Gf]^3."""
    return _sat_box_any(_occupancy_sat(node_on), i_lo, i_hi)


def tile_corner_rays(rays: torch.Tensor) -> torch.Tensor:
    """Corner rays of each spatial tile (reference :453): rays [n, 3] in
    spatial-tile order -> [n_tiles, 4, 3]. Pinhole ray directions are affine
    in pixel coordinates, so every ray of a tile lies in the hull of its 4
    corners."""
    n = rays.shape[0]
    if n % R_T:
        raise ValueError(f"{n} rays do not make whole {TILE}x{TILE} tiles")
    # rows and columns 0 and TILE - 1 of each tile: rays 0, TILE - 1,
    # (TILE - 1) * TILE and TILE * TILE - 1, by slicing (an index tensor
    # would be a host-to-device copy, which synchronizes a steady frame)
    corners = rays.reshape(n // R_T, TILE, TILE, 3)[:, ::TILE - 1, ::TILE - 1]
    return corners.reshape(n // R_T, 4, 3)


Box = Tuple[torch.Tensor, torch.Tensor]


def occupancy_boxes(rays_o, rays_d, rays_o_t, rays_d_t, z_vals: torch.Tensor, grid_res: int,
                    s_slab: int = S_SLAB) -> Tuple[torch.Tensor, torch.Tensor, List[Box]]:
    """The node grid both fields share and each field's (tile, slab) boxes
    on it (reference :545-592), at ``s_slab`` samples per slab: (lo, span,
    [(i_lo, i_hi) head, (i_lo, i_hi) torso]), boxes [T, J, 3] int32
    inclusive node indices in (x, y, z)."""
    n_slabs = z_vals.shape[0] // s_slab
    zs = z_vals.float().reshape(n_slabs, s_slab)
    z_ends = torch.stack([zs[:, 0], zs[:, -1]], dim=1)  # [J, 2]

    def corner_pts(ro, rd):  # [T, J, 2, 4, 3]
        o_c, d_c = tile_corner_rays(ro.float()), tile_corner_rays(rd.float())
        return o_c[:, None, None] + d_c[:, None, None] * z_ends[None, :, :, None, None]

    pts = [corner_pts(rays_o, rays_d), corner_pts(rays_o_t, rays_d_t)]
    lo, span = _grid_extent(torch.cat([p.reshape(-1, 3) for p in pts]))
    return lo, span, [_node_box(p, lo, span, grid_res) for p in pts]


def _grid_extent(allp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, span) of the node grid spanning the points allp [N, 3]."""
    lo = allp.amin(0)
    return lo, torch.clamp_min(allp.amax(0) - lo, 1e-6)


def _node_box(pts: torch.Tensor, lo: torch.Tensor, span: torch.Tensor, grid_res: int) -> Box:
    """Inclusive node boxes [T, J, 3] (x, y, z) of the corner points pts
    [T, J, 2, 4, 3] of each (tile, slab), in the reference's float32 order."""
    voxel = span / (grid_res - 1)
    ab_lo = pts.amin(dim=(2, 3))  # [T, J, 3]
    ab_hi = pts.amax(dim=(2, 3))
    i_lo = torch.clamp(torch.ceil((ab_lo - lo) / voxel - 0.5).to(torch.int32), 0, grid_res - 1)
    i_hi = torch.clamp(torch.floor((ab_hi - lo) / voxel + 0.5).to(torch.int32), 0, grid_res - 1)
    return i_lo, i_hi


@torch.no_grad()
def conservative_occupancy(pw_h, pw_t, rays_o, rays_d, rays_o_t, rays_d_t,
                           z_vals: torch.Tensor, sigma_thresh: float, grid_res: int = 64,
                           act: str = "relu", s_slab: Optional[int] = None) -> torch.Tensor:
    """Per-(field, tile, slab) occupancy flags for the pair kernels
    (reference :534). Rays in spatial-tile order; z_vals [S]; ``s_slab``
    samples per slab (8 by default, 4 for the half-slabs of occ_pack2; the
    node grid spans the same points either way). Returns [2, n_tiles,
    S / s_slab] int32 (0 = head, 1 = torso)."""
    sp = S_SLAB if s_slab is None else s_slab
    lo, span, boxes = occupancy_boxes(rays_o, rays_d, rays_o_t, rays_d_t, z_vals, grid_res, sp)
    flags = [flags_from_nodes(node_density(pw, branch, lo, span, grid_res, act)
                              > sigma_thresh * 0.25, *b)
             for pw, branch, b in ((pw_h, "head", boxes[0]), (pw_t, "torso", boxes[1]))]
    return torch.stack(flags).to(torch.int32)


Sat = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@torch.no_grad()
def occupancy_flags_and_sat(pw, branch: str, rays_o: torch.Tensor, rays_d: torch.Tensor,
                            z_vals: torch.Tensor, sigma_thresh: float, grid_res: int = 64,
                            sat_cache: Optional[Sat] = None,
                            act: str = "relu") -> Tuple[torch.Tensor, Sat]:
    """Per-(tile, slab) flags of one field for per-ray depths (reference
    :499), the hierarchical render's: rays [n, 3] in spatial-tile order,
    z_vals [n, S] sorted per ray. A slab's z extent is the min and max over
    its tile's rays, so the 8 corner points of the tile's corner rays at
    those depths bound every sample of the (tile, slab).

    The node grid spans this field's corner points. ``sat_cache`` is the
    (sat, lo, span) of an earlier call on the same field whose grid bounds
    these points (the fine pass reuses the coarse pass's: its depths lie in
    the same [near, far]); no grid is evaluated then. Returns flags [T, J]
    int32 and the (sat, lo, span) used."""
    n, S = z_vals.shape
    if n % R_T or S % S_SLAB:
        raise ValueError(f"{n} rays and {S} samples must make whole {R_T}-ray tiles and "
                         f"{S_SLAB}-sample slabs")
    T, J = n // R_T, S // S_SLAB
    zt = z_vals.float().reshape(T, R_T, J, S_SLAB)
    z_ends = torch.stack([zt.amin(dim=(1, 3)), zt.amax(dim=(1, 3))], dim=-1)  # [T, J, 2]
    o_c, d_c = tile_corner_rays(rays_o.float()), tile_corner_rays(rays_d.float())
    pts = o_c[:, None, None] + d_c[:, None, None] * z_ends[..., None, None]  # [T, J, 2, 4, 3]
    if sat_cache is None:
        lo, span = _grid_extent(pts.reshape(-1, 3))
        sat = _occupancy_sat(node_density(pw, branch, lo, span, grid_res, act)
                             > sigma_thresh * 0.25)
    else:
        sat, lo, span = sat_cache
    flags = _sat_box_any(sat, *_node_box(pts, lo, span, grid_res)).to(torch.int32)
    return flags, (sat, lo, span)


def occupancy_flags_dynamic_z(pw, branch: str, rays_o: torch.Tensor, rays_d: torch.Tensor,
                              z_vals: torch.Tensor, sigma_thresh: float, grid_res: int = 64,
                              sat_cache: Optional[Sat] = None, act: str = "relu") -> torch.Tensor:
    """The flags of ``occupancy_flags_and_sat`` alone (reference :466)."""
    return occupancy_flags_and_sat(pw, branch, rays_o, rays_d, z_vals, sigma_thresh, grid_res,
                                   sat_cache, act)[0]
