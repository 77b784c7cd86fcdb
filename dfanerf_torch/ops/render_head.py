"""Head-field volume render with a depth per ray: the fine pass of the
hierarchical head render (port of dfanerf_tpu/ops/fused_render.py
fused_render_head :2025).

Each ray of a 256-ray tile marches its own sorted depths (the coarse and
importance samples' union) through the frame-folded head field
(ops/pack.py) and composites the head stack in float32, 8 samples a slab:
interval lengths from the ray's own depths with ``last_dist`` on the final
one, the background pixel as the colour of the union's final sample, the
+1e-6 bumps of the reference's background concat, early ray termination
decided per tile on its largest transmittance (``ert_eps``) and
per-(tile, slab) occupancy flags; the last slab always runs.

Two implementations over the same prepared operands
(``prepare_head_operands``):

- ``render_head_kernel``: the hand-written CUDA kernel csrc/render_head.cu
  (the port of the Pallas ``_head_kernel``, on the wgmma core), one block
  per tile, bound with ctypes and built at first launch. It counts its
  launches in ``render_head_kernel.launches``.
- ``fused_render_head_reference``: its plain PyTorch version, with the same
  bf16 rounding points and the same per-tile ERT/occupancy decisions and
  compositing recurrence.

``fused_render_head`` takes the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from dfanerf_torch.ops import _build
from dfanerf_torch.ops.fused_render import (
    PE_PAD, R_T, S_SLAB, _REF_TILES, _field_rows, _slot_tables, pe_replicate, view_bias,
)


@dataclasses.dataclass
class HeadOperands:
    """Padded per-ray inputs of the head render, n_pad = n_tiles * 256."""

    rays_o: torch.Tensor   # [n_pad, 3] f32
    rays_d: torch.Tensor
    z: torch.Tensor        # [S, n_pad] f32 per-ray depths (padding rays 1.0)
    dists: torch.Tensor    # [S, n_pad] f32: diff(z) * |d|, last: last_dist * |d|
    vr: torch.Tensor       # [n_pad, 256] bf16 view bias
    bc: torch.Tensor       # [n_pad, 3] f32 background pixel
    occ: torch.Tensor      # [n_tiles, n_slabs] int32 (nonzero = evaluate)
    packed_h: Dict[str, torch.Tensor]
    ert_eps: float
    act: str

    @property
    def n_tiles(self) -> int:
        return self.occ.shape[0]

    @property
    def n_slabs(self) -> int:
        return self.occ.shape[1]


def prepare_head_operands(packed_h, rays_o, rays_d, z_vals, bc_rgb, last_dist: float = 1e10,
                          ert_eps: float = 0.0, occupancy: Optional[torch.Tensor] = None,
                          act: str = "relu") -> HeadOperands:
    """Pad the rays to whole tiles (padding rays take depth 1.0, as the
    reference's do) and build the per-ray operands. z_vals [n, S] per ray,
    or [S] shared."""
    if act not in ("relu", "softplus"):
        raise ValueError(f"unknown density activation {act!r}")
    n = rays_o.shape[0]
    dev = rays_o.device
    if z_vals.ndim == 1:
        z_vals = z_vals[None].expand(n, -1)
    S = z_vals.shape[1]
    if S % S_SLAB:
        raise ValueError(f"n_samples={S} must be a multiple of {S_SLAB}")
    T = -(-n // R_T)
    pad = T * R_T - n

    def padded(x, fill=0.0):
        x = x.to(device=dev, dtype=torch.float32)
        return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)]).contiguous()

    ro, rd, bc = padded(rays_o), padded(rays_d), padded(bc_rgb)
    z = padded(z_vals, fill=1.0)
    diffs = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], last_dist)], dim=1)
    dists = diffs * torch.linalg.norm(rd, dim=-1, keepdim=True)
    if occupancy is None:
        occ = torch.ones((T, S // S_SLAB), dtype=torch.int32, device=dev)
    else:
        occ = occupancy.to(device=dev, dtype=torch.int32).contiguous()
        if tuple(occ.shape) != (T, S // S_SLAB):
            raise ValueError(f"occupancy shape {tuple(occ.shape)} != {(T, S // S_SLAB)}")
    return HeadOperands(
        rays_o=ro, rays_d=rd, z=z.t().contiguous(), dists=dists.t().contiguous(),
        vr=view_bias(packed_h, rd).to(torch.bfloat16).contiguous(), bc=bc, occ=occ,
        packed_h=packed_h, ert_eps=float(ert_eps), act=act)


@torch.no_grad()
def fused_render_head_reference(ops: HeadOperands) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the CUDA kernel over the same operands.
    Returns rgb [n_pad, 3] (fp32) and the slabs evaluated per tile [n_tiles]
    (int32)."""
    T, J = ops.n_tiles, ops.n_slabs
    dev = ops.rays_o.device
    freq, phase = _slot_tables(dev)
    o_rep = pe_replicate(ops.rays_o).reshape(T, R_T, PE_PAD)
    d_rep = pe_replicate(ops.rays_d).reshape(T, R_T, PE_PAD)
    vr = ops.vr.float().reshape(T, R_T, 256)
    bc = ops.bc.reshape(T, R_T, 3)
    z = ops.z.reshape(J, S_SLAB, T, R_T)
    dists = ops.dists.reshape(J, S_SLAB, T, R_T)
    t_acc = torch.ones((T, R_T, 1), device=dev)
    acc = torch.zeros((T, R_T, 3), device=dev)
    slabs = torch.zeros((T,), dtype=torch.int32, device=dev)
    for j in range(J):
        is_last = j == J - 1
        alive = (t_acc.amax(dim=(1, 2)) > ops.ert_eps) & (ops.occ[:, j] != 0)
        if is_last:
            alive = torch.ones_like(alive)
        tiles = alive.nonzero()[:, 0]
        slabs[tiles] += 1
        for start in range(0, tiles.numel(), _REF_TILES):
            idx = tiles[start:start + _REF_TILES]
            c = idx.numel()
            zz = z[j][:, idx].transpose(0, 1)[..., None]  # [c, 8, R_T, 1]
            pts = o_rep[idx][:, None] + d_rep[idx][:, None] * zz
            x = torch.sin(pts * freq + phase).to(torch.bfloat16).reshape(-1, PE_PAD)
            vr_rows = vr[idx][:, None].expand(c, S_SLAB, R_T, 256).reshape(-1, 256)
            sigma, rgb = _field_rows(ops.packed_h, x, vr_rows, "head", ops.act)
            sigma = sigma.reshape(c, S_SLAB, R_T, 1)
            rgb = rgb.reshape(c, S_SLAB, R_T, 3)
            tc, ac, bc_c = t_acc[idx], acc[idx], bc[idx]
            for s in range(S_SLAB):
                lastf = 1.0 if (is_last and s == S_SLAB - 1) else 0.0
                # bg-concat on the union's final sample
                ch = rgb[:, s] * (1.0 - lastf) + bc_c * lastf
                sh = sigma[:, s] + 1e-6 * lastf
                alpha = 1.0 - torch.exp(-(sh + 1e-6) * dists[j, s, idx][..., None])
                ac = ac + (alpha * tc) * ch
                tc = tc * (1.0 - alpha + 1e-10)
            t_acc[idx], acc[idx] = tc, ac
    return acc.reshape(-1, 3), slabs


class RenderHeadKernel(_build.Binding):
    """ctypes binding of csrc/render_head.cu."""

    def __init__(self):
        ptr = ctypes.c_void_p
        super().__init__("render_head", {
            "render_head_launch": [ptr] * 13 + [ctypes.c_int] * 3 + [ctypes.c_float, ptr]})

    def __call__(self, ops: HeadOperands) -> Tuple[torch.Tensor, torch.Tensor]:
        """Launch on the current stream. Returns rgb [n_pad, 3] and slabs
        evaluated per tile [n_tiles] (int32)."""
        T, J = ops.n_tiles, ops.n_slabs
        n_pad, S = T * R_T, J * S_SLAB
        if ops.act not in ("relu", "softplus"):
            raise ValueError(f"unknown density activation {ops.act!r}")
        dev = _build.check_cuda_operands("render_head_kernel", {
            "rays_o": (ops.rays_o, (n_pad, 3), torch.float32),
            "rays_d": (ops.rays_d, (n_pad, 3), torch.float32),
            "z": (ops.z, (S, n_pad), torch.float32), "dists": (ops.dists, (S, n_pad), torch.float32),
            "vr": (ops.vr, (n_pad, 256), torch.bfloat16), "bc": (ops.bc, (n_pad, 3), torch.float32),
            "occ": (ops.occ, (T, J), torch.int32)})
        w, b = self.blobs(ops.packed_h, "head", dev)
        freq, phase = _slot_tables(dev)
        out = torch.empty((n_pad, 3), dtype=torch.float32, device=dev)
        slabs = torch.empty((T,), dtype=torch.int32, device=dev)
        self.launch("render_head_launch", dev, ops.rays_o, ops.rays_d, ops.z, ops.dists, ops.vr,
                    ops.bc, freq, phase, ops.occ, w, b, out, slabs, T, J,
                    int(ops.act == "softplus"), ops.ert_eps)
        return out, slabs


render_head_kernel = RenderHeadKernel()


def fused_render_head(packed_h: Dict[str, torch.Tensor], rays_o: torch.Tensor,
                      rays_d: torch.Tensor, z_vals: torch.Tensor, bc_rgb: torch.Tensor,
                      last_dist: float = 1e10, ert_eps: float = 0.0,
                      occupancy: Optional[torch.Tensor] = None, act: str = "relu") -> torch.Tensor:
    """Render n rays through the packed head field at their own depths.

    rays [n, 3] (in spatial-tile order when ``occupancy`` is given); z_vals
    [n, S] sorted per ray, or [S] shared; bc_rgb [n, 3] background pixels;
    occupancy [T, J] flags (all ones when None). Returns rgb [n, 3] float32.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    dev = rays_o.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_render_head runs on cpu or cuda tensors, got {dev}")
    ops = prepare_head_operands(packed_h, rays_o, rays_d, z_vals, bc_rgb, last_dist, ert_eps,
                                occupancy, act)
    if dev.type == "cuda":
        rgb, _ = render_head_kernel(ops)
    else:
        rgb, _ = fused_render_head_reference(ops)
    return rgb[:rays_o.shape[0]]
