"""Density-only head forward: the coarse pass of the hierarchical head render
(port of dfanerf_tpu/ops/fused_render.py fused_sigma_head :873).

For every ray of a 256-ray tile and every sample of each 8-sample slab whose
occupancy flag is set, the frame-folded head field (ops/pack.py) runs its
trunk and the sigma column of its fused output layer: sigma [n, S] float32
after the density activation. Slabs whose flag is clear read exactly 0,
which is exact for the importance resample that consumes them (zero
density, zero weight). No view or colour head runs.

Two implementations over the same operands:

- ``sigma_head_kernel``: the hand-written CUDA kernel csrc/sigma_head.cu
  (the port of the Pallas ``_sigma_kernel``, on the wgmma core), one block
  per (tile, slab), bound with ctypes and built at first launch. It counts its launches in
  ``sigma_head_kernel.launches``.
- ``fused_sigma_head_reference``: its plain PyTorch version, with the same
  bf16 rounding points.

``fused_sigma_head`` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from dfanerf_torch.ops import _build
from dfanerf_torch.ops.fused_render import (
    PE_PAD, R_T, S_SLAB, _REF_TILES, _encode, _mm_kernel, _slot_tables, _trunk, density_act,
    pe_replicate, sigma_only,
)


def _check_act(act: str) -> None:
    if act not in ("relu", "softplus"):
        raise ValueError(f"unknown density activation {act!r}")


def sigma_rows(pw_sigma: Dict[str, torch.Tensor], x_bf16: torch.Tensor, act: str) -> torch.Tensor:
    """Kernel-semantics density over flat rows of bf16 encodings [N, 64]:
    the trunk, the sigma column (``sigma_only`` weights), the activation."""
    return density_act(_trunk(pw_sigma, x_bf16, _mm_kernel)[:, 0], act)


@torch.no_grad()
def fused_sigma_head_reference(pw: Dict[str, torch.Tensor], rays_o: torch.Tensor,
                               rays_d: torch.Tensor, z_vals: torch.Tensor, occ: torch.Tensor,
                               act: str = "relu") -> torch.Tensor:
    """Plain PyTorch version of the CUDA kernel: rays [T * 256, 3], z_vals
    [S], flags occ [T, J] -> sigma [T * 256, S], zero in clear slabs."""
    _check_act(act)
    T, J = occ.shape
    dev = rays_o.device
    freq, phase = _slot_tables(dev)
    o_rep = pe_replicate(rays_o).reshape(T, R_T, PE_PAD)
    d_rep = pe_replicate(rays_d).reshape(T, R_T, PE_PAD)
    pw_s = sigma_only(pw)
    out = torch.zeros((T, R_T, J, S_SLAB), device=dev)
    for j in range(J):
        tiles = occ[:, j].nonzero()[:, 0]
        z = z_vals[j * S_SLAB:(j + 1) * S_SLAB].float()
        for start in range(0, tiles.numel(), _REF_TILES):
            idx = tiles[start:start + _REF_TILES]
            x = _encode(o_rep[idx], d_rep[idx], z, freq, phase).reshape(-1, PE_PAD)
            sigma = sigma_rows(pw_s, x, act).reshape(idx.numel(), S_SLAB, R_T)
            out[idx, :, j, :] = sigma.transpose(1, 2)
    return out.reshape(T * R_T, J * S_SLAB)


class SigmaHeadKernel(_build.Binding):
    """ctypes binding of csrc/sigma_head.cu."""

    def __init__(self):
        ptr = ctypes.c_void_p
        super().__init__("sigma_head", {
            "sigma_head_launch": [ptr] * 9 + [ctypes.c_int] * 3 + [ptr]})

    def __call__(self, pw, rays_o, rays_d, z_vals, occ, act: str = "relu") -> torch.Tensor:
        """Launch on the current stream; same operands and result as
        ``fused_sigma_head_reference``."""
        _check_act(act)
        T, J = occ.shape
        n_pad, S = T * R_T, J * S_SLAB
        dev = _build.check_cuda_operands("sigma_head_kernel", {
            "rays_o": (rays_o, (n_pad, 3), torch.float32),
            "rays_d": (rays_d, (n_pad, 3), torch.float32),
            "z_vals": (z_vals, (S,), torch.float32), "occ": (occ, (T, J), torch.int32)})
        w, b = self.blobs(pw, "head", dev)
        freq, phase = _slot_tables(dev)
        out = torch.empty((n_pad, S), dtype=torch.float32, device=dev)
        self.launch("sigma_head_launch", dev, rays_o, rays_d, z_vals, freq, phase, occ, w, b, out,
                    T, J, int(act == "softplus"))
        return out


sigma_head_kernel = SigmaHeadKernel()


def fused_sigma_head(packed_h: Dict[str, torch.Tensor], rays_o: torch.Tensor,
                     rays_d: torch.Tensor, z_vals: torch.Tensor,
                     occupancy: Optional[torch.Tensor] = None, act: str = "relu") -> torch.Tensor:
    """Density-only head forward: rays [n, 3] (in spatial-tile order when
    ``occupancy`` is given), z_vals [S] shared, occupancy [T, J] flags (all
    ones when None) -> sigma [n, S] float32 after the density activation,
    zero in every slab whose flag is clear."""
    n, S = rays_o.shape[0], z_vals.shape[0]
    if S % S_SLAB:
        raise ValueError(f"n_samples={S} must be a multiple of {S_SLAB}")
    dev = rays_o.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_sigma_head runs on cpu or cuda tensors, got {dev}")
    T, J = -(-n // R_T), S // S_SLAB
    pad = T * R_T - n

    def padded(x):
        x = x.to(device=dev, dtype=torch.float32)
        return torch.cat([x, x.new_zeros((pad, 3))]).contiguous()

    ro, rd = padded(rays_o), padded(rays_d)
    z = z_vals.to(device=dev, dtype=torch.float32).contiguous()
    if occupancy is None:
        occ = torch.ones((T, J), dtype=torch.int32, device=dev)
    else:
        occ = occupancy.to(device=dev, dtype=torch.int32).contiguous()
        if tuple(occ.shape) != (T, J):
            raise ValueError(f"occupancy shape {tuple(occ.shape)} != {(T, J)}")
    if dev.type == "cuda":
        sigma = sigma_head_kernel(packed_h, ro, rd, z, occ, act)
    else:
        sigma = fused_sigma_head_reference(packed_h, ro, rd, z, occ, act)
    return sigma[:n]
