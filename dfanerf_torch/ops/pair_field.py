"""One field on its occupied (tile, slab) pairs (port of
dfanerf_tpu/ops/fused_render.py pair_field_eval :1062 and
pair_field_eval_prepped :1101).

For each listed pair k (tile t_idx[k], slab j_idx[k]) the packed field is
evaluated at the slab's 8 samples of the tile's 256 rays, and the block
[j][s][t * 256 + r] of four per-sample buffers is written: sigma after the
density activation (float32) and the colour's r, g, b (bfloat16). Each
buffer is [n_slabs, 8, (n_tiles + 1) * 256]: the reference's layout, whose
last tile row took its padding pairs. The port lists exactly the occupied
pairs, so that row is never written. Blocks of unlisted pairs are not
written either: callers mask every read with the flags that built the list
(composite.deferred_composite does, with ``where``).

Two implementations over the same operands:

- ``pair_field_kernel``: the hand-written CUDA kernel csrc/pair_field.cu
  (the port of the Pallas ``_pair_field_kernel``), one block per listed
  pair, bound with ctypes and built at first launch. It counts its launches
  in ``pair_field_kernel.launches``.
- ``pair_field_eval_reference``: its plain PyTorch version, with the same
  bf16 rounding points. Its unlisted blocks hold NaN, standing in for the
  kernel's unwritten memory.

``pair_field_eval_prepped`` takes the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises. A field with no
listed pair returns zero buffers without a launch (reference :1124-1131).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from dfanerf_torch.ops import _build
from dfanerf_torch.ops.fused_render import (
    PE_PAD, R_T, S_SLAB, _field_rows, _slot_tables, pe_replicate, view_bias,
)

_REF_PAIRS = 16  # pairs per group in the plain version (bounds its activation memory)
Buffers = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _check_operands(branch, rays_o, rays_d, vr, z_vals, t_idx, j_idx, act):
    if branch not in ("head", "torso"):
        raise ValueError(f"unknown branch {branch!r}")
    if act not in ("relu", "softplus"):
        raise ValueError(f"unknown density activation {act!r}")
    n = rays_o.shape[0]
    if n % R_T or z_vals.shape[0] % S_SLAB:
        raise ValueError(f"{n} rays and {z_vals.shape[0]} samples must make whole "
                         f"{R_T}-ray tiles and {S_SLAB}-sample slabs")
    if t_idx.shape != j_idx.shape or t_idx.ndim != 1:
        raise ValueError(f"pair lists of shapes {tuple(t_idx.shape)} and {tuple(j_idx.shape)}")
    if tuple(vr.shape) != (n, 256):
        raise ValueError(f"view bias {tuple(vr.shape)}, expected {(n, 256)}")


def _empty_buffers(J, n_rows, device, fill=None) -> Buffers:
    def buf(dtype):
        shape = (J, S_SLAB, n_rows)
        if fill is None:
            return torch.empty(shape, dtype=dtype, device=device)
        return torch.full(shape, fill, dtype=dtype, device=device)

    return buf(torch.float32), buf(torch.bfloat16), buf(torch.bfloat16), buf(torch.bfloat16)


@torch.no_grad()
def pair_field_eval_reference(pw: Dict[str, torch.Tensor], branch: str, rays_o: torch.Tensor,
                              rays_d: torch.Tensor, vr: torch.Tensor, z_vals: torch.Tensor,
                              t_idx: torch.Tensor, j_idx: torch.Tensor,
                              act: str = "relu") -> Buffers:
    """Plain PyTorch version of the CUDA kernel: the same operands, the same
    four buffers, NaN in every block that no pair lists."""
    _check_operands(branch, rays_o, rays_d, vr, z_vals, t_idx, j_idx, act)
    dev = rays_o.device
    T = rays_o.shape[0] // R_T
    J = z_vals.shape[0] // S_SLAB
    bufs = _empty_buffers(J, (T + 1) * R_T, dev, fill=float("nan"))
    views = [b.view(J, S_SLAB, T + 1, R_T) for b in bufs]
    o_rep = pe_replicate(rays_o).reshape(T, R_T, PE_PAD)
    d_rep = pe_replicate(rays_d).reshape(T, R_T, PE_PAD)
    vr3 = vr.float().reshape(T, R_T, 256)
    zs = z_vals.float().reshape(J, S_SLAB)
    freq, phase = _slot_tables(dev)
    t_all, j_all = t_idx.to(dev).long(), j_idx.to(dev).long()
    for start in range(0, t_all.numel(), _REF_PAIRS):
        ti, ji = t_all[start:start + _REF_PAIRS], j_all[start:start + _REF_PAIRS]
        c = ti.numel()
        pts = o_rep[ti][:, None] + d_rep[ti][:, None] * zs[ji][:, :, None, None]
        x = torch.sin(pts * freq + phase).to(torch.bfloat16).reshape(-1, PE_PAD)
        vr_rows = vr3[ti][:, None].expand(c, S_SLAB, R_T, 256).reshape(-1, 256)
        sigma, rgb = _field_rows(pw, x, vr_rows, branch, act)
        views[0][ji, :, ti, :] = sigma.reshape(c, S_SLAB, R_T)
        for ch in range(3):
            views[1 + ch][ji, :, ti, :] = rgb[:, ch].reshape(c, S_SLAB, R_T).to(torch.bfloat16)
    return bufs


class PairFieldKernel(_build.Binding):
    """ctypes binding of csrc/pair_field.cu."""

    def __init__(self):
        ptr = ctypes.c_void_p
        super().__init__("pair_field", {
            "pair_field_launch": [ctypes.c_int] + [ptr] * 14 + [ctypes.c_int] * 3 + [ptr]})

    def __call__(self, pw, branch, rays_o, rays_d, vr, z_vals, t_idx, j_idx,
                 act: str = "relu") -> Buffers:
        """Launch on the current stream over the K >= 1 listed pairs."""
        _check_operands(branch, rays_o, rays_d, vr, z_vals, t_idx, j_idx, act)
        n, S, K = rays_o.shape[0], z_vals.shape[0], t_idx.shape[0]
        dev = _build.check_cuda_operands("pair_field_kernel", {
            "rays_o": (rays_o, (n, 3), torch.float32), "rays_d": (rays_d, (n, 3), torch.float32),
            "vr": (vr, (n, 256), torch.bfloat16), "z_vals": (z_vals, (S,), torch.float32),
            "t_idx": (t_idx, (K,), torch.int32), "j_idx": (j_idx, (K,), torch.int32)})
        if K == 0:
            raise ValueError("pair_field_kernel needs at least one listed pair")
        w, b = self.blobs(pw, branch, dev)
        T = n // R_T
        bufs = _empty_buffers(S // S_SLAB, (T + 1) * R_T, dev)
        freq, phase = _slot_tables(dev)
        self.launch("pair_field_launch", dev, int(branch == "torso"), rays_o, rays_d, z_vals, vr,
                    freq, phase, t_idx, j_idx, w, b, *bufs, K, (T + 1) * R_T,
                    int(act == "softplus"))
        return bufs


pair_field_kernel = PairFieldKernel()


def pair_field_eval_prepped(pw: Dict[str, torch.Tensor], branch: str, rays_o: torch.Tensor,
                            rays_d: torch.Tensor, vr: torch.Tensor, z_vals: torch.Tensor,
                            t_idx: torch.Tensor, j_idx: torch.Tensor,
                            act: str = "relu") -> Buffers:
    """One field on its listed pairs, given its view bias.

    rays_o/rays_d [n_tiles * 256, 3] in spatial-tile order; vr [n, 256]
    bf16 (``view_bias`` of rays_d); z_vals [S] shared; t_idx/j_idx [K]
    int32 pair coordinates, each pair listed once. Unlike the reference's
    operands, the rays are not slot-replicated and carry no dummy tile row:
    the kernel replicates the PE slots itself and no padding pair exists.
    Returns (sigma f32, r, g, b bf16), each [n_slabs, 8, (n_tiles+1)*256]."""
    _check_operands(branch, rays_o, rays_d, vr, z_vals, t_idx, j_idx, act)
    dev = rays_o.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"pair_field_eval runs on cpu or cuda tensors, got {dev}")
    if t_idx.shape[0] == 0:
        # nothing occupied for this field: the composite masks every block
        return _empty_buffers(z_vals.shape[0] // S_SLAB, rays_o.shape[0] + R_T, dev, fill=0.0)
    if dev.type == "cuda":
        return pair_field_kernel(pw, branch, rays_o, rays_d, vr, z_vals, t_idx, j_idx, act)
    return pair_field_eval_reference(pw, branch, rays_o, rays_d, vr, z_vals, t_idx, j_idx, act)


def pair_field_eval(pw: Dict[str, torch.Tensor], branch: str, rays_o: torch.Tensor,
                    rays_d: torch.Tensor, z_vals: torch.Tensor, t_idx: torch.Tensor,
                    j_idx: torch.Tensor, act: str = "relu") -> Buffers:
    """``pair_field_eval_prepped`` with the view bias computed here."""
    vr = view_bias(pw, rays_d).to(torch.bfloat16).contiguous()
    return pair_field_eval_prepped(pw, branch, rays_o, rays_d, vr, z_vals, t_idx, j_idx, act)
