"""The head field on its occupied (tile, slab) pairs, for the pair-compacted
hierarchical render (port of dfanerf_tpu/ops/fused_render.py
pair_sigma_eval :2189 and pair_field_eval_perz :2290).

- ``pair_sigma_eval`` (the coarse pass): for each listed pair k (tile
  t_idx[k], slab j_idx[k]) the head trunk and its sigma column at the slab's
  8 shared depths of the tile's 256 rays; writes the block [j][s][t * 256 +
  r] of one float32 buffer [n_slabs, 8, (n_tiles + 1) * 256].
- ``pair_field_eval_perz`` (the fine pass): the whole head field at each
  ray's own depths, read from ``z_buf`` in the same blocking; writes the
  four buffers of ops/pair_field.py (sigma float32, r, g, b bfloat16).

Only listed blocks are written: callers mask every read with the flags that
built the list (the resample and ``composite.deferred_composite_head`` do,
with ``where``). The last tile row of each buffer is the reference's target
for padding pairs; the port lists exactly the occupied pairs and never
writes it. An empty list returns zero buffers without a launch (reference
:2210, :2309).

Two implementations of each over the same operands:

- ``pair_sigma_kernel`` and ``pair_field_perz_kernel``: the hand-written
  CUDA kernels of csrc/pair_hier.cu and csrc/pair_perz.cu (both on the
  wgmma core), the ports of the Pallas ``_pair_sigma_kernel`` and
  ``_pair_field_perz_kernel``, one block per listed pair, bound with ctypes
  and built at first launch, each counting its launches in ``.launches``.
- ``pair_sigma_eval_reference`` and ``pair_field_eval_perz_reference``:
  their plain PyTorch versions, with the same bf16 rounding points and NaN
  in every unlisted block, standing in for the kernels' unwritten memory.

The wrappers take the plain versions only for tensors on the CPU; for CUDA
tensors they launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from dfanerf_torch.ops import _build
from dfanerf_torch.ops.fused_render import (
    PE_PAD, R_T, S_SLAB, _field_rows, _slot_tables, pe_replicate, sigma_only, view_bias,
)
from dfanerf_torch.ops.pair_field import _REF_PAIRS, Buffers, _empty_buffers
from dfanerf_torch.ops.sigma_head import sigma_rows


def _check_operands(rays_o, rays_d, t_idx, j_idx, act):
    if act not in ("relu", "softplus"):
        raise ValueError(f"unknown density activation {act!r}")
    n = rays_o.shape[0]
    if n % R_T or tuple(rays_d.shape) != (n, 3):
        raise ValueError(f"rays of shapes {tuple(rays_o.shape)} and {tuple(rays_d.shape)} must "
                         f"make whole {R_T}-ray tiles")
    if t_idx.shape != j_idx.shape or t_idx.ndim != 1:
        raise ValueError(f"pair lists of shapes {tuple(t_idx.shape)} and {tuple(j_idx.shape)}")


def _check_z_buf(z_buf, n):
    if z_buf.ndim != 3 or z_buf.shape[1] != S_SLAB or z_buf.shape[2] != n + R_T:
        raise ValueError(f"z_buf {tuple(z_buf.shape)}, expected (n_slabs, {S_SLAB}, {n + R_T})")


def _pairs(rays_o, rays_d, t_idx, j_idx):
    """Slot-replicated rays [T, 256, 64] and the pair list as int64, in
    groups of _REF_PAIRS: yields (ti, ji, o_rep[ti], d_rep[ti])."""
    T = rays_o.shape[0] // R_T
    o_rep = pe_replicate(rays_o).reshape(T, R_T, PE_PAD)
    d_rep = pe_replicate(rays_d).reshape(T, R_T, PE_PAD)
    t_all, j_all = t_idx.to(rays_o.device).long(), j_idx.to(rays_o.device).long()
    for start in range(0, t_all.numel(), _REF_PAIRS):
        ti, ji = t_all[start:start + _REF_PAIRS], j_all[start:start + _REF_PAIRS]
        yield ti, ji, o_rep[ti], d_rep[ti]


@torch.no_grad()
def pair_sigma_eval_reference(pw: Dict[str, torch.Tensor], rays_o: torch.Tensor,
                              rays_d: torch.Tensor, z_vals: torch.Tensor, t_idx: torch.Tensor,
                              j_idx: torch.Tensor, act: str = "relu") -> torch.Tensor:
    """Plain PyTorch version of the sigma kernel: the same operands, the same
    buffer, NaN in every block that no pair lists."""
    _check_operands(rays_o, rays_d, t_idx, j_idx, act)
    dev = rays_o.device
    T, J = rays_o.shape[0] // R_T, z_vals.shape[0] // S_SLAB
    buf = torch.full((J, S_SLAB, (T + 1) * R_T), float("nan"), device=dev)
    view = buf.view(J, S_SLAB, T + 1, R_T)
    zs = z_vals.float().reshape(J, S_SLAB)
    freq, phase = _slot_tables(dev)
    pw_s = sigma_only(pw)
    for ti, ji, o, d in _pairs(rays_o, rays_d, t_idx, j_idx):
        pts = o[:, None] + d[:, None] * zs[ji][:, :, None, None]
        x = torch.sin(pts * freq + phase).to(torch.bfloat16).reshape(-1, PE_PAD)
        view[ji, :, ti, :] = sigma_rows(pw_s, x, act).reshape(ti.numel(), S_SLAB, R_T)
    return buf


@torch.no_grad()
def pair_field_eval_perz_reference(pw: Dict[str, torch.Tensor], rays_o: torch.Tensor,
                                   rays_d: torch.Tensor, vr: torch.Tensor, z_buf: torch.Tensor,
                                   t_idx: torch.Tensor, j_idx: torch.Tensor,
                                   act: str = "relu") -> Buffers:
    """Plain PyTorch version of the per-ray-depth field kernel: the same
    operands (vr [n, 256] bf16 the view bias of rays_d), the same four
    buffers, NaN in every block that no pair lists."""
    _check_operands(rays_o, rays_d, t_idx, j_idx, act)
    n = rays_o.shape[0]
    _check_z_buf(z_buf, n)
    dev = rays_o.device
    T, J = n // R_T, z_buf.shape[0]
    bufs = _empty_buffers(J, (T + 1) * R_T, dev, fill=float("nan"))
    views = [b.view(J, S_SLAB, T + 1, R_T) for b in bufs]
    zb = z_buf.float().view(J, S_SLAB, T + 1, R_T)
    vr3 = vr.float().reshape(T, R_T, 256)
    freq, phase = _slot_tables(dev)
    for ti, ji, o, d in _pairs(rays_o, rays_d, t_idx, j_idx):
        c = ti.numel()
        pts = o[:, None] + d[:, None] * zb[ji, :, ti, :][..., None]  # [c, 8, R_T, 64]
        x = torch.sin(pts * freq + phase).to(torch.bfloat16).reshape(-1, PE_PAD)
        vr_rows = vr3[ti][:, None].expand(c, S_SLAB, R_T, 256).reshape(-1, 256)
        sigma, rgb = _field_rows(pw, x, vr_rows, "head", act)
        views[0][ji, :, ti, :] = sigma.reshape(c, S_SLAB, R_T)
        for ch in range(3):
            views[1 + ch][ji, :, ti, :] = rgb[:, ch].reshape(c, S_SLAB, R_T).to(torch.bfloat16)
    return bufs


class PairSigmaKernel(_build.Binding):
    """ctypes binding of csrc/pair_hier.cu's pair_sigma."""

    def __init__(self):
        ptr = ctypes.c_void_p
        super().__init__("pair_hier", {"pair_sigma_launch": [ptr] * 10 + [ctypes.c_int] * 3 + [ptr]})

    def __call__(self, pw, rays_o, rays_d, z_vals, t_idx, j_idx, act: str = "relu"):
        """Launch on the current stream over the K >= 1 listed pairs; same
        operands and listed blocks as ``pair_sigma_eval_reference``."""
        _check_operands(rays_o, rays_d, t_idx, j_idx, act)
        n, S, K = rays_o.shape[0], z_vals.shape[0], t_idx.shape[0]
        if K == 0:
            raise ValueError("pair_sigma_kernel needs at least one listed pair")
        dev = _build.check_cuda_operands("pair_sigma_kernel", {
            "rays_o": (rays_o, (n, 3), torch.float32), "rays_d": (rays_d, (n, 3), torch.float32),
            "z_vals": (z_vals, (S,), torch.float32), "t_idx": (t_idx, (K,), torch.int32),
            "j_idx": (j_idx, (K,), torch.int32)})
        w, b = self.blobs(pw, "head", dev)
        freq, phase = _slot_tables(dev)
        buf = torch.empty((S // S_SLAB, S_SLAB, n + R_T), dtype=torch.float32, device=dev)
        self.launch("pair_sigma_launch", dev, rays_o, rays_d, z_vals, freq, phase, t_idx, j_idx, w,
                    b, buf, K, n + R_T, int(act == "softplus"))
        return buf


class PairFieldPerzKernel(_build.Binding):
    """ctypes binding of csrc/pair_perz.cu's pair_field_perz."""

    def __init__(self):
        ptr = ctypes.c_void_p
        super().__init__("pair_perz", {
            "pair_field_perz_launch": [ptr] * 14 + [ctypes.c_int] * 3 + [ptr]})

    def __call__(self, pw, rays_o, rays_d, vr, z_buf, t_idx, j_idx, act: str = "relu") -> Buffers:
        """Launch on the current stream over the K >= 1 listed pairs; same
        operands and listed blocks as ``pair_field_eval_perz_reference``."""
        _check_operands(rays_o, rays_d, t_idx, j_idx, act)
        n, K = rays_o.shape[0], t_idx.shape[0]
        _check_z_buf(z_buf, n)
        if K == 0:
            raise ValueError("pair_field_perz_kernel needs at least one listed pair")
        dev = _build.check_cuda_operands("pair_field_perz_kernel", {
            "rays_o": (rays_o, (n, 3), torch.float32), "rays_d": (rays_d, (n, 3), torch.float32),
            "vr": (vr, (n, 256), torch.bfloat16),
            "z_buf": (z_buf, tuple(z_buf.shape), torch.float32),
            "t_idx": (t_idx, (K,), torch.int32), "j_idx": (j_idx, (K,), torch.int32)})
        w, b = self.blobs(pw, "head", dev)
        freq, phase = _slot_tables(dev)
        bufs = _empty_buffers(z_buf.shape[0], n + R_T, dev)
        self.launch("pair_field_perz_launch", dev, rays_o, rays_d, z_buf, vr, freq, phase, t_idx,
                    j_idx, w, b, *bufs, K, n + R_T, int(act == "softplus"))
        return bufs


pair_sigma_kernel = PairSigmaKernel()
pair_field_perz_kernel = PairFieldPerzKernel()


def _device(rays_o, what):
    dev = rays_o.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {dev}")
    return dev


def pair_sigma_eval(pw: Dict[str, torch.Tensor], rays_o: torch.Tensor, rays_d: torch.Tensor,
                    z_vals: torch.Tensor, t_idx: torch.Tensor, j_idx: torch.Tensor,
                    act: str = "relu") -> torch.Tensor:
    """Head densities on the listed pairs at shared depths.

    rays [n_tiles * 256, 3] in spatial-tile order, z_vals [S], t_idx/j_idx
    [K] int32, each pair listed once. Returns sigma [n_slabs, 8,
    (n_tiles + 1) * 256] float32, written on the listed blocks only."""
    _check_operands(rays_o, rays_d, t_idx, j_idx, act)
    dev = _device(rays_o, "pair_sigma_eval")
    if z_vals.shape[0] % S_SLAB:
        raise ValueError(f"n_samples={z_vals.shape[0]} must be a multiple of {S_SLAB}")
    if t_idx.shape[0] == 0:
        return torch.zeros((z_vals.shape[0] // S_SLAB, S_SLAB, rays_o.shape[0] + R_T), device=dev)
    if dev.type == "cuda":
        return pair_sigma_kernel(pw, rays_o, rays_d, z_vals, t_idx, j_idx, act)
    return pair_sigma_eval_reference(pw, rays_o, rays_d, z_vals, t_idx, j_idx, act)


def pair_field_eval_perz(pw: Dict[str, torch.Tensor], rays_o: torch.Tensor,
                         rays_d: torch.Tensor, z_buf: torch.Tensor, t_idx: torch.Tensor,
                         j_idx: torch.Tensor, act: str = "relu") -> Buffers:
    """The head field on the listed pairs at each ray's own depths.

    rays [n_tiles * 256, 3] in spatial-tile order; z_buf [n_slabs, 8,
    (n_tiles + 1) * 256] float32, the depths in the outputs' blocking;
    t_idx/j_idx [K] int32, each pair listed once. Returns (sigma f32, r, g,
    b bf16), each like z_buf, written on the listed blocks only."""
    _check_operands(rays_o, rays_d, t_idx, j_idx, act)
    _check_z_buf(z_buf, rays_o.shape[0])
    dev = _device(rays_o, "pair_field_eval_perz")
    if t_idx.shape[0] == 0:
        return _empty_buffers(z_buf.shape[0], rays_o.shape[0] + R_T, dev, fill=0.0)
    vr = view_bias(pw, rays_d).to(torch.bfloat16).contiguous()
    if dev.type == "cuda":
        return pair_field_perz_kernel(pw, rays_o, rays_d, vr, z_buf, t_idx, j_idx, act)
    return pair_field_eval_perz_reference(pw, rays_o, rays_d, vr, z_buf, t_idx, j_idx, act)
