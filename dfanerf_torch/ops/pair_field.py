"""One field on its occupied (tile, slab) pairs (port of
dfanerf_tpu/ops/fused_render.py pair_field_eval :1062, pair_field_eval_prepped
:1101 and pair2_field_eval_prepped :1268).

For each listed pair k (tile t_idx[k], slab j_idx[k]) the packed field is
evaluated at the slab's ``s_slab`` samples (8, or the 4-sample half-slabs of
``occ_pack2``) of the tile's 256 rays, and the block [j][s][t * 256 + r] of
four per-sample buffers is written: sigma after the density activation
(float32) and the colour's r, g, b (bfloat16). Each buffer is [n_slabs,
s_slab, (n_tiles + 1) * 256]: the reference's layout, whose last tile row
took its padding pairs. The port lists exactly the occupied pairs, so that
row is never written. Blocks of unlisted pairs are not written either:
callers mask every read with the flags that built the list
(composite.deferred_composite does, with ``where``).

The packed-2 form (``pair2_field_eval_prepped``) takes a field's pair list
split in two disjoint lists, A (pairs 0, 2, 4, ...) and B (1, 3, 5, ...),
and returns one quartet of buffers for each; the composite merges them
under the matching flag partitions.

Two implementations of each over the same operands:

- ``pair_field_kernel`` and ``pair2_field_kernel``: the hand-written CUDA
  kernels of csrc/pair_field.cu (the ports of the Pallas
  ``_pair_field_kernel`` and ``_pair2_field_kernel``), one block per listed
  pair or per A pair, bound with ctypes and built at first launch. Each
  counts its launches in ``.launches``, and per slab size in
  ``.variant_launches`` ("sp4", "sp8"). Both take 4 or 8 samples per slab.
- ``pair_field_eval_reference`` and ``pair2_field_eval_reference``: their
  plain PyTorch versions, with the same bf16 rounding points. Their
  unlisted blocks hold NaN, standing in for the kernels' unwritten memory.

``pair_field_eval_prepped`` and ``pair2_field_eval_prepped`` take the plain
versions only for tensors on the CPU; for CUDA tensors they launch the
kernel or raise. A field with no listed pair returns zero buffers without a
launch (reference :1124-1131, :1295-1302).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from dfanerf_torch.ops import _build
from dfanerf_torch.ops.fused_render import (
    PE_PAD, R_T, S_SLAB, _field_rows, _slot_tables, pe_replicate, view_bias,
)

_REF_PAIRS = 16  # pairs per group in the plain version (bounds its activation memory)
SLAB_SIZES = (4, S_SLAB)  # samples per slab both kernels are built for
PAIR2_SLAB = 4            # pair2's default: the half-slabs of occ_pack2
Buffers = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _slab(s_slab: Optional[int]) -> int:
    sp = S_SLAB if s_slab is None else int(s_slab)
    if sp not in SLAB_SIZES:
        raise ValueError(f"{sp} samples per slab; the kernel takes {SLAB_SIZES}")
    return sp


def _check_operands(branch, rays_o, rays_d, vr, z_vals, t_idx, j_idx, act, sp):
    if branch not in ("head", "torso"):
        raise ValueError(f"unknown branch {branch!r}")
    if act not in ("relu", "softplus"):
        raise ValueError(f"unknown density activation {act!r}")
    n = rays_o.shape[0]
    if n % R_T or z_vals.shape[0] % sp:
        raise ValueError(f"{n} rays and {z_vals.shape[0]} samples must make whole "
                         f"{R_T}-ray tiles and {sp}-sample slabs")
    if t_idx.shape != j_idx.shape or t_idx.ndim != 1:
        raise ValueError(f"pair lists of shapes {tuple(t_idx.shape)} and {tuple(j_idx.shape)}")
    if tuple(vr.shape) != (n, 256):
        raise ValueError(f"view bias {tuple(vr.shape)}, expected {(n, 256)}")


def _check_split(ta, tb):
    """The packed-2 lists: B has as many pairs as A or one fewer."""
    if tb.shape[0] not in (ta.shape[0], ta.shape[0] - 1):
        raise ValueError(f"pair2 lists of {ta.shape[0]} (A) and {tb.shape[0]} (B) pairs: B must "
                         f"have as many as A or one fewer")


def _empty_buffers(J, n_rows, device, fill=None, sp: int = S_SLAB) -> Buffers:
    def buf(dtype):
        shape = (J, sp, n_rows)
        if fill is None:
            return torch.empty(shape, dtype=dtype, device=device)
        return torch.full(shape, fill, dtype=dtype, device=device)

    return buf(torch.float32), buf(torch.bfloat16), buf(torch.bfloat16), buf(torch.bfloat16)


@torch.no_grad()
def pair_field_eval_reference(pw: Dict[str, torch.Tensor], branch: str, rays_o: torch.Tensor,
                              rays_d: torch.Tensor, vr: torch.Tensor, z_vals: torch.Tensor,
                              t_idx: torch.Tensor, j_idx: torch.Tensor,
                              act: str = "relu", s_slab: Optional[int] = None) -> Buffers:
    """Plain PyTorch version of the CUDA kernel: the same operands, the same
    four buffers, NaN in every block that no pair lists."""
    sp = _slab(s_slab)
    _check_operands(branch, rays_o, rays_d, vr, z_vals, t_idx, j_idx, act, sp)
    dev = rays_o.device
    T = rays_o.shape[0] // R_T
    J = z_vals.shape[0] // sp
    bufs = _empty_buffers(J, (T + 1) * R_T, dev, fill=float("nan"), sp=sp)
    views = [b.view(J, sp, T + 1, R_T) for b in bufs]
    o_rep = pe_replicate(rays_o).reshape(T, R_T, PE_PAD)
    d_rep = pe_replicate(rays_d).reshape(T, R_T, PE_PAD)
    vr3 = vr.float().reshape(T, R_T, 256)
    zs = z_vals.float().reshape(J, sp)
    freq, phase = _slot_tables(dev)
    t_all, j_all = t_idx.to(dev).long(), j_idx.to(dev).long()
    for start in range(0, t_all.numel(), _REF_PAIRS):
        ti, ji = t_all[start:start + _REF_PAIRS], j_all[start:start + _REF_PAIRS]
        c = ti.numel()
        pts = o_rep[ti][:, None] + d_rep[ti][:, None] * zs[ji][:, :, None, None]
        x = torch.sin(pts * freq + phase).to(torch.bfloat16).reshape(-1, PE_PAD)
        vr_rows = vr3[ti][:, None].expand(c, sp, R_T, 256).reshape(-1, 256)
        sigma, rgb = _field_rows(pw, x, vr_rows, branch, act)
        views[0][ji, :, ti, :] = sigma.reshape(c, sp, R_T)
        for ch in range(3):
            views[1 + ch][ji, :, ti, :] = rgb[:, ch].reshape(c, sp, R_T).to(torch.bfloat16)
    return bufs


@torch.no_grad()
def pair2_field_eval_reference(pw: Dict[str, torch.Tensor], branch: str, rays_o: torch.Tensor,
                               rays_d: torch.Tensor, vr: torch.Tensor, z_vals: torch.Tensor,
                               ta: torch.Tensor, ja: torch.Tensor, tb: torch.Tensor,
                               jb: torch.Tensor, act: str = "relu",
                               s_slab: int = PAIR2_SLAB) -> Tuple[Buffers, Buffers]:
    """Plain PyTorch version of the packed-2 kernel: the plain single-pair
    version over the A list and over the B list, each into its own quartet
    (NaN in every block its list does not name)."""
    _slab(s_slab)
    _check_split(ta, tb)
    return tuple(pair_field_eval_reference(pw, branch, rays_o, rays_d, vr, z_vals, t, j, act,
                                           s_slab) for t, j in ((ta, ja), (tb, jb)))


def _cuda_operands(name, rays_o, rays_d, vr, z_vals, lists):
    """Device of the kernel operands, checked; lists: name -> index tensor."""
    n, S = rays_o.shape[0], z_vals.shape[0]
    ops = {"rays_o": (rays_o, (n, 3), torch.float32), "rays_d": (rays_d, (n, 3), torch.float32),
           "vr": (vr, (n, 256), torch.bfloat16), "z_vals": (z_vals, (S,), torch.float32)}
    ops.update({k: (x, (x.shape[0],), torch.int32) for k, x in lists.items()})
    return _build.check_cuda_operands(name, ops)


class PairFieldKernel(_build.Binding):
    """ctypes binding of csrc/pair_field.cu's single-pair kernel."""

    def __init__(self):
        ptr = ctypes.c_void_p
        super().__init__("pair_field", {
            "pair_field_launch": [ctypes.c_int] + [ptr] * 14 + [ctypes.c_int] * 4 + [ptr]})

    def __call__(self, pw, branch, rays_o, rays_d, vr, z_vals, t_idx, j_idx,
                 act: str = "relu", s_slab: Optional[int] = None) -> Buffers:
        """Launch on the current stream over the K >= 1 listed pairs."""
        sp = _slab(s_slab)
        _check_operands(branch, rays_o, rays_d, vr, z_vals, t_idx, j_idx, act, sp)
        dev = _cuda_operands("pair_field_kernel", rays_o, rays_d, vr, z_vals,
                             {"t_idx": t_idx, "j_idx": j_idx})
        K = t_idx.shape[0]
        if K == 0:
            raise ValueError("pair_field_kernel needs at least one listed pair")
        w, b = self.blobs(pw, branch, dev)
        n_rows = rays_o.shape[0] + R_T
        bufs = _empty_buffers(z_vals.shape[0] // sp, n_rows, dev, sp=sp)
        freq, phase = _slot_tables(dev)
        self.launch("pair_field_launch", dev, int(branch == "torso"), rays_o, rays_d, z_vals, vr,
                    freq, phase, t_idx, j_idx, w, b, *bufs, K, n_rows,
                    int(act == "softplus"), sp, variant=f"sp{sp}")
        return bufs


class Pair2FieldKernel(_build.Binding):
    """ctypes binding of csrc/pair_field.cu's packed-2 kernel."""

    def __init__(self):
        ptr = ctypes.c_void_p
        super().__init__("pair_field", {
            "pair2_field_launch": [ctypes.c_int] + [ptr] * 20 + [ctypes.c_int] * 5 + [ptr]})

    def __call__(self, pw, branch, rays_o, rays_d, vr, z_vals, ta, ja, tb, jb,
                 act: str = "relu", s_slab: int = PAIR2_SLAB) -> Tuple[Buffers, Buffers]:
        """Launch on the current stream over the A list (>= 1 pair) and the
        B list (as many pairs, or one fewer)."""
        sp = _slab(s_slab)
        for t, j in ((ta, ja), (tb, jb)):
            _check_operands(branch, rays_o, rays_d, vr, z_vals, t, j, act, sp)
        _check_split(ta, tb)
        dev = _cuda_operands("pair2_field_kernel", rays_o, rays_d, vr, z_vals,
                             {"ta": ta, "ja": ja, "tb": tb, "jb": jb})
        if ta.shape[0] == 0:
            raise ValueError("pair2_field_kernel needs at least one listed pair")
        w, b = self.blobs(pw, branch, dev)
        n_rows = rays_o.shape[0] + R_T
        J = z_vals.shape[0] // sp
        bufs_a = _empty_buffers(J, n_rows, dev, sp=sp)
        bufs_b = _empty_buffers(J, n_rows, dev, sp=sp)
        freq, phase = _slot_tables(dev)
        self.launch("pair2_field_launch", dev, int(branch == "torso"), rays_o, rays_d, z_vals, vr,
                    freq, phase, ta, ja, tb, jb, w, b, *bufs_a, *bufs_b, ta.shape[0],
                    tb.shape[0], n_rows, int(act == "softplus"), sp, variant=f"sp{sp}")
        return bufs_a, bufs_b


pair_field_kernel = PairFieldKernel()
pair2_field_kernel = Pair2FieldKernel()


def _device(rays_o: torch.Tensor) -> torch.device:
    dev = rays_o.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"pair_field_eval runs on cpu or cuda tensors, got {dev}")
    return dev


def pair_field_eval_prepped(pw: Dict[str, torch.Tensor], branch: str, rays_o: torch.Tensor,
                            rays_d: torch.Tensor, vr: torch.Tensor, z_vals: torch.Tensor,
                            t_idx: torch.Tensor, j_idx: torch.Tensor,
                            act: str = "relu", s_slab: Optional[int] = None) -> Buffers:
    """One field on its listed pairs, given its view bias.

    rays_o/rays_d [n_tiles * 256, 3] in spatial-tile order; vr [n, 256]
    bf16 (``view_bias`` of rays_d); z_vals [S] shared; t_idx/j_idx [K]
    int32 pair coordinates, each pair listed once, at ``s_slab`` (8 or 4)
    samples per slab. Unlike the reference's operands, the rays are not
    slot-replicated and carry no dummy tile row: the kernel replicates the
    PE slots itself and no padding pair exists. Returns (sigma f32, r, g, b
    bf16), each [n_slabs, s_slab, (n_tiles+1)*256]."""
    sp = _slab(s_slab)
    _check_operands(branch, rays_o, rays_d, vr, z_vals, t_idx, j_idx, act, sp)
    dev = _device(rays_o)
    if t_idx.shape[0] == 0:
        # nothing occupied for this field: the composite masks every block
        return _empty_buffers(z_vals.shape[0] // sp, rays_o.shape[0] + R_T, dev, fill=0.0, sp=sp)
    if dev.type == "cuda":
        return pair_field_kernel(pw, branch, rays_o, rays_d, vr, z_vals, t_idx, j_idx, act, sp)
    return pair_field_eval_reference(pw, branch, rays_o, rays_d, vr, z_vals, t_idx, j_idx, act,
                                     sp)


def pair_field_eval(pw: Dict[str, torch.Tensor], branch: str, rays_o: torch.Tensor,
                    rays_d: torch.Tensor, z_vals: torch.Tensor, t_idx: torch.Tensor,
                    j_idx: torch.Tensor, act: str = "relu",
                    s_slab: Optional[int] = None) -> Buffers:
    """``pair_field_eval_prepped`` with the view bias computed here."""
    vr = view_bias(pw, rays_d).to(torch.bfloat16).contiguous()
    return pair_field_eval_prepped(pw, branch, rays_o, rays_d, vr, z_vals, t_idx, j_idx, act,
                                   s_slab)


def pair2_field_eval_prepped(pw: Dict[str, torch.Tensor], branch: str, rays_o: torch.Tensor,
                             rays_d: torch.Tensor, vr: torch.Tensor, z_vals: torch.Tensor,
                             ta: torch.Tensor, ja: torch.Tensor, tb: torch.Tensor,
                             jb: torch.Tensor, act: str = "relu",
                             s_slab: int = PAIR2_SLAB) -> Tuple[Buffers, Buffers]:
    """The packed-2 evaluation: one field on the A list (ta, ja) and the B
    list (tb, jb), disjoint halves of its pairs, B as long as A or one pair
    shorter (the reference pads B to A's length with a dummy-tile pair; the
    port lists exactly the pairs). Operands as ``pair_field_eval_prepped``.
    Returns (bufs_A, bufs_B), two quartets of [n_slabs, s_slab,
    (n_tiles+1)*256] buffers; composite with ``deferred_composite(...,
    buf_h2=, buf_t2=, occ2=)`` under the matching flag partitions. With no
    pair, two zero quartets and no launch. The kernel is built for
    ``s_slab`` 4 (the half-slabs of occ_pack2, the one path that runs it)
    and 8."""
    sp = _slab(s_slab)
    for t, j in ((ta, ja), (tb, jb)):
        _check_operands(branch, rays_o, rays_d, vr, z_vals, t, j, act, sp)
    _check_split(ta, tb)
    dev = _device(rays_o)
    if ta.shape[0] == 0:
        J, n_rows = z_vals.shape[0] // sp, rays_o.shape[0] + R_T
        return tuple(_empty_buffers(J, n_rows, dev, fill=0.0, sp=sp) for _ in range(2))
    if dev.type == "cuda":
        return pair2_field_kernel(pw, branch, rays_o, rays_d, vr, z_vals, ta, ja, tb, jb, act, sp)
    return pair2_field_eval_reference(pw, branch, rays_o, rays_d, vr, z_vals, ta, ja, tb, jb, act,
                                      sp)


def pair2_field_eval(pw: Dict[str, torch.Tensor], branch: str, rays_o: torch.Tensor,
                     rays_d: torch.Tensor, z_vals: torch.Tensor, ta: torch.Tensor,
                     ja: torch.Tensor, tb: torch.Tensor, jb: torch.Tensor, act: str = "relu",
                     s_slab: int = PAIR2_SLAB) -> Tuple[Buffers, Buffers]:
    """``pair2_field_eval_prepped`` with the view bias computed here."""
    vr = view_bias(pw, rays_d).to(torch.bfloat16).contiguous()
    return pair2_field_eval_prepped(pw, branch, rays_o, rays_d, vr, z_vals, ta, ja, tb, jb, act,
                                    s_slab)
