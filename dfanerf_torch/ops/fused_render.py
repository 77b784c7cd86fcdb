"""Fused head+torso volume render (port of fused_render_rays and
_render_kernel of dfanerf_tpu/ops/fused_render.py :167-346, :610-802).

``fused_render_rays`` renders n rays through both frame-folded fields
(ops/pack.py), or one of them (``fields``), and composites the head-only and
composite stacks in fp32, with early ray termination on the 256-ray tile's
max transmittance (``ert_eps``) and per-(tile, slab) occupancy flags. The
background concat at the final sample runs in the kernel, or, with
``bg_epilogue``, in a per-ray epilogue (``composite._bg_epilogue``) after a
kernel that returns its accumulators and transmittances. Matrix inputs are
bf16 with fp32 accumulation; PE phases, densities, alphas and transmittances
stay fp32.

Two implementations of one function, over the same prepared operands
(``prepare_render_operands``):

- ``render_rays_kernel``: the hand-written CUDA kernel csrc/render_rays.cu
  (the port of the Pallas ``_render_kernel``), bound with ctypes and built at
  first launch. It counts its launches in ``render_rays_kernel.launches``.
- ``fused_render_rays_reference``: its plain PyTorch version, with the same
  bf16 rounding points and the same per-tile ERT/occupancy and compositing
  recurrences.

``fused_render_rays`` takes the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises. Every combination of
``fields`` and ``bg_epilogue`` has its instantiation (``RENDER_VARIANTS``);
a single field with the background in the kernel is one that no renderer
runs. The occupancy flags are ops/occupancy.py's.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dfanerf_torch.core.posenc import sincos_posenc
from dfanerf_torch.ops import _build

TILE = 16      # a ray tile is a TILE x TILE pixel block
R_T = TILE * TILE  # rays per tile
S_SLAB = 8     # samples per slab
PE_PAD = 64    # padded PE width
_REF_TILES = 16  # tiles per group in the plain version (bounds its activation memory)
# fused_render_rays_reference's group on the card, where its time is the
# launches of its per-sample compositing ops rather than memory
_REF_TILES_CUDA = 64

# PE-slot replication: slot c of the 64-wide encoding reads coordinate c % 3
# at frequency pi * 2**(c // 6) / 2 (the decoder's downscale of 2 folded in),
# with a +pi/2 phase on the cos half of each frequency block, so the whole
# positional encoding is one sin((o + d z) * freq + phase). Slots 60:64 are
# zero. float32 values, equal to the reference package's.
_SLOT = np.arange(PE_PAD)
_SLOT_VALID = (_SLOT < 60).astype(np.float32)
_PE_COORD = _SLOT % 3
_PE_FREQ = (np.float32(np.pi) * (2.0 ** (_SLOT // 6)).astype(np.float32)
            / np.float32(2.0) * _SLOT_VALID).astype(np.float32)
_PE_PHASE = (np.where(_SLOT % 6 >= 3, np.float32(np.pi / 2.0), np.float32(0.0))
             * _SLOT_VALID).astype(np.float32)


# ---------------------------------------------------------------------------
# Packed-weights forward in plain PyTorch
# ---------------------------------------------------------------------------


def _mm_widened(dtype):
    """x @ w with both operands rounded to ``dtype``, then widened to a
    float32 product (bf16 x bf16 products are exact in fp32)."""
    def mm(x, w):
        return x.to(dtype).float() @ w.to(dtype).float()
    return mm


def _mm_cast(dtype):
    """x @ w with both operands rounded to ``dtype`` and fp32 accumulation.
    On CUDA, bf16 operands go to the tensor cores with a float32 result, as
    the reference's ``preferred_element_type=float32`` dots; the CPU has no
    such product, so there they are widened (``_mm_widened``)."""
    widened = _mm_widened(dtype)

    def mm(x, w):
        if dtype == torch.bfloat16 and x.is_cuda:
            return torch.mm(x.to(dtype), w.to(dtype), out_dtype=torch.float32)
        return widened(x, w)
    return mm


def _mm_kernel(x, w):
    """The kernel's products: activations rounded to bf16, weights as packed."""
    return x.to(torch.bfloat16).float() @ w.float()


def _trunk(pw: Dict[str, torch.Tensor], x, mm) -> torch.Tensor:
    """Shared trunk: x [N, 64|128] -> sf [N, 384] (sigma col 0, view feature
    cols 128:384). Activations enter each product through ``mm``, whose
    fresh result takes the bias and relu in place."""
    h = mm(x, pw["w_in"]).add_(pw["b_in"]).relu_()
    for i in range(pw["w_blocks"].shape[0]):
        h = mm(h, pw["w_blocks"][i]).add_(pw["b_blocks"][i]).relu_()
        if i == 3:
            h = h + mm(x, pw["w_skip"]) + pw["b_skip"]
    return mm(h, pw["w_sf"]) + pw["b_sf"]


def sigma_only(pw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The packed field with its fused output layer cut to the sigma column
    (for _trunk where only the density is needed)."""
    return dict(pw, w_sf=pw["w_sf"][:, :1], b_sf=pw["b_sf"][:1])


def _deform(pw: Dict[str, torch.Tensor], pe, mm) -> torch.Tensor:
    """Torso deformation (packed block-diagonal): pe [N, 64] -> p' [N, 128]."""
    h = mm(pe, pw["d_w1"]).add_(pw["d_b1"]).relu_()
    for i in range(pw["d_wk"].shape[0]):
        h = mm(h, pw["d_wk"][i]).add_(pw["d_bk"][i]).relu_()
        if i == 2:
            h = h + mm(pe, pw["d_wskip"]) + pw["d_bskip"]
    d = mm(h, pw["d_wout"]) + pw["d_bout"]
    pe128 = torch.cat([pe, torch.zeros_like(pe)], dim=-1).float()
    return d + pw["sig_pad"] + pe128


def packed_field(
    pw: Dict[str, torch.Tensor],
    pts: torch.Tensor,
    view_bias: torch.Tensor,
    branch: str,
    dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One packed field at points pts [N, 3]; view_bias [N, 256] (fc_view of
    the per-ray dirs). Returns rgb [N, 3] and raw sigma [N]."""
    pe = sincos_posenc(pts.float(), 10, 2.0)
    pe = torch.cat([pe, pe.new_zeros((pe.shape[0], PE_PAD - pe.shape[1]))], dim=-1)
    mm = _mm_cast(dtype)
    x = _deform(pw, pe, mm) if branch == "torso" else pe
    sf = _trunk(pw, x, mm)
    net = torch.relu(sf[:, 128:384] + view_bias)
    rgb = mm(net, pw["w_out"]) + pw["b_out"]
    return torch.sigmoid(rgb[:, :3]), sf[:, 0]


def view_bias(pw: Dict[str, torch.Tensor], rays_d: torch.Tensor) -> torch.Tensor:
    """Per-ray fc_view(PE(normalized dir)) + b, computed once per ray."""
    d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    enc = sincos_posenc(d.float(), 4, 2.0)
    return enc @ pw["w_view"] + pw["b_view"]


def density_act(x: torch.Tensor, act: str = "relu") -> torch.Tensor:
    """The decoder's density activation: 'relu' (the reference's) or
    'softplus' (stable max + log1p form). The max is torch.maximum, whose
    gradient at x == 0 is half, as jnp.maximum's is (clamp_min passes all
    of it); bf16 densities land on 0 exactly, where the composite blend's
    gradient is largest."""
    zero = x.new_zeros(())
    if act == "softplus":
        return torch.maximum(x, zero) + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.maximum(x, zero)


def spatial_tile_permutation(H: int, W: int) -> torch.Tensor:
    """Flat pixel indices reordered into TILE x TILE blocks, one block per
    ray tile, row-major within a block; edge blocks clamp coordinates.
    Position k in tile order reads pixel perm[k]. Returns an int64 CPU
    tensor of length Hp * Wp."""
    hb = -(-H // TILE)
    wb = -(-W // TILE)
    by, bx = np.meshgrid(np.arange(hb), np.arange(wb), indexing="ij")
    iy, ix = np.meshgrid(np.arange(TILE), np.arange(TILE), indexing="ij")
    y = np.minimum(by[:, :, None, None] * TILE + iy[None, None], H - 1)
    x = np.minimum(bx[:, :, None, None] * TILE + ix[None, None], W - 1)
    return torch.from_numpy((y * W + x).reshape(-1).astype(np.int64))


def spatial_untile(v: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Undo the gather of ``spatial_tile_permutation``: v [Hp * Wp, C] in
    tile order -> [H, W, C] (the edge-clamped copies are dropped)."""
    hb = -(-H // TILE)
    wb = -(-W // TILE)
    return v.reshape(hb, wb, TILE, TILE, -1).permute(0, 2, 1, 3, 4).reshape(
        hb * TILE, wb * TILE, -1)[:H, :W]


# ---------------------------------------------------------------------------
# Operands shared by the kernel and its plain version
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RenderOperands:
    """Padded per-ray inputs of the dense render, n_pad = n_tiles * 256."""

    rays_o: torch.Tensor     # [n_pad, 3] f32, head camera
    rays_d: torch.Tensor
    rays_o_t: torch.Tensor   # [n_pad, 3] f32, torso camera
    rays_d_t: torch.Tensor
    z_vals: torch.Tensor     # [S] f32
    dists_h: torch.Tensor    # [S, n_pad] f32: diff(z) * |d| (last: last_dist * |d|, 0 in
    dists_t: torch.Tensor    # epilogue mode)
    vr_h: torch.Tensor       # [n_pad, 256] bf16 view bias
    vr_t: torch.Tensor
    bc: torch.Tensor         # [n_pad, 3] f32 background pixel
    occ: torch.Tensor        # [n_tiles, n_slabs] int32 (nonzero = evaluate)
    packed_h: Dict[str, torch.Tensor]
    packed_t: Dict[str, torch.Tensor]
    ert_eps: float
    act: str
    bg_epilogue: bool = False  # the final sample is the caller's per-ray epilogue
    fields: str = "both"       # "both", "head" or "torso": the fields evaluated

    @property
    def n_tiles(self) -> int:
        return self.occ.shape[0]

    @property
    def n_slabs(self) -> int:
        return self.occ.shape[1]


FIELDS = ("both", "head", "torso")


def prepare_render_operands(
    packed_h, packed_t, rays_o, rays_d, rays_o_t, rays_d_t, z_vals, bc_rgb,
    last_dist: float = 1e10, ert_eps: float = 0.0,
    occupancy: Optional[torch.Tensor] = None, act: str = "relu",
    bg_epilogue: bool = False, fields: str = "both",
) -> RenderOperands:
    """Pad the rays to whole tiles and build the per-ray operands: sample
    distances, view biases (bf16) and the joint occupancy flags. With
    ``bg_epilogue`` the last interval's distance is 0 (reference
    ``dists_for`` :687), so the final sample in the kernel is an exact no-op:
    alpha = 1 - exp(0) = 0."""
    n = rays_o.shape[0]
    S = z_vals.shape[0]
    if S % S_SLAB:
        raise ValueError(f"n_samples={S} must be a multiple of {S_SLAB}")
    if fields not in FIELDS:
        raise ValueError(f"fields must be one of {FIELDS}, got {fields!r}")
    n_slabs = S // S_SLAB
    n_tiles = -(-n // R_T)
    n_pad = n_tiles * R_T
    dev = rays_o.device

    def padded(x):
        x = x.to(device=dev, dtype=torch.float32)
        return torch.cat([x, x.new_zeros((n_pad - n,) + tuple(x.shape[1:]))], dim=0).contiguous()

    rays_o, rays_d = padded(rays_o), padded(rays_d)
    rays_o_t, rays_d_t = padded(rays_o_t), padded(rays_d_t)
    bc = padded(bc_rgb)
    z = z_vals.to(device=dev, dtype=torch.float32)
    # new_full, not new_tensor: a host-to-device copy would synchronize the frame
    diffs = torch.cat([z[1:] - z[:-1], z.new_full((1,), 0.0 if bg_epilogue else last_dist)])

    def dists_for(rd):
        return (diffs[None, :] * torch.linalg.norm(rd, dim=-1, keepdim=True)).t().contiguous()

    if occupancy is None:
        occ = torch.ones((n_tiles, n_slabs), dtype=torch.int32, device=dev)
    else:
        occ = occupancy.to(dev)
        if occ.ndim == 3:
            # per-field [2, T, J] flags -> joint: a slab runs when either
            # field is occupied
            occ = occ.amax(dim=0)
        if tuple(occ.shape) != (n_tiles, n_slabs):
            raise ValueError(f"occupancy shape {tuple(occ.shape)} != {(n_tiles, n_slabs)}")
        occ = occ.to(torch.int32).contiguous()
    return RenderOperands(
        rays_o=rays_o, rays_d=rays_d, rays_o_t=rays_o_t, rays_d_t=rays_d_t,
        z_vals=z.contiguous(), dists_h=dists_for(rays_d), dists_t=dists_for(rays_d_t),
        vr_h=view_bias(packed_h, rays_d).to(torch.bfloat16).contiguous(),
        vr_t=view_bias(packed_t, rays_d_t).to(torch.bfloat16).contiguous(),
        bc=bc, occ=occ, packed_h=packed_h, packed_t=packed_t,
        ert_eps=float(ert_eps), act=act, bg_epilogue=bool(bg_epilogue), fields=fields,
    )


# ---------------------------------------------------------------------------
# The plain PyTorch version
# ---------------------------------------------------------------------------


_TABLES: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}


def _tables(device) -> Tuple[torch.Tensor, ...]:
    """(freq, phase, coord, valid) slot tables on ``device``, copied there
    once: a per-frame host-to-device copy would stall the frame loop."""
    device = torch.device(device if device is not None else "cpu")
    if device not in _TABLES:
        _TABLES[device] = tuple(torch.from_numpy(t).to(device)
                                for t in (_PE_FREQ, _PE_PHASE, _PE_COORD, _SLOT_VALID))
    return _TABLES[device]


def _slot_tables(device):
    return _tables(device)[:2]


def pe_replicate(rays: torch.Tensor) -> torch.Tensor:
    """PE-slot replication (reference: fused_render.py pe_replicate :1042):
    [n, 3] -> [n, 64] float32, slot c holding coordinate c % 3, zero past
    the 60 valid slots."""
    _, _, coord, valid = _tables(rays.device)
    return rays[:, coord].float() * valid


def pe_freq_phase(device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The [1, 64] frequency and phase rows matching pe_replicate
    (reference: pe_freq_phase :1052)."""
    freq, phase = _slot_tables(device)
    return freq[None], phase[None]


def _encode(o_rep, d_rep, z, freq, phase):
    """o_rep/d_rep [c, R_T, 64] slot-replicated rays, z [8] -> bf16
    [c, 8, R_T, 64] encodings (sample-major rows, as in the kernel)."""
    pts = o_rep[:, None] + d_rep[:, None] * z[None, :, None, None]
    return torch.sin(pts * freq + phase).to(torch.bfloat16)


def _field_rows(pw, x_bf16, vr_rows, branch, act):
    """Kernel-semantics field over flat rows: x [N, 64] bf16 encodings,
    vr_rows [N, 256] f32 -> (sigma [N], rgb [N, 3])."""
    x = x_bf16
    if branch == "torso":
        x = _deform(pw, x_bf16, _mm_kernel)
    sf = _trunk(pw, x, _mm_kernel)
    net = torch.relu(sf[:, 128:384] + vr_rows)
    rgb = torch.sigmoid(_mm_kernel(net, pw["w_out"]) + pw["b_out"])[:, :3]
    return density_act(sf[:, 0], act), rgb


@torch.no_grad()
def fused_render_rays_reference(ops: RenderOperands) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the CUDA kernel over the same operands.

    With the background concat in the kernel, returns rgb_head [n_pad, 3],
    rgb_com [n_pad, 3] (fp32), the number of slabs evaluated per tile
    [n_tiles] (int32), the head density at the final sample [n_pad] and the
    composite's transmittance before the final sample [n_pad] (fp32). These
    two condition the composite's last sample: its blend (sh * bc + 1e-6 *
    ct) / (sh + 1e-6) swings between background and torso colour with a tiny
    change of sh where sh is near zero, and that sample's colour carries the
    transmittance's share of the pixel.

    In epilogue mode (``ops.bg_epilogue``) the last slab is not forced and no
    sample gets the background rules (reference :246-247, :306-308); returns
    the accumulators acc_head, acc_com [n_pad, 3], the slab counts and the
    transmittances t_head, t_com [n_pad] that the epilogue closes (the TPU
    kernel packs these into lane 3 of its outputs, :341-346). A tile whose
    flags are all zero runs no slab: acc 0, t 1, count 0.

    A field left out by ``ops.fields`` contributes sigma 0 and rgb 0 to both
    stacks, and the composite still runs on it (:291-294): its +1e-6 density
    bump still decays the transmittance, and ERT still takes the max over
    both stacks."""
    T, J = ops.n_tiles, ops.n_slabs
    dev = ops.rays_o.device
    freq, phase = _slot_tables(dev)
    eval_h, eval_t = ops.fields in ("both", "head"), ops.fields in ("both", "torso")
    bg_in_kernel = not ops.bg_epilogue
    group = _REF_TILES_CUDA if dev.type == "cuda" else _REF_TILES

    def rep(r):  # [n_pad, 3] -> [T, R_T, 64]
        return pe_replicate(r).reshape(T, R_T, PE_PAD)

    o_h, d_h, o_t, d_t = rep(ops.rays_o), rep(ops.rays_d), rep(ops.rays_o_t), rep(ops.rays_d_t)
    vr_h = ops.vr_h.float().reshape(T, R_T, 256)
    vr_t = ops.vr_t.float().reshape(T, R_T, 256)
    bc = ops.bc.reshape(T, R_T, 3)
    dists_h = ops.dists_h.reshape(J, S_SLAB, T, R_T)
    dists_t = ops.dists_t.reshape(J, S_SLAB, T, R_T)

    t_head = torch.ones((T, R_T, 1), device=dev)
    t_com = torch.ones((T, R_T, 1), device=dev)
    acc_head = torch.zeros((T, R_T, 3), device=dev)
    acc_com = torch.zeros((T, R_T, 3), device=dev)
    slabs = torch.zeros((T,), dtype=torch.int32, device=dev)
    sigma_last = torch.zeros((T, R_T, 1), device=dev)
    t_far = torch.ones((T, R_T, 1), device=dev)

    for j in range(J):
        is_last = j == J - 1
        alive = ((torch.maximum(t_head.amax(dim=(1, 2)), t_com.amax(dim=(1, 2))) > ops.ert_eps)
                 & (ops.occ[:, j] != 0))
        if is_last and bg_in_kernel:
            alive = torch.ones_like(alive)
        tiles = alive.nonzero()[:, 0]
        slabs[tiles] += 1
        z = ops.z_vals[j * S_SLAB:(j + 1) * S_SLAB]
        for start in range(0, tiles.numel(), group):
            idx = tiles[start:start + group]
            c = idx.numel()

            def field(o, d, vr, pw, branch, on):
                if not on:  # a left-out field: sigma 0, rgb 0
                    return (torch.zeros((c, S_SLAB, R_T, 1), device=dev),
                            torch.zeros((c, S_SLAB, R_T, 3), device=dev))
                x = _encode(o[idx], d[idx], z, freq, phase).reshape(-1, PE_PAD)
                vr_rows = vr[idx][:, None].expand(c, S_SLAB, R_T, 256).reshape(-1, 256)
                sigma, rgb = _field_rows(pw, x, vr_rows, branch, ops.act)
                return sigma.reshape(c, S_SLAB, R_T, 1), rgb.reshape(c, S_SLAB, R_T, 3)

            sigma_h, rgb_h = field(o_h, d_h, vr_h, ops.packed_h, "head", eval_h)
            sigma_t, rgb_t = field(o_t, d_t, vr_t, ops.packed_t, "torso", eval_t)
            th, tc = t_head[idx], t_com[idx]
            ah, ac = acc_head[idx], acc_com[idx]
            bc_c = bc[idx]
            for s in range(S_SLAB):
                sh, st = sigma_h[:, s], sigma_t[:, s]
                ch, ct = rgb_h[:, s], rgb_t[:, s]
                dh_s = dists_h[j, s, idx][..., None]
                dt_s = dists_t[j, s, idx][..., None]
                lastf = 1.0 if (bg_in_kernel and is_last and s == S_SLAB - 1) else 0.0
                # bg-concat: the head colour at the last sample is the bg
                # pixel; head stack +1e-6 on the last head density;
                # composite stack: torso last density := 0, then +1e-6
                ch = ch * (1.0 - lastf) + bc_c * lastf
                sh_head = sh + 1e-6 * lastf
                st_com = st * (1.0 - lastf) + 1e-6 * lastf

                alpha_h = 1.0 - torch.exp(-(sh_head + 1e-6) * dh_s)
                ah = ah + (alpha_h * th) * ch
                th = th * (1.0 - alpha_h + 1e-10)

                ssum = sh + st_com
                denom = torch.where(ssum == 0.0, torch.full_like(ssum, 1e-4), ssum)
                c_mix = (sh * ch + st_com * ct) / denom
                alpha_c = 1.0 - torch.exp(-(ssum + 1e-6) * dt_s)
                ac = ac + (alpha_c * tc) * c_mix
                if lastf:
                    t_far[idx] = tc
                tc = tc * (1.0 - alpha_c + 1e-10)
            t_head[idx], t_com[idx] = th, tc
            acc_head[idx], acc_com[idx] = ah, ac
            if is_last:
                sigma_last[idx] = sigma_h[:, S_SLAB - 1]
    if ops.bg_epilogue:
        return (acc_head.reshape(-1, 3), acc_com.reshape(-1, 3), slabs, t_head.reshape(-1),
                t_com.reshape(-1))
    return (acc_head.reshape(-1, 3), acc_com.reshape(-1, 3), slabs, sigma_last.reshape(-1),
            t_far.reshape(-1))


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------


# The kernel's instantiations, by (fields, bg_epilogue): the name each one's
# launches are counted under (RenderRaysKernel.variant_launches).
RENDER_VARIANTS = {("both", False): "render_rays", ("both", True): "render_rays_epilogue",
                   ("head", True): "render_rays_head", ("torso", True): "render_rays_torso",
                   ("head", False): "render_rays_head_bg", ("torso", False): "render_rays_torso_bg"}


class RenderRaysKernel(_build.Binding):
    """ctypes binding of csrc/render_rays.cu."""

    def __init__(self):
        ptr = ctypes.c_void_p
        super().__init__("render_rays", {"render_rays_launch": [ptr] * 22 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 4 + [ptr]})

    def __call__(self, ops: RenderOperands) -> Tuple[torch.Tensor, ...]:
        """Launch the instantiation that ``ops.fields`` and ``ops.bg_epilogue``
        select on the current stream. Returns rgb_head [n_pad, 3], rgb_com
        [n_pad, 3] and slabs evaluated per tile [n_tiles] (int32); in
        epilogue mode the accumulators, the slab counts and the
        transmittances t_head, t_com [n_pad], as the plain version."""
        variant = RENDER_VARIANTS.get((ops.fields, ops.bg_epilogue))
        if variant is None:
            raise ValueError(f"unknown fields {ops.fields!r}")
        T, J = ops.n_tiles, ops.n_slabs
        n_pad = T * R_T
        dev = _build.check_cuda_operands("render_rays_kernel", {
            "rays_o": (ops.rays_o, (n_pad, 3), torch.float32),
            "rays_d": (ops.rays_d, (n_pad, 3), torch.float32),
            "rays_o_t": (ops.rays_o_t, (n_pad, 3), torch.float32),
            "rays_d_t": (ops.rays_d_t, (n_pad, 3), torch.float32),
            "z_vals": (ops.z_vals, (J * S_SLAB,), torch.float32),
            "dists_h": (ops.dists_h, (J * S_SLAB, n_pad), torch.float32),
            "dists_t": (ops.dists_t, (J * S_SLAB, n_pad), torch.float32),
            "vr_h": (ops.vr_h, (n_pad, 256), torch.bfloat16),
            "vr_t": (ops.vr_t, (n_pad, 256), torch.bfloat16),
            "bc": (ops.bc, (n_pad, 3), torch.float32), "occ": (ops.occ, (T, J), torch.int32)})
        if ops.act not in ("relu", "softplus"):
            raise ValueError(f"unknown density activation {ops.act!r}")
        w_h, b_h = self.blobs(ops.packed_h, "head", dev)
        w_t, b_t = self.blobs(ops.packed_t, "torso", dev)
        freq, phase = _slot_tables(dev)
        out_h = torch.empty((n_pad, 3), dtype=torch.float32, device=dev)
        out_c = torch.empty((n_pad, 3), dtype=torch.float32, device=dev)
        slabs = torch.empty((T,), dtype=torch.int32, device=dev)
        trans = (torch.empty((2, n_pad), dtype=torch.float32, device=dev) if ops.bg_epilogue
                 else None)
        self.launch("render_rays_launch", dev, ops.rays_o, ops.rays_d, ops.rays_o_t, ops.rays_d_t,
                    ops.z_vals, ops.dists_h, ops.dists_t, ops.vr_h, ops.vr_t, ops.bc, freq, phase,
                    ops.occ, w_h, b_h, w_t, b_t, out_h, out_c, slabs,
                    *((trans[0], trans[1]) if ops.bg_epilogue else (None, None)), T, J,
                    ops.ert_eps, int(ops.act == "softplus"), int(ops.fields in ("both", "head")),
                    int(ops.fields in ("both", "torso")), int(not ops.bg_epilogue),
                    variant=variant)
        if ops.bg_epilogue:
            return out_h, out_c, slabs, trans[0], trans[1]
        return out_h, out_c, slabs


render_rays_kernel = RenderRaysKernel()


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------


def fused_render_rays(
    packed_h: Dict[str, torch.Tensor],
    packed_t: Dict[str, torch.Tensor],
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    rays_o_t: torch.Tensor,
    rays_d_t: torch.Tensor,
    z_vals: torch.Tensor,
    bc_rgb: torch.Tensor,
    last_dist: float = 1e10,
    ert_eps: float = 0.0,
    occupancy: Optional[torch.Tensor] = None,
    bg_epilogue: bool = False,
    fields: str = "both",
    act: str = "relu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render n rays through the packed fields.

    rays_* [n, 3]; z_vals [S] shared by all rays; bc_rgb [n, 3] background
    pixels; occupancy [T, J] or per-field [2, T, J] flags (all ones when
    None; per-field flags are joined: a slab runs where either field is
    occupied). ``bg_epilogue``: the background catch-all runs after the
    kernel as ``composite._bg_epilogue`` on the unpadded rays (padding rays
    have zero directions, whose view bias is NaN), so the last slab is not
    forced. ``fields``: "head" or "torso" evaluate one field, the other
    counting as sigma 0, rgb 0 in both stacks (the background rules of the
    final sample still apply without the epilogue). Returns
    rgb_head [n, 3], rgb_com [n, 3] (fp32). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    n = rays_o.shape[0]
    dev = rays_o.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_render_rays runs on cpu or cuda tensors, got {dev}")
    ops = prepare_render_operands(packed_h, packed_t, rays_o, rays_d, rays_o_t, rays_d_t,
                                  z_vals, bc_rgb, last_dist, ert_eps, occupancy, act, bg_epilogue,
                                  fields)
    out = render_rays_kernel(ops) if dev.type == "cuda" else fused_render_rays_reference(ops)
    if not bg_epilogue:
        return out[0][:n], out[1][:n]
    from dfanerf_torch.ops.composite import _bg_epilogue  # composite imports this module

    acc_h, acc_c, _, t_h, t_c = out
    return _bg_epilogue(packed_h, packed_t, ops.rays_o[:n], ops.rays_d[:n], ops.rays_o_t[:n],
                        ops.rays_d_t[:n], ops.z_vals, ops.bc[:n], last_dist, acc_h[:n], acc_c[:n],
                        t_h[:n, None], t_c[:n, None], act=act)


# Live widths of the default decoder, for the FLOP counts below.
_PE_DIM, _TORSO_SIGNAL_DIM, _HIDDEN, _DEFORM_HIDDEN = 60, 42, 256, 64


def field_flops_per_sample(branch: str, sigma: bool = True, color: bool = True) -> int:
    """Matrix-product FLOPs of one field at one (ray, sample), counted at the
    live widths, not the kernels' zero-padded ones: the PE's 60 rows (of
    64), the torso trunk's 60 + 42 input rows (of 128), the deformation net
    as its two independent 64-wide chains (of the 128-wide block-diagonal
    form; the signal half of its first layer and skip is folded into
    biases), the sigma column of the fused output layer and its 256 view
    feature columns, and the colour layer's 3 columns. ``sigma`` and
    ``color`` select the heads a kernel computes: the pair kernels both,
    the far-plane head kernel sigma only, the far-plane torso kernel colour
    only."""
    if branch not in ("head", "torso"):
        raise ValueError(f"unknown branch {branch!r}")
    pe, hidden = _PE_DIM, _HIDDEN
    k_in = pe if branch == "head" else pe + _TORSO_SIGNAL_DIM
    macs = k_in * hidden * 2 + 7 * hidden * hidden   # input layer, PE skip, 7 blocks
    if sigma:
        macs += hidden
    if color:
        macs += hidden * hidden + hidden * 3
    if branch == "torso":
        dh = _DEFORM_HIDDEN
        macs += (pe * 2 * dh               # first layer, both chains read the PE
                 + 4 * 2 * dh * dh          # 4 hidden blocks per chain
                 + pe * dh                  # PE skip into the embed chain
                 + dh * k_in)               # outputs: dh -> 60 and dh -> 42
    return 2 * macs


def render_flops_per_sample(fields: str = "both") -> int:
    """The render kernel's work at one (ray, sample) of a slab it runs: the
    fields it evaluates, each with both heads (see field_flops_per_sample)."""
    return sum(field_flops_per_sample(branch) for branch in ("head", "torso")
               if fields in ("both", branch))
