"""The far-plane fields of the background catch-all (port of
dfanerf_tpu/ops/fused_render.py fused_far_eval :1430, fused_far_eval_split
:1566, fused_far_eval_split_prepped :1588 and bg_epilogue_fused :1687).

At each ray's far-plane point o + d * far: the head field's density sh
[n, 1] (after the density activation) and the torso field's colour ct
[n, 3], both float32 — what ``composite.bg_blend`` needs for the last
sample. The reference's kernels return [n, 8] broadcasts of these (a TPU
lane layout); the port returns the values themselves.

Two implementations over the same operands:

- ``far_head_kernel``, ``far_torso_kernel`` and ``far_joint_kernel``: the
  hand-written CUDA kernels of csrc/far_eval.cu (the ports of the Pallas
  ``_far_head_kernel``, ``_far_torso_kernel`` and ``_far_kernel``, which is
  the first two in one kernel), bound with ctypes and built at first launch,
  each counting its launches in ``.launches``.
- ``far_head_reference`` and ``far_torso_reference`` (both together:
  ``far_eval_reference``, also the plain version of the joint kernel): their
  plain PyTorch versions, with the same bf16 rounding points.

``fused_far_eval_split_prepped`` and ``fused_far_eval`` take the plain
version only for tensors on the CPU; for CUDA tensors they launch their
kernels or raise.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from dfanerf_torch.ops import _build
from dfanerf_torch.ops.composite import bg_blend
from dfanerf_torch.ops.fused_render import (
    _field_rows, _mm_kernel, _slot_tables, _trunk, density_act, pe_replicate, view_bias,
)

_REF_ROWS = 16384  # rays per group in the plain version (bounds its activation memory)


def _check_operands(rays_o, rays_d, rays_o_t, rays_d_t, vr_t, act):
    n = rays_o.shape[0]
    for name, x in (("rays_d", rays_d), ("rays_o_t", rays_o_t), ("rays_d_t", rays_d_t)):
        if tuple(x.shape) != (n, 3):
            raise ValueError(f"{name}: expected {(n, 3)}, got {tuple(x.shape)}")
    if tuple(vr_t.shape) != (n, 256):
        raise ValueError(f"vr_t: expected {(n, 256)}, got {tuple(vr_t.shape)}")
    if act not in ("relu", "softplus"):
        raise ValueError(f"unknown density activation {act!r}")


def _far_rows(o, d, far, rows):
    """Far-plane PE of the given rays: sin(pe_replicate(o + d * far) * freq
    + phase) in bf16, as the kernels encode it."""
    freq, phase = _slot_tables(o.device)
    pts = o[rows].float() + d[rows].float() * torch.tensor(far, dtype=torch.float32)
    return torch.sin(pe_replicate(pts) * freq + phase).to(torch.bfloat16)


@torch.no_grad()
def far_head_reference(pw_h: Dict[str, torch.Tensor], rays_o, rays_d, far: float,
                       act: str = "relu") -> torch.Tensor:
    """Plain PyTorch version of far_head: sh [n, 1]."""
    return torch.cat([
        density_act(_trunk(pw_h, _far_rows(rays_o, rays_d, far, slice(a, a + _REF_ROWS)),
                           _mm_kernel)[:, 0:1], act)
        for a in range(0, rays_o.shape[0], _REF_ROWS)])


@torch.no_grad()
def far_torso_reference(pw_t: Dict[str, torch.Tensor], rays_o_t, rays_d_t, far: float,
                        vr_t: torch.Tensor, act: str = "relu") -> torch.Tensor:
    """Plain PyTorch version of far_torso: ct [n, 3]."""
    out = []
    for a in range(0, rays_o_t.shape[0], _REF_ROWS):
        rows = slice(a, a + _REF_ROWS)
        _, rgb = _field_rows(pw_t, _far_rows(rays_o_t, rays_d_t, far, rows), vr_t[rows].float(),
                             "torso", act)
        out.append(rgb)
    return torch.cat(out)


def far_eval_reference(pw_h, pw_t, rays_o, rays_d, rays_o_t, rays_d_t, far: float,
                       vr_t: torch.Tensor, act: str = "relu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of both kernels: (sh [n, 1], ct [n, 3])."""
    _check_operands(rays_o, rays_d, rays_o_t, rays_d_t, vr_t, act)
    return (far_head_reference(pw_h, rays_o, rays_d, far, act),
            far_torso_reference(pw_t, rays_o_t, rays_d_t, far, vr_t, act))


class FarEvalKernel(_build.Binding):
    """ctypes binding of one entry point of csrc/far_eval.cu (``torso``
    False: far_head, True: far_torso)."""

    def __init__(self, torso: bool):
        ptr = ctypes.c_void_p
        super().__init__("far_eval", {"far_eval_launch": [ctypes.c_int, ptr, ptr, ctypes.c_float]
                                      + [ptr] * 6 + [ctypes.c_int, ctypes.c_int, ptr]})
        self.torso = torso

    def __call__(self, pw, rays_o, rays_d, far: float, vr=None, act: str = "relu"):
        """Launch on the current stream: far_head returns sh [n, 1], far_torso
        (which needs the torso view bias vr [n, 256] bf16) ct [n, 3]."""
        n = rays_o.shape[0]
        operands = {"rays_o": (rays_o, (n, 3), torch.float32),
                    "rays_d": (rays_d, (n, 3), torch.float32)}
        if self.torso:
            if vr is None:
                raise ValueError("far_torso needs the torso view bias")
            operands["vr"] = (vr, (n, 256), torch.bfloat16)
        dev = _build.check_cuda_operands("far_eval_kernel", operands)
        if act not in ("relu", "softplus"):
            raise ValueError(f"unknown density activation {act!r}")
        w, b = self.blobs(pw, "torso" if self.torso else "head", dev)
        out = torch.empty((n, 3 if self.torso else 1), dtype=torch.float32, device=dev)
        if n == 0:
            return out
        freq, phase = _slot_tables(dev)
        self.launch("far_eval_launch", dev, int(self.torso), rays_o, rays_d, float(far),
                    vr if self.torso else None, freq, phase, w, b, out, n, int(act == "softplus"))
        return out


far_head_kernel = FarEvalKernel(torso=False)
far_torso_kernel = FarEvalKernel(torso=True)


class FarJointKernel(_build.Binding):
    """ctypes binding of far_joint, the third entry point of
    csrc/far_eval.cu."""

    def __init__(self):
        ptr = ctypes.c_void_p
        super().__init__("far_eval", {"far_joint_launch": [ptr] * 4 + [ctypes.c_float]
                                      + [ptr] * 9 + [ctypes.c_int, ctypes.c_int, ptr]})

    def __call__(self, pw_h, pw_t, rays_o, rays_d, rays_o_t, rays_d_t, far: float, vr_t,
                 act: str = "relu") -> Tuple[torch.Tensor, torch.Tensor]:
        """Launch on the current stream: sh [n, 1] of the head rays and ct
        [n, 3] of the torso rays (torso view bias vr_t [n, 256] bf16)."""
        n = rays_o.shape[0]
        dev = _build.check_cuda_operands("far_joint_kernel", {
            "rays_o": (rays_o, (n, 3), torch.float32), "rays_d": (rays_d, (n, 3), torch.float32),
            "rays_o_t": (rays_o_t, (n, 3), torch.float32),
            "rays_d_t": (rays_d_t, (n, 3), torch.float32),
            "vr_t": (vr_t, (n, 256), torch.bfloat16)})
        if act not in ("relu", "softplus"):
            raise ValueError(f"unknown density activation {act!r}")
        w_h, b_h = self.blobs(pw_h, "head", dev)
        w_t, b_t = self.blobs(pw_t, "torso", dev)
        sh = torch.empty((n, 1), dtype=torch.float32, device=dev)
        ct = torch.empty((n, 3), dtype=torch.float32, device=dev)
        if n == 0:
            return sh, ct
        freq, phase = _slot_tables(dev)
        self.launch("far_joint_launch", dev, rays_o, rays_d, rays_o_t, rays_d_t, float(far), vr_t,
                    freq, phase, w_h, b_h, w_t, b_t, sh, ct, n, int(act == "softplus"))
        return sh, ct


far_joint_kernel = FarJointKernel()


def fused_far_eval_split_prepped(pw_h: Dict[str, torch.Tensor], pw_t: Dict[str, torch.Tensor],
                                 rays_o, rays_d, rays_o_t, rays_d_t, far: float,
                                 vr_t: torch.Tensor, act: str = "relu"
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Head density and torso colour at the far plane, given the torso view
    bias vr_t [n, 256] bf16. The reference's prepped operands are the
    slot-replicated far-plane points; here the kernels take the rays and
    ``far`` and form o + d * far themselves, in the same float32 order.
    Returns sh [n, 1] and ct [n, 3], float32."""
    _check_operands(rays_o, rays_d, rays_o_t, rays_d_t, vr_t, act)
    dev = rays_o.device
    if dev.type == "cuda":
        return (far_head_kernel(pw_h, rays_o, rays_d, far, act=act),
                far_torso_kernel(pw_t, rays_o_t, rays_d_t, far, vr_t, act=act))
    if dev.type != "cpu":
        raise ValueError(f"fused_far_eval_split runs on cpu or cuda tensors, got {dev}")
    return far_eval_reference(pw_h, pw_t, rays_o, rays_d, rays_o_t, rays_d_t, far, vr_t, act)


def fused_far_eval_split(pw_h, pw_t, rays_o, rays_d, rays_o_t, rays_d_t, far: float,
                         act: str = "relu") -> Tuple[torch.Tensor, torch.Tensor]:
    """``fused_far_eval_split_prepped`` with the torso view bias computed
    here."""
    vr_t = view_bias(pw_t, rays_d_t).to(torch.bfloat16).contiguous()
    return fused_far_eval_split_prepped(pw_h, pw_t, rays_o, rays_d, rays_o_t, rays_d_t, far,
                                        vr_t, act)


def fused_far_eval(pw_h, pw_t, rays_o, rays_d, rays_o_t, rays_d_t, far: float,
                   act: str = "relu") -> Tuple[torch.Tensor, torch.Tensor]:
    """The joint form (reference :1430): head density sh [n, 1] and torso
    colour ct [n, 3] at the far plane from one kernel, far_joint, which
    equals far_head + far_torso on the same rays. The torso view bias is
    computed here."""
    vr_t = view_bias(pw_t, rays_d_t).to(torch.bfloat16).contiguous()
    _check_operands(rays_o, rays_d, rays_o_t, rays_d_t, vr_t, act)
    dev = rays_o.device
    if dev.type == "cuda":
        return far_joint_kernel(pw_h, pw_t, rays_o, rays_d, rays_o_t, rays_d_t, far, vr_t, act)
    if dev.type != "cpu":
        raise ValueError(f"fused_far_eval runs on cpu or cuda tensors, got {dev}")
    return far_eval_reference(pw_h, pw_t, rays_o, rays_d, rays_o_t, rays_d_t, far, vr_t, act)


def bg_epilogue_fused(pw_h, pw_t, rays_o, rays_d, rays_o_t, rays_d_t, z_vals, bc_rgb,
                      last_dist, acc_head, acc_com, t_head, t_com):
    """``composite._bg_epilogue`` with its two field evaluations done by
    ``fused_far_eval`` (reference :1687); the blend is ``bg_blend``. As in
    the reference, ``fused_far_eval`` is called without ``act``, so the
    far-plane density is always relu'd. Reads z_vals[-1] to the host."""
    sh, ct = fused_far_eval(pw_h, pw_t, rays_o, rays_d, rays_o_t, rays_d_t, float(z_vals[-1]))
    return bg_blend(sh, ct, rays_d, rays_d_t, bc_rgb, last_dist, acc_head, acc_com, t_head, t_com)
