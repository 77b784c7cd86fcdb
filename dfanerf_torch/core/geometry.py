"""Rotation, pose and projection primitives (port of
dfanerf_tpu/core/geometry.py): the pose to (euler, translation) conversion
of the signal encoders, and the Euler rotations, rigid transforms and
pinhole projection of the 3DMM tracker and bundle adjustment.

The atan2 convention at the zero matrix is kept: signed zeros flow through
``atan2`` exactly as in the reference, which train/signals.py relies on for
the zero-padded pose window.
"""

from __future__ import annotations

import torch


def rot_to_euler(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3]: e0 = atan2(R22, R12), e1 = asin(-R02),
    e2 = atan2(R00, -R01)."""
    e0 = torch.atan2(R[..., 2, 2], R[..., 1, 2])
    e1 = torch.asin(-R[..., 0, 2])
    e2 = torch.atan2(R[..., 0, 0], -R[..., 0, 1])
    return torch.stack([e0, e1, e2], dim=-1)


def pose_to_euler_trans(poses: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] (or [..., 3, 4]) poses -> [..., 6] (euler, translation)."""
    e = rot_to_euler(poses[..., :3, :3])
    return torch.cat([e, poses[..., :3, 3]], dim=-1)


def euler2rot(euler: torch.Tensor) -> torch.Tensor:
    """[..., 3] Euler angles (theta, phi, psi) -> [..., 3, 3] rotations
    R = Rx @ Ry @ Rz, in the reference's sign layout
    (face_tracking_ba/util.py:18-46):
        Rx = [[1,0,0],[0,c,-s],[0,s,c]]
        Ry = [[c,0,s],[0,1,0],[-s,0,c]]
        Rz = [[c,s,0],[-s,c,0],[0,0,1]]"""
    theta, phi, psi = euler[..., 0], euler[..., 1], euler[..., 2]
    one, zero = torch.ones_like(theta), torch.zeros_like(theta)
    ct, st = torch.cos(theta), torch.sin(theta)
    cp, sp = torch.cos(phi), torch.sin(phi)
    cs, ss = torch.cos(psi), torch.sin(psi)

    def mat(*rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    rot_x = mat((one, zero, zero), (zero, ct, -st), (zero, st, ct))
    rot_y = mat((cp, zero, sp), (zero, one, zero), (-sp, zero, cp))
    rot_z = mat((cs, ss, zero), (-ss, cs, zero), (zero, zero, one))
    return rot_x @ rot_y @ rot_z


def rot_trans_pts(pts: torch.Tensor, rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """R @ p + t per batch: pts [B, N, 3], rot [B, 3, 3], trans [B, 3] -> [B, N, 3]."""
    return torch.einsum("bij,bnj->bni", rot, pts) + trans[..., None, :]


def proj_pts(pts_cam: torch.Tensor, focal, cxy: torch.Tensor) -> torch.Tensor:
    """Pinhole projection of camera-space points [B, N, 3] (u = -f X / Z + cx,
    v = f Y / Z + cy; the camera looks down -Z) -> [B, N, 3] (u, v, Z).
    ``focal`` is a scalar or [B]."""
    focal = torch.as_tensor(focal, dtype=pts_cam.dtype, device=pts_cam.device)
    if focal.ndim == 1:
        focal = focal[:, None]
    x, y, z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
    u = -focal * x / z + cxy[0]
    v = focal * y / z + cxy[1]
    return torch.stack([u, v, z], dim=-1)


def forward_transform(pts: torch.Tensor, euler: torch.Tensor, trans: torch.Tensor, focal,
                      cxy: torch.Tensor) -> torch.Tensor:
    """World points -> pixel coordinates through a per-frame rigid transform
    (face_tracking_ba/util.py:72-77): project(R(euler) @ p + t)."""
    return proj_pts(rot_trans_pts(pts, euler2rot(euler), trans), focal, cxy)
