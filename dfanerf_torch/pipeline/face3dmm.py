"""Basel-style 3DMM face model as linear bases (port of
dfanerf_tpu/pipeline/face3dmm.py), tensors on the device.

Re-design of the reference ``Face_3DMM`` (face_tracking_ba/facemodel.py:
7-68): the bases are loaded once, scaled by 1/1000 into the working unit,
the mean shape is centred per axis, and the per-component sigmas
premultiply the parameters.

Binary asset layout (the reference's ``3DMM/`` directory, not in the
repository):
    sub_b_shape.bin  float32 [>=id_dim, 3*point_num]   identity basis
    sub_mushape.bin  float32 [3*point_num]             identity mean
    sub_b_exp.bin    float32 [>=exp_dim, 3*point_num]  expression basis
    sub_muexp.bin    float32 [3*point_num]             expression mean
    sub_b_tex.bin    float32 [>=tex_dim, 3*point_num]  texture basis
    sub_mutex.bin    float32 [3*point_num]             texture mean
    sig_shape.bin / sig_exp.bin / sig_tex.bin          per-component sigmas
    lands_info.txt   int32 landmark vertex indices (last 51 = non-jaw 68-set)

``write_face3dmm`` writes that layout (seeded synthetic bases for the tests
and the card).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from dfanerf_torch.device import resolve_device


@dataclasses.dataclass
class Face3DMM:
    base_id: torch.Tensor    # [id_dim, 3P] (already /1000)
    base_exp: torch.Tensor   # [exp_dim, 3P] (already /1000)
    mu: torch.Tensor         # [3P] centred mean (already /1000)
    base_tex: torch.Tensor   # [tex_dim, 3P]
    mu_tex: torch.Tensor     # [3P]
    sig_id: torch.Tensor     # [id_dim]
    sig_exp: torch.Tensor    # [exp_dim]
    sig_tex: torch.Tensor    # [tex_dim]
    lands_info: Optional[np.ndarray] = None  # landmark vertex ids

    @property
    def point_num(self) -> int:
        return self.mu.shape[0] // 3


def load_face3dmm(modelpath: str, id_dim: int = 100, exp_dim: int = 79, tex_dim: int = 100,
                  point_num: int = 34650, device=None) -> Face3DMM:
    """The reference's ``.bin`` bases on ``device`` (default CUDA)."""
    dev = resolve_device(device)

    def load(name):
        return np.fromfile(os.path.join(modelpath, name), np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    base_id = load("sub_b_shape.bin").reshape(-1, 3 * point_num)[:id_dim]
    base_exp = load("sub_b_exp.bin").reshape(-1, 3 * point_num)[:exp_dim]
    mu = (load("sub_mushape.bin") + load("sub_muexp.bin")).reshape(-1, 3)
    mu = mu - mu.mean(axis=0, keepdims=True)
    lands_path = os.path.join(modelpath, "lands_info.txt")
    lands = np.loadtxt(lands_path, dtype=np.int32) if os.path.isfile(lands_path) else None
    return Face3DMM(
        base_id=t(base_id / 1000.0), base_exp=t(base_exp / 1000.0),
        mu=t(mu.reshape(-1) / 1000.0),
        base_tex=t(load("sub_b_tex.bin").reshape(-1, 3 * point_num)[:tex_dim]),
        mu_tex=t(load("sub_mutex.bin")),
        sig_id=t(load("sig_shape.bin")[:id_dim]), sig_exp=t(load("sig_exp.bin")[:exp_dim]),
        sig_tex=t(load("sig_tex.bin")[:tex_dim]), lands_info=lands)


def synthetic_3dmm_arrays(seed: int = 0, point_num: int = 200, id_dim: int = 20,
                          exp_dim: int = 12, tex_dim: int = 8):
    """Seeded random bases in the ``.bin`` files' units, from a CPU
    ``torch.Generator``: a dict of the file names' arrays and
    ``lands_info``. After the loader's /1000 the mean shape spreads ~80
    units a side, like a face in millimetres (the fit starts 600 in front of
    the camera), an identity component ~2 and an expression one ~1."""
    g = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g).numpy()

    p3 = 3 * point_num
    return {
        "sub_b_shape.bin": randn(id_dim, p3) * 2000.0,
        "sub_mushape.bin": randn(p3) * 80000.0,
        "sub_b_exp.bin": randn(exp_dim, p3) * 1000.0,
        "sub_muexp.bin": np.zeros(p3, np.float32),
        "sub_b_tex.bin": randn(tex_dim, p3),
        "sub_mutex.bin": np.zeros(p3, np.float32),
        "sig_shape.bin": np.abs(randn(id_dim)) + 0.5,
        "sig_exp.bin": np.abs(randn(exp_dim)) + 0.5,
        "sig_tex.bin": np.ones(tex_dim, np.float32),
        "lands_info.txt": torch.randperm(point_num, generator=g)[:68].numpy().astype(np.int32),
    }


def write_face3dmm(modelpath: str, arrays) -> str:
    """Write ``synthetic_3dmm_arrays``' output in the reference's layout."""
    os.makedirs(modelpath, exist_ok=True)
    for name, a in arrays.items():
        path = os.path.join(modelpath, name)
        if name.endswith(".txt"):
            np.savetxt(path, a, "%d")
        else:
            np.asarray(a, np.float32).tofile(path)
    return modelpath


def make_synthetic_3dmm(seed: int = 0, point_num: int = 200, id_dim: int = 20, exp_dim: int = 12,
                        tex_dim: int = 8, device=None) -> Face3DMM:
    """A small seeded 3DMM for ``random:<seed>`` (same shapes and semantics,
    no assets): the arrays of ``synthetic_3dmm_arrays`` as the loader
    would read them. ``torch.Generator`` cannot reproduce ``jax.random``, so
    the reference's ``random:<seed>`` basis is another one."""
    dev = resolve_device(device)
    a = synthetic_3dmm_arrays(seed, point_num, id_dim, exp_dim, tex_dim)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    mu = (a["sub_mushape.bin"] + a["sub_muexp.bin"]).reshape(-1, 3)
    mu = mu - mu.mean(axis=0, keepdims=True)
    return Face3DMM(
        base_id=t(a["sub_b_shape.bin"] / 1000.0), base_exp=t(a["sub_b_exp.bin"] / 1000.0),
        mu=t(mu.reshape(-1) / 1000.0), base_tex=t(a["sub_b_tex.bin"]), mu_tex=t(a["sub_mutex.bin"]),
        sig_id=t(a["sig_shape.bin"]), sig_exp=t(a["sig_exp.bin"]), sig_tex=t(a["sig_tex.bin"]),
        lands_info=a["lands_info.txt"])


def sub_columns(sub_index) -> torch.Tensor:
    """The basis columns of a vertex subset: [K] ids -> [3K]."""
    sub_index = torch.as_tensor(np.asarray(sub_index), dtype=torch.int64)
    return (3 * sub_index[:, None] + torch.arange(3)[None, :]).reshape(-1)


def forward_geo_sub(model: Face3DMM, id_para: torch.Tensor, exp_para: torch.Tensor,
                    sub_index) -> torch.Tensor:
    """Geometry of a vertex subset (e.g. the 51 non-jaw landmarks), the
    fit's hot path. sub_index: [K] vertex ids -> [B, K, 3]."""
    cols = sub_columns(sub_index).to(model.mu.device)
    g = ((id_para * model.sig_id) @ model.base_id[:, cols]
         + (exp_para * model.sig_exp) @ model.base_exp[:, cols] + model.mu[cols])
    return g.reshape(-1, cols.shape[0] // 3, 3)


def forward_geo(model: Face3DMM, id_para: torch.Tensor, exp_para: torch.Tensor) -> torch.Tensor:
    """World geometry of every vertex: [B, id_dim], [B, exp_dim] -> [B, P, 3]."""
    g = ((id_para * model.sig_id) @ model.base_id + (exp_para * model.sig_exp) @ model.base_exp
         + model.mu)
    return g.reshape(-1, model.point_num, 3)


def forward_tex(model: Face3DMM, tex_para: torch.Tensor) -> torch.Tensor:
    """Per-vertex albedo: [B, tex_dim] -> [B, P, 3]."""
    t = (tex_para * model.sig_tex) @ model.base_tex + model.mu_tex
    return t.reshape(-1, model.point_num, 3)
