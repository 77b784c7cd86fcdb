"""Dataclass configuration, field for field the same as dfanerf_tpu/config.py.

Only the dataclasses and their JSON loading are ported: the same field
names and defaults, so ``configs/*.json`` load into both packages. The
long per-field notes live in dfanerf_tpu/config.py; they are not repeated
here.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

from dfanerf_torch.models.decoder import DecoderConfig


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    n_samples: int = 64
    n_importance: int = 0
    last_dist: float = 1e10
    concate_bg: bool = True
    tile_rays: int = 8192
    near: float = 0.3
    far: float = 0.9
    compute_dtype: str = "float32"
    use_fused_kernel: bool = False
    ert_eps: float = 1e-4
    occ_sigma_thresh: float = 0.0
    occ_grid_res: int = 64
    occ_refresh_every: int = 1
    occ_tile_compaction: bool = False
    spatial_tiles: bool = False
    occ_pair_compaction: bool = False
    occ_prune_trans: float = 1e-3
    occ_prune_contrib: float = 0.0
    occ_prune_budget: float = 0.0
    occ_budget_color: bool = False
    occ_budget_iters: int = 1
    far_skip_tol: float = 0.0
    far_subsample: int = 1
    occ_prune_carry: int = 0
    occ_live_keys: bool = False
    occ_live_remeasure: int = 8
    occ_prune_hist_decay: float = 0.0
    occ_async_refresh: bool = False
    occ_class_clamp: bool = True
    occ_pack2: bool = False
    occ_union_window: bool = True


@dataclasses.dataclass(frozen=True)
class SignalConfig:
    dim_aud: int = 96
    dim_signal: int = 96
    audio_net: str = "w2l"
    smo_size: int = 4
    smo_torso_size: int = 8
    win_size: int = 16
    use_et_embed: bool = True
    et_multires: int = 3
    nosmo_iters: int = 300_000
    noexp_iters: int = 400_000


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_rand: int = 2048
    n_iters: int = 600_000
    lrate: float = 5e-4
    lrate_decay: int = 500
    sample_rate: float = 0.0
    n_object: int = 1
    z_dim: int = 256
    i_print: int = 100
    i_weights: int = 100_000
    i_test_person: int = 10_000
    use_l1: bool = False
    train_together: bool = True
    perturb: bool = False
    seed: int = 0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    grad_clip: float = 0.0
    distortion_lambda: float = 0.0
    distortion_stacks: str = "com"
    distortion_from: int = 2000


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    expname: str = "experiment"
    datadir: str = ""
    basedir: str = "runs"
    decoder: DecoderConfig = DecoderConfig()
    render: RenderConfig = RenderConfig()
    signal: SignalConfig = SignalConfig()
    train: TrainConfig = TrainConfig()
    use_ba: bool = True
    aud_file: str = "aud.pt"
    exp_file: str = "exp.pt"
    all_speaker: bool = True
    testskip: int = 1

    @staticmethod
    def from_json(path: str) -> "ExperimentConfig":
        with open(path) as f:
            return ExperimentConfig.from_dict(json.load(f))

    @staticmethod
    def from_dict(raw: dict) -> "ExperimentConfig":
        kwargs = dict(raw)
        for field, cls in (
            ("decoder", DecoderConfig),
            ("render", RenderConfig),
            ("signal", SignalConfig),
            ("train", TrainConfig),
        ):
            if field in kwargs and isinstance(kwargs[field], dict):
                sub = dict(kwargs[field])
                if field == "decoder" and "skips" in sub:
                    sub["skips"] = tuple(sub["skips"])
                kwargs[field] = cls(**sub)
        return ExperimentConfig(**kwargs)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)


def parse_legacy_config_file(path: str) -> Tuple[float, float]:
    """near and far from a pipeline-written ``HeadNeRF_config_ba.txt``.

    The reference reads them by line index (run_nerf_com_trainExpLater.py:
    19-25, lines 3 and 4); this reads them by key, with that positional
    fallback, so both well-formed and legacy files work.
    """
    with open(path) as f:
        lines = f.readlines()
    near = far = None
    for ln in lines:
        if "=" in ln:
            k, v = ln.split("=", 1)
            k = k.strip()
            if k == "near":
                near = float(v.strip())
            elif k == "far":
                far = float(v.strip())
    if near is None or far is None:
        near = float(lines[3].split("=")[-1].strip())
        far = float(lines[4].split("=")[-1].strip())
    return near, far
