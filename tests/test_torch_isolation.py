"""The port stands alone: dfanerf_torch and chip_smoke.py import without JAX
and without the reference package, and nothing in them (nor in the port's
perf/ tools) imports either;
without a CUDA device the entry points refuse to fall back to the CPU
silently, and the kernel wrappers refuse tensors they cannot serve."""

import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((REPO / "dfanerf_torch").rglob("*.py")) + sorted((REPO / "perf").glob("*.py"))
              + [REPO / "chip_smoke.py"])


def _modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in (REPO / "dfanerf_torch").rglob("*.py"))


def test_imports_without_jax():
    """Every module, with jax and the reference package made unimportable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['dfanerf_tpu'] = None\n"
        "import importlib\n"
        f"for m in {_modules() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not [k for k, v in sys.modules.items()\n"
        "            if v is not None and k.split('.')[0] in ('jax', 'jaxlib', 'dfanerf_tpu')]\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_has_no_jax_import(path):
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|dfanerf_tpu)\b", re.M)
    assert not pattern.search(path.read_text())


def test_no_silent_cpu_fallback(tmp_path):
    """Every entry point defaults to the card: the dense and the pair
    renderer, the seeded state and the state converted from the reference,
    the synthetic ground truth, the device data, the train step, the
    training loop, the audio nets, audio to video, the cli (train and
    process), the multi-identity step, the process group of a multi-process
    job, the preprocessing driver, each perception net's seeded init and
    checkpoint loader, the distangler and the 3DMM, the reference-checkpoint
    loader and its train state, and the distangler's trainer."""
    from dfanerf_torch import cli
    from dfanerf_torch.pipeline.audio.deepspeech import init_deepspeech
    from dfanerf_torch.pipeline.audio.wav2exp import audio_encoder_from_torch, init_audio_encoder
    from dfanerf_torch.render.audio_video import e2e_audio_video
    from dfanerf_torch.compat.from_jax import state_from_jax
    from dfanerf_torch.config import ExperimentConfig, RenderConfig
    from dfanerf_torch.render.renderer import (
        make_frame_renderer, make_head_hierarchical_renderer,
    )
    from dfanerf_torch.data.synthetic import make_synthetic_dataset, make_synthetic_scene
    from dfanerf_torch.parallel.distributed import initialize
    from dfanerf_torch.parallel.multi import make_multi_identity_train_step
    from dfanerf_torch.train.loop import train_loop
    from dfanerf_torch.train.state import init_train_state
    from dfanerf_torch.train.step import dataset_to_device, make_train_step

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the check is for machines without one")
    hw = (24, 24, 26.4, 12.0, 12.0)
    dense = ExperimentConfig(render=RenderConfig(use_fused_kernel=True, n_samples=16))
    pairs = ExperimentConfig(render=RenderConfig(
        use_fused_kernel=True, n_samples=16, spatial_tiles=True, occ_sigma_thresh=0.5,
        occ_pair_compaction=True))
    for cfg in (dense, pairs):
        with pytest.raises(RuntimeError, match="CUDA"):
            make_frame_renderer(cfg, hw, 0.3, 0.9)
        hier = ExperimentConfig(render=dataclasses.replace(cfg.render, n_importance=16))
        with pytest.raises(RuntimeError, match="CUDA"):
            make_head_hierarchical_renderer(hier, hw, 0.3, 0.9)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(dense)
    with pytest.raises(RuntimeError, match="CUDA"):
        state_from_jax({}, dense)
    ds = make_synthetic_scene(n_frames=2, H=8, W=8)
    for entry in (lambda: make_synthetic_dataset(n_frames=2, H=8, W=8),
                  lambda: dataset_to_device(ds), lambda: make_train_step(dense, ds),
                  lambda: train_loop(dense, ds, n_iters=1, run_dir=str(tmp_path)),
                  lambda: init_audio_encoder(), lambda: audio_encoder_from_torch({}),
                  lambda: init_deepspeech(n_hidden=8),
                  lambda: e2e_audio_video(dense, ds, None, None, n_frames=2),
                  lambda: cli.main(["train", "--synthetic"]),
                  lambda: make_multi_identity_train_step(dense, [ds]),
                  lambda: initialize("tcp://127.0.0.1:1", world_size=2, rank=0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()
    _no_silent_cpu_fallback_in_preprocessing(tmp_path)


def _no_silent_cpu_fallback_in_preprocessing(tmp_path):
    from dfanerf_torch import cli
    from dfanerf_torch.compat.torch_ckpt import load_reference_checkpoint, reference_train_state
    from dfanerf_torch.config import ExperimentConfig
    from dfanerf_torch.models.perception.bisenet import BiSeNet, load_bisenet
    from dfanerf_torch.models.perception.blazeface import BlazeFace, load_blazeface
    from dfanerf_torch.models.perception.ghostnet_eye import EyeNet, load_eye_net
    from dfanerf_torch.models.perception.hrnet import HRNet, HRNetConfig, load_hrnet
    from dfanerf_torch.models.perception.raft import RAFTSmall, load_raft_small
    from dfanerf_torch.pipeline.disentangle import (
        Distangler, load_distangler, make_disentangle_train_step,
    )
    from dfanerf_torch.pipeline.driver import PipelineDriver
    from dfanerf_torch.pipeline.face3dmm import (
        load_face3dmm, make_synthetic_3dmm, synthetic_3dmm_arrays, write_face3dmm,
    )

    tiny = HRNetConfig(stage2=(1, 2, (1, 1), (4, 4)), stage3=(1, 3, (1, 1, 1), (4, 4, 4)),
                       stage4=(1, 4, (1, 1, 1, 1), (4, 4, 4, 4)))
    entries = [lambda: PipelineDriver(str(tmp_path / "id")),
               lambda: cli.main(["process", "--id-dir", str(tmp_path / "id"), "--step", "2"]),
               lambda: make_synthetic_3dmm(point_num=8),
               lambda: load_face3dmm(write_face3dmm(str(tmp_path / "bfm"), synthetic_3dmm_arrays(
                   point_num=8, id_dim=2, exp_dim=2, tex_dim=1)), 2, 2, 1, 8),
               lambda: load_reference_checkpoint(str(tmp_path / "000001.tar")),
               lambda: reference_train_state({}, ExperimentConfig()),
               lambda: make_disentangle_train_step(None, [0])[0]()]
    for make, load in ((BlazeFace, load_blazeface), (lambda: HRNet(tiny), load_hrnet),
                       (EyeNet, load_eye_net), (BiSeNet, load_bisenet),
                       (RAFTSmall, load_raft_small), (Distangler, load_distangler)):
        path = str(tmp_path / f"{load.__name__}.pth")
        torch.save(make().state_dict(), path)
        entries += [lambda load=load: load("random:0"), lambda load=load, path=path: load(path)]
    for entry in entries:
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()


def test_kernel_wrapper_refuses_what_it_cannot_serve():
    from dfanerf_torch.ops.fused_render import (
        fused_render_rays, prepare_render_operands, render_rays_kernel,
    )

    pw = {"w_view": torch.zeros(24, 256), "b_view": torch.zeros(256)}
    rays = [torch.zeros(8, 3) for _ in range(4)]
    z = torch.linspace(0.3, 0.9, 16)
    # CPU tensors never reach the kernel
    ops = prepare_render_operands(pw, pw, *rays, z, torch.zeros(8, 3))
    with pytest.raises(ValueError, match="CUDA"):
        render_rays_kernel(ops)
    assert render_rays_kernel.launches == 0
    # neither does any other device, nor a variant the kernel lacks
    meta = [r.to("meta") for r in rays]
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_render_rays(pw, pw, *meta, z, torch.zeros(8, 3, device="meta"))
    # the epilogue-mode and single-field variants take CUDA tensors only too
    for fields in ("both", "head", "torso"):
        ops = prepare_render_operands(pw, pw, *rays, z, torch.zeros(8, 3), bg_epilogue=True,
                                      fields=fields)
        with pytest.raises(ValueError, match="CUDA"):
            render_rays_kernel(ops)
    assert render_rays_kernel.launches == 0
    # a single field with the background in the kernel: the CPU route computes
    # it with the plain version, the kernel refuses CPU tensors
    from dfanerf_torch.models import Decoder, DecoderConfig
    from dfanerf_torch.models.layers import init_uniform_
    from dfanerf_torch.ops.pack import pack_field_weights

    dec = init_uniform_(Decoder(DecoderConfig()), torch.Generator().manual_seed(0))
    zs = torch.zeros(256)
    packed = [pack_field_weights(dec, torch.zeros(d), zs, zs, b)
              for d, b in ((96, "head"), (42, "torso"))]
    rays_d = torch.tensor([[0.0, 0.0, -1.0]]).expand(8, 3)
    for fields in ("head", "torso"):
        head, com = fused_render_rays(*packed, rays[0], rays_d, rays[0], rays_d, z,
                                      torch.full((8, 3), 0.5), fields=fields)
        assert head.shape == com.shape == (8, 3)
        assert torch.isfinite(head).all() and torch.isfinite(com).all()
        ops = prepare_render_operands(pw, pw, *rays, z, torch.zeros(8, 3), fields=fields)
        with pytest.raises(ValueError, match="CUDA"):
            render_rays_kernel(ops)
    assert render_rays_kernel.launches == 0


def test_hierarchical_kernel_wrappers_refuse_cpu_tensors():
    """Each kernel of the hierarchical render takes CUDA tensors only; CPU
    tensors raise before anything is built or launched."""
    from dfanerf_torch.ops.pair_hier import pair_field_perz_kernel, pair_sigma_kernel
    from dfanerf_torch.ops.render_head import prepare_head_operands, render_head_kernel
    from dfanerf_torch.ops.sigma_head import sigma_head_kernel

    pw = {"w_view": torch.zeros(24, 256), "b_view": torch.zeros(256)}
    rays = torch.zeros(256, 3)
    z = torch.linspace(0.3, 0.9, 16)
    one = torch.zeros(1, dtype=torch.int32)
    calls = [
        lambda: sigma_head_kernel(pw, rays, rays, z, torch.ones((1, 2), dtype=torch.int32)),
        lambda: render_head_kernel(prepare_head_operands(pw, rays, rays, z, rays)),
        lambda: pair_sigma_kernel(pw, rays, rays, z, one, one),
        lambda: pair_field_perz_kernel(pw, rays, rays, torch.zeros(256, 256, dtype=torch.bfloat16),
                                       torch.zeros(2, 8, 512), one, one),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    for k in (sigma_head_kernel, render_head_kernel, pair_sigma_kernel, pair_field_perz_kernel):
        assert k.launches == 0 and k._lib is None
