"""The port's frame renderer on the CPU against the reference package's
fused frame renderer in Pallas interpret mode: same synthetic scene, same
weights (JAX init, converted), signals from each package's own
encode_frame_signals.

Tolerances: signals 1e-5 (encoder bar); frames max 1.5e-5 and mean 1.5e-6,
about twice the measured max 7.5e-6 and mean 7.3e-7 (the renderer adds
only exact layout work around fused_render_rays, whose differences are
those of tests/test_torch_fused_render.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfanerf_tpu.config import ExperimentConfig as JExperimentConfig
from dfanerf_tpu.config import RenderConfig as JRenderConfig
from dfanerf_tpu.data import make_synthetic_dataset
from dfanerf_tpu.models import DecoderConfig as JDecoderConfig
from dfanerf_tpu.models import init_decoder
from dfanerf_tpu.models.encoders import init_audio_attnet, init_audionet_w2l, init_expression_enc
from dfanerf_tpu.render.renderer import encode_frame_signals as j_encode_frame_signals
from dfanerf_tpu.render.renderer import make_frame_renderer as j_make_frame_renderer
from dfanerf_torch.compat.from_jax import state_from_jax
from dfanerf_torch.config import ExperimentConfig, RenderConfig
from dfanerf_torch.data.synthetic import make_synthetic_scene
from dfanerf_torch.ops.fused_render import spatial_tile_permutation, spatial_untile
from dfanerf_torch.render.renderer import (
    encode_frame_signals, make_frame_renderer, render_video_frames,
)

RENDER = dict(n_samples=16, use_fused_kernel=True, compute_dtype="bfloat16", ert_eps=1e-4)


@pytest.fixture(scope="module")
def setup():
    ds = make_synthetic_dataset(n_frames=6, H=24, W=24, n_samples_gt=8)

    def init(key):
        ks = jax.random.split(key, 7)
        params = {
            "decoder": init_decoder(ks[0], JDecoderConfig()),
            "audnet": init_audionet_w2l(ks[1]),
            "expnet": init_expression_enc(ks[2]),
            "audattnet": init_audio_attnet(ks[3], 96, 4),
            "poseattnet": init_audio_attnet(ks[4], 42, 8),
        }
        return {"params": params, "z_shape": jax.random.normal(ks[5], (2, 256)),
                "z_app": jax.random.normal(ks[6], (2, 256)), "step": jnp.zeros((), jnp.int32)}

    jstate = jax.jit(init)(jax.random.PRNGKey(0))
    tstate = state_from_jax(jax.tree.map(np.asarray, jstate), ExperimentConfig(), device="cpu")
    return ds, jstate, tstate


def test_synthetic_scene_arrays_equal(setup):
    ds = setup[0]
    sc = make_synthetic_scene(n_frames=6, H=24, W=24)
    for k in ("poses", "auds", "exps", "bc_img", "sample_rects", "i_train", "i_val"):
        np.testing.assert_array_equal(getattr(sc, k), getattr(ds, k), err_msg=k)
    assert sc.hwfcxy == ds.hwfcxy and (sc.near, sc.far) == (ds.near, ds.far)


def test_spatial_tile_permutation_equal():
    from dfanerf_tpu.ops.fused_render import spatial_tile_permutation as j_perm

    for H, W in ((24, 24), (37, 50)):
        np.testing.assert_array_equal(spatial_tile_permutation(H, W).numpy(),
                                      np.asarray(j_perm(H, W)))


@pytest.mark.parametrize("H, W", [(24, 24), (37, 50), (450, 450)])
def test_spatial_untile_inverts_the_tile_gather(H, W):
    """Gathering an image by the permutation and untiling gives it back
    exactly: the renderer tiles rays and untiles colours this way."""
    img = torch.arange(H * W * 3, dtype=torch.float32).reshape(H, W, 3)
    tiled = img.reshape(-1, 3)[spatial_tile_permutation(H, W)]
    assert tiled.shape[0] % 256 == 0
    assert torch.equal(spatial_untile(tiled, H, W), img)


@pytest.mark.parametrize("spatial_tiles", [True, False], ids=["tiles", "scanline"])
def test_frames_match_reference(setup, monkeypatch, spatial_tiles):
    monkeypatch.setenv("DFANERF_PALLAS_INTERPRET", "1")
    ds, jstate, tstate = setup
    jcfg = JExperimentConfig(render=JRenderConfig(**RENDER, spatial_tiles=spatial_tiles))
    tcfg = ExperimentConfig(render=RenderConfig(**RENDER, spatial_tiles=spatial_tiles))
    j_render = j_make_frame_renderer(jcfg, ds.hwfcxy, ds.near, ds.far)
    t_render = make_frame_renderer(tcfg, ds.hwfcxy, ds.near, ds.far, device="cpu")
    j_sig = jax.jit(lambda p, i: j_encode_frame_signals(
        p, jnp.asarray(ds.auds), jnp.asarray(ds.exps), jnp.asarray(ds.poses), i, ds.n_frames,
        jcfg, True))
    tp = tstate["params"]
    auds, exps, poses = (torch.from_numpy(x) for x in (ds.auds, ds.exps, ds.poses))
    for i in (0, 1):
        sig_j, sig_t_j = j_sig(jstate["params"], jnp.int32(i))
        sig, sig_t = encode_frame_signals(tp, auds, exps, poses, i, ds.n_frames, tcfg, True)
        np.testing.assert_allclose(sig.numpy(), np.asarray(sig_j), atol=1e-5)
        np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_t_j), atol=1e-5)
        ref = j_render(jstate["params"], jstate["z_shape"], jstate["z_app"],
                       jnp.asarray(ds.poses[i]), jnp.asarray(ds.poses[0]), sig_j, sig_t_j,
                       jnp.asarray(ds.bc_img))
        got = t_render(tp, tstate["z_shape"], tstate["z_app"], ds.poses[i], ds.poses[0], sig,
                       sig_t, ds.bc_img)
        for g, r in zip(got, ref):
            g, r = g.numpy(), np.asarray(r)
            assert g.shape == r.shape == (24, 24, 3)
            err = np.abs(g - r)
            assert err.max() < 1.5e-5 and err.mean() < 1.5e-6, (i, err.max(), err.mean())


def test_render_video_frames(setup):
    """The sequence entry point renders what make_frame_renderer renders,
    with the torso camera pinned to frame 0, as uint8 frames."""
    ds, _, tstate = setup
    cfg = ExperimentConfig(render=RenderConfig(**RENDER, spatial_tiles=True))
    data = {"auds": ds.auds, "exps": ds.exps, "poses": ds.poses, "bc_img": ds.bc_img}
    com, head = render_video_frames(tstate, data, cfg, ds.hwfcxy, ds.near, ds.far, [2],
                                    use_smoothing=False, device="cpu")
    assert com.shape == head.shape == (1, 24, 24, 3) and com.dtype == np.uint8
    tp = tstate["params"]
    sig, sig_t = encode_frame_signals(tp, *(torch.from_numpy(x) for x in (
        ds.auds, ds.exps, ds.poses)), 2, ds.n_frames, cfg, False)
    render = make_frame_renderer(cfg, ds.hwfcxy, ds.near, ds.far, device="cpu")
    h, c = render(tp, tstate["z_shape"], tstate["z_app"], ds.poses[2], ds.poses[0], sig, sig_t,
                  ds.bc_img)
    np.testing.assert_array_equal(com[0], (c.clamp(0, 1) * 255).to(torch.uint8).numpy())
    np.testing.assert_array_equal(head[0], (h.clamp(0, 1) * 255).to(torch.uint8).numpy())


def test_unported_configurations_raise():
    """The DeepSpeech audio net behind the head's signal, refused here until
    it was ported, now builds and encodes ([N, 16, 29] windows through
    AudioNet; held against the reference in tests/test_torch_audio_signals.py).
    What is not ported raises, naming its ROADMAP place: the cli's
    ``bench``. (Config 3's live levers, refused here until they were
    ported, are held in tests/test_torch_live_serving.py; the cli's
    identity directories and driving manifests, in
    tests/test_torch_audface_loader.py; the cli's ``process``, in
    tests/test_torch_process_dag.py: without its arguments it stops at
    argparse's usage error.)"""
    from dfanerf_torch import cli
    from dfanerf_torch.models import AudioNet
    from dfanerf_torch.train.state import init_train_state

    base = ExperimentConfig(render=RenderConfig(**RENDER))
    cfg = dataclasses.replace(base, signal=dataclasses.replace(base.signal,
                                                               audio_net="deepspeech"))
    state = init_train_state(cfg, seed=0, device="cpu")
    assert isinstance(state["params"].audnet, AudioNet)
    auds = torch.from_numpy(np.random.RandomState(0).randn(4, 16, 29).astype(np.float32))
    exps = torch.zeros(4, 64)
    poses = torch.eye(4).expand(4, 4, 4)
    for smooth in (False, True):
        sig, sig_t = encode_frame_signals(state["params"], auds, exps, poses, 1, 4, cfg, smooth)
        assert sig.shape == (96,) and sig_t.shape == (42,) and bool(torch.isfinite(sig).all())
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 3"):
        cli.main(["bench"])
    with pytest.raises(SystemExit):
        cli.main(["process"])
