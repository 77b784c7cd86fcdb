"""Reference checkpoints into the port, against the reference package: the
converters of compat/torch_ckpt.py and models/legacy.py, the driving
manifests, ndc_rays, the decoder's gauss positional encoding, and the
slice as a whole: a reference-layout ``{:06d}.tar`` read by both packages'
``load_reference_checkpoint`` and rendered by both ``render_video_frames``
over both ``driving_manifest``s (the reference in Pallas interpret mode,
the port on its plain versions).

The reference's own modules are not in this repository, so the tests write
the reference's layout themselves: the key names are those the reference
package's converters read, the values JAX-initialised arrays put back in
torch's layouts (tests/reference_tar.py, the inverse of the converters), saved with
``torch.save``. The .tar holds the eight entries the loaders read and the
two optimizer states neither reads.

Bars: conversions, manifests and gauss_B_matrices bit for bit; ndc_rays,
the legacy nets and the gauss-PE decoder (float32) within 1e-5; the
rendered frames within tests/test_torch_renderer.py's bars, max 1.5e-5
and mean 1.5e-6 on the float frames, and so the uint8 frames equal but
for 1-LSB flips where a float lies within that bar of a rounding edge."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfanerf_torch.render.renderer as t_renderer
from dfanerf_tpu.compat.torch_ckpt import load_reference_checkpoint as j_load
from dfanerf_tpu.config import ExperimentConfig as JExperimentConfig
from dfanerf_tpu.config import RenderConfig as JRenderConfig
from dfanerf_tpu.models import DecoderConfig as JDecoderConfig
from dfanerf_tpu.models import init_decoder
from dfanerf_tpu.models.encoders import init_audio_attnet, init_audionet_w2l, init_expression_enc
from dfanerf_torch.compat.from_jax import params_to_state_dict
from dfanerf_torch.compat.torch_ckpt import load_reference_checkpoint, reference_train_state
from dfanerf_torch.config import ExperimentConfig, RenderConfig
from dfanerf_torch.data.synthetic import make_synthetic_scene
from reference_tar import REF_ENTRIES, reference_tar

RENDER = dict(n_samples=16, use_fused_kernel=True, compute_dtype="bfloat16", ert_eps=1e-4,
              spatial_tiles=True)
FRAME_MAX, FRAME_MEAN = 1.5e-5, 1.5e-6
ENTRIES = REF_ENTRIES  # the .tar's entry of each net


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch single-threaded for this module: small tensors, six suite workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jstate():
    def init(key):
        ks = jax.random.split(key, 7)
        return {"params": {"decoder": init_decoder(ks[0], JDecoderConfig()),
                           "audnet": init_audionet_w2l(ks[1]), "expnet": init_expression_enc(ks[2]),
                           "audattnet": init_audio_attnet(ks[3], 96, 4),
                           "poseattnet": init_audio_attnet(ks[4], 42, 8)},
                "z_shape": jax.random.normal(ks[5], (1, 2, 256)),
                "z_app": jax.random.normal(ks[6], (1, 2, 256))}

    return jax.tree.map(np.asarray, jax.jit(init)(jax.random.PRNGKey(0)))


def reference_layout(state, nets=tuple(ENTRIES), step=123456):
    """The reference's .tar dict of a reference-package state (numpy), by
    reference_tar.py's inverse of the converters."""
    return reference_tar({k: params_to_state_dict(state["params"][k]) for k in nets},
                         torch.tensor(state["z_shape"][0]), torch.tensor(state["z_app"][0]), step)


@pytest.fixture(scope="module")
def tar(jstate, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "123456.tar")
    torch.save(reference_layout(jstate), path)
    return path


def test_checkpoint_conversion_is_exact(jstate, tar):
    """Every converted tensor equals the reference package's conversion bit
    for bit, under the port's key of the same layer."""
    got = load_reference_checkpoint(tar, device="cpu")
    ref = jax.tree.map(np.asarray, j_load(tar))
    assert got["global_step"] == ref["global_step"] == 123456
    for k in ("z_shape", "z_app"):
        assert got[k].shape == (1, 2, 256)
        np.testing.assert_array_equal(got[k].numpy(), ref[k])
    for key in ENTRIES:
        want = params_to_state_dict(ref[key])
        assert sorted(got[key]) == sorted(want), key
        for k, v in want.items():
            assert got[key][k].dtype == torch.float32
            np.testing.assert_array_equal(got[key][k].numpy(), v.numpy(), err_msg=f"{key}.{k}")
    state = reference_train_state(got, ExperimentConfig(), device="cpu")
    for key in ENTRIES:
        for k, v in getattr(state["params"], key).state_dict().items():
            assert torch.equal(v, got[key][k])
    assert state["z_shape"].shape == (2, 256) and state["step"] == 123456


def test_converted_tensors_do_not_share_storage(jstate):
    """A reference state dict mutated in place after the conversion leaves
    the converted tensors as they were (the reference package's _np copy)."""
    from dfanerf_torch.compat.torch_ckpt import audio_attnet_from_torch, decoder_from_torch

    ref = reference_layout(jstate)
    dec, att = ref[ENTRIES["decoder"]], ref[ENTRIES["audattnet"]]
    got_dec, got_att = decoder_from_torch(dec), audio_attnet_from_torch(att)
    before = {k: v.clone() for k, v in {**got_dec, **got_att}.items()}
    for sd in (dec, att):
        for v in sd.values():
            v.add_(1.0)
    for k, v in {**got_dec, **got_att}.items():
        assert torch.equal(v, before[k]), k


def test_missing_nets_are_left_out(jstate, tmp_path):
    """A checkpoint of the decoder alone loads in both packages with the
    same keys; the train state keeps the seeded signal nets."""
    path = str(tmp_path / "000010.tar")
    torch.save(reference_layout(jstate, nets=("decoder",), step=10), path)
    got, ref = load_reference_checkpoint(path, device="cpu"), j_load(path)
    assert sorted(got) == sorted(ref) == ["decoder", "global_step", "z_app", "z_shape"]
    from dfanerf_torch.train.state import init_train_state

    seeded = reference_train_state(got, ExperimentConfig(), device="cpu")
    fresh = init_train_state(ExperimentConfig(), device="cpu")
    for a, b in zip(seeded["params"].audnet.parameters(), fresh["params"].audnet.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("use_viewdirs", [False, True], ids=["no-viewdirs", "viewdirs"])
def test_legacy_nets_match_reference(use_viewdirs):
    from dfanerf_tpu.models import legacy as jl
    from dfanerf_torch.models.legacy import (
        FaceNeRF, VanillaNeRF, facenerf_from_torch, vanilla_nerf_from_torch,
    )

    rng = np.random.RandomState(0)
    kw = dict(D=8, W=64, use_viewdirs=use_viewdirs)
    for j_init, j_apply, j_conv, t_net, t_conv, d_in in (
            (jl.init_facenerf, jl.apply_facenerf, jl.facenerf_from_torch, FaceNeRF,
             facenerf_from_torch, 3 + 76 + 3),
            (jl.init_vanilla_nerf, jl.apply_vanilla_nerf, jl.vanilla_nerf_from_torch, VanillaNeRF,
             vanilla_nerf_from_torch, 3 + 3)):
        params = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(1), **kw))
        sd = params_to_state_dict(params)  # the reference's keys and layouts
        assert jax.tree.all(jax.tree.map(np.array_equal, j_conv(sd), params))
        net = t_net(**kw)
        converted = t_conv(sd)
        net.load_state_dict(converted, strict=True)
        for k, v in sd.items():
            assert torch.equal(converted[k], v) and converted[k].data_ptr() != v.data_ptr()
        x = rng.randn(50, d_in).astype(np.float32)
        ref = np.asarray(j_apply(params, jnp.asarray(x), use_viewdirs=use_viewdirs))
        with torch.no_grad():
            got = net(torch.from_numpy(x)).numpy()
        assert got.shape == ref.shape == (50, 4)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_ndc_rays_match_reference():
    from dfanerf_tpu.core.rays import ndc_rays as j_ndc
    from dfanerf_torch.core.rays import ndc_rays

    rng = np.random.RandomState(2)
    o = (rng.randn(64, 3) * 0.1 + [0, 0, 0.5]).astype(np.float32)
    d = (rng.randn(64, 3) * 0.2 + [0, 0, -1]).astype(np.float32)
    got = ndc_rays(378, 504, 407.5, 1.0, torch.from_numpy(o), torch.from_numpy(d))
    ref = j_ndc(378, 504, 407.5, 1.0, jnp.asarray(o), jnp.asarray(d))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=1e-6)


def _manifest(scene):
    _, _, focal, cx, cy = scene.hwfcxy
    return {"focal_len": focal, "cx": cx, "cy": cy,
            "frames": [{"img_id": int(i), "aud_id": int(i),
                        "transform_matrix": scene.poses[i].tolist()} for i in scene.i_train]}


def test_manifests_match_reference():
    from dfanerf_tpu.pipeline import manifests as jm
    from dfanerf_torch.pipeline.manifests import driving_manifest, multi_window_manifest

    man = _manifest(make_synthetic_scene(n_frames=12, H=24, W=24))
    for n, scale, static in ((6, 0.5, 0), (20, 1.5, 3)):
        for a, b in zip(driving_manifest(man, n, scale, static),
                        jm.driving_manifest(man, n, scale, static)):
            assert json.dumps(a) == json.dumps(b)
    for n, window, seed in ((8, 3, 0), (25, 4, 7), (5, 100, 1)):
        got = multi_window_manifest(man, n, window, seed)
        assert json.dumps(got) == json.dumps(jm.multi_window_manifest(man, n, window, seed))
        assert len(got["frames"]) == n


def test_gauss_pe_matches_reference():
    """gauss_B_matrices bit for bit (numpy's seed-42 draws, B_pos first);
    gauss_posenc and the gauss-mode decoder's three branches in float32
    within 1e-5; the training renderer runs it too; the kernels' weight
    packing refuses it."""
    from dfanerf_tpu.core.posenc import gauss_B_matrices as j_gB
    from dfanerf_tpu.core.posenc import gauss_posenc as j_gpe
    from dfanerf_tpu.models import apply_decoder
    from dfanerf_tpu.render.fields import render_ray_batch as j_rrb
    from dfanerf_torch.compat.from_jax import params_to_state_dict as to_sd
    from dfanerf_torch.core.posenc import gauss_B_matrices, gauss_posenc
    from dfanerf_torch.models import Decoder, DecoderConfig
    from dfanerf_torch.ops.pack import pack_field_weights
    from dfanerf_torch.render.fields import render_ray_batch

    for dims in ((10, 4, 4.0), (6, 2, 1.5)):
        for g, r in zip(gauss_B_matrices(*dims), j_gB(*dims)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    rng = np.random.RandomState(3)
    p = rng.randn(40, 3).astype(np.float32) * 0.3
    B = gauss_B_matrices()[0]
    np.testing.assert_allclose(gauss_posenc(torch.from_numpy(p), B, 2.0).numpy(),
                               np.asarray(j_gpe(jnp.asarray(p), jnp.asarray(B.numpy()), 2.0)),
                               atol=1e-5, rtol=0)

    jcfg = JDecoderConfig(hidden_size=64, z_dim=32, positional_encoding="gauss")
    params = jax.tree.map(np.asarray, jax.jit(lambda k: init_decoder(k, jcfg))(
        jax.random.PRNGKey(4)))
    dec = Decoder(DecoderConfig(**dataclasses.asdict(jcfg)))
    dec.load_state_dict(to_sd(params), strict=True)
    rd = rng.randn(40, 3).astype(np.float32)
    zs, za = (rng.randn(32).astype(np.float32) for _ in range(2))
    sigs = {"head": rng.randn(96).astype(np.float32), "torso": rng.randn(42).astype(np.float32),
            "head_listener": None}
    j_apply = jax.jit(apply_decoder, static_argnums=(1, 7))
    with torch.no_grad():
        for branch, sig in sigs.items():
            ref = j_apply(params, jcfg, jnp.asarray(p), jnp.asarray(rd), jnp.asarray(zs),
                          jnp.asarray(za), None if sig is None else jnp.asarray(sig), branch)
            got = dec(torch.from_numpy(p), torch.from_numpy(rd), torch.from_numpy(zs),
                      torch.from_numpy(za), None if sig is None else torch.from_numpy(sig), branch)
            for g, r in zip(got, ref):
                np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=0,
                                           err_msg=branch)
        z = np.broadcast_to(np.linspace(0.3, 0.9, 8, dtype=np.float32), (40, 8)).copy()
        bc = rng.rand(40, 3).astype(np.float32)
        args = [p, rd, p, rd, z, sigs["head"], sigs["torso"], zs, za, zs, za, bc]
        from dfanerf_tpu.config import RenderConfig as JRC

        ref = jax.jit(j_rrb, static_argnums=(1, 2))(params, jcfg, JRC(n_samples=8),
                                                    *(jnp.asarray(a) for a in args))
        got = render_ray_batch(dec, RenderConfig(n_samples=8), *(torch.from_numpy(a) for a in args))
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="normal"):
        pack_field_weights(dec, torch.zeros(96), torch.zeros(32), torch.zeros(32), "head")


def test_reference_checkpoint_renders_driving_frames(jstate, tar, monkeypatch):
    """The slice: both packages read the same .tar, build the same driving
    poses (param_scale 0.5) from the same manifest, and render them through
    render_video_frames on the dense render_rays path."""
    import dfanerf_tpu.render.renderer as j_renderer
    from dfanerf_tpu.pipeline.manifests import driving_manifest as j_driving
    from dfanerf_torch.pipeline.manifests import driving_manifest

    monkeypatch.setenv("DFANERF_PALLAS_INTERPRET", "1")
    scene = make_synthetic_scene(n_frames=6, H=24, W=24)
    man = _manifest(scene)
    drive, ref_drive = driving_manifest(man, 4, 0.5)[0], j_driving(man, 4, 0.5)[0]
    assert json.dumps(drive) == json.dumps(ref_drive)
    poses = np.array([f["transform_matrix"] for f in drive["frames"]], np.float32)
    data = {"auds": scene.auds[:4], "exps": scene.exps[:4], "poses": poses,
            "bc_img": scene.bc_img}
    floats = {}
    for name, module in (("port", t_renderer), ("reference", j_renderer)):
        real = module.make_frame_renderer

        def recording(*a, _real=real, _name=name, **kw):
            render = _real(*a, **kw)
            floats[_name] = []
            return lambda *fa: floats[_name].append(render(*fa)) or floats[_name][-1]

        monkeypatch.setattr(module, "make_frame_renderer", recording)

    ck = j_load(tar)
    j_state = {"params": {k: ck[k] for k in ENTRIES}, "z_shape": ck["z_shape"][0],
               "z_app": ck["z_app"][0]}
    j_com, j_head = j_renderer.render_video_frames(
        j_state, {k: jnp.asarray(v) for k, v in data.items()},
        JExperimentConfig(render=JRenderConfig(**RENDER)), scene.hwfcxy, scene.near, scene.far,
        range(2))
    state = reference_train_state(load_reference_checkpoint(tar, device="cpu"),
                                  ExperimentConfig(), device="cpu")
    com, head = t_renderer.render_video_frames(
        state, data, ExperimentConfig(render=RenderConfig(**RENDER)), scene.hwfcxy, scene.near,
        scene.far, range(2), device="cpu")
    assert com.shape == head.shape == (2, 24, 24, 3) and com.dtype == np.uint8
    for (g_head, g_com), (r_head, r_com) in zip(floats["port"], floats["reference"]):
        for g, r in ((g_head, r_head), (g_com, r_com)):
            err = np.abs(g.numpy() - np.asarray(r))
            assert err.max() < FRAME_MAX and err.mean() < FRAME_MEAN, (err.max(), err.mean())
    for g, r, fl in ((com, j_com, [np.asarray(c) for _, c in floats["reference"]]),
                     (head, j_head, [np.asarray(h) for h, _ in floats["reference"]])):
        d = np.abs(g.astype(np.int16) - np.asarray(r).astype(np.int16))
        edge = np.abs(np.clip(np.stack(fl), 0, 1) * 255 - np.round(np.clip(np.stack(fl), 0, 1)
                                                                     * 255))
        assert d.max() <= 1 and (d == 0)[edge > FRAME_MAX * 255].all()
