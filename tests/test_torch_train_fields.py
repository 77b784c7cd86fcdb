"""The port's training forward (models/decoder.py compute_dtype,
render/fields.py) and the unfused renderers built on it, against the
reference package on the CPU: the same weights (JAX init, converted), the
same rays and signals made with numpy from a seed. A decoder of 4 blocks,
64 wide, z_dim 32 (the signal widths are the shipped ones).

Tolerances, each above the largest difference measured over these cases:
- float32: both stacks' rgb and weights, the hierarchical render and the
  unfused frame renderers within 1e-5 (measured at most 5.4e-7).
- bfloat16: the reference's jitted decoder rounds each product and bias add
  to bf16 except the colour layer's add, which XLA keeps in float32 (its
  rounding goes with the cast to float32 that follows); the port does the
  same. Over 2048 points 99.9% of the densities agree bit for bit, the rest
  by 1-2 bf16 ulps (bar 2% of the value), and colours agree to sum order
  (measured max 2.4e-4 where a flipped rounding lands, mean 4e-8; bars 1e-3
  and 1e-6). Ray batch: rgb max 4.6e-4, mean 1.7e-6 (bars 1e-3, 1e-5);
  weights 1.2e-4 (bar 5e-4). The unfused frame: max 3.1e-5, mean 1.0e-6
  (bars 2e-4, 1e-5).
"""

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
from dfanerf_tpu.models.decoder import apply_decoder
from dfanerf_tpu.render import fields as jf
from dfanerf_tpu.render.renderer import make_frame_renderer as j_make_frame_renderer
from dfanerf_tpu.render.renderer import (
    make_head_hierarchical_renderer as j_make_head_hierarchical_renderer,
)
from dfanerf_torch.compat.from_jax import params_to_state_dict
from dfanerf_torch.config import ExperimentConfig, RenderConfig
from dfanerf_torch.models import Decoder, DecoderConfig
from dfanerf_torch.render import fields as tf
from dfanerf_torch.render.renderer import make_frame_renderer, make_head_hierarchical_renderer

DEC = dict(hidden_size=64, n_blocks=4, skips=(2,), z_dim=32)
R, S = 96, 16


@pytest.fixture(scope="module")
def setup():
    jp = init_decoder(jax.random.PRNGKey(0), JDecoderConfig(**DEC))
    dec = Decoder(DecoderConfig(**DEC))
    dec.load_state_dict(params_to_state_dict(jax.tree.map(np.asarray, jp)))
    rng = np.random.RandomState(0)

    def rays():
        o = (rng.randn(R, 3) * 0.05 + [0.0, 0.0, 0.6]).astype(np.float32)
        d = (rng.randn(R, 3) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32)
        return o, d

    ro, rd = rays()
    ro_t, rd_t = rays()
    inp = {
        "ro": ro, "rd": rd, "ro_t": ro_t, "rd_t": rd_t,
        "z": np.sort(rng.uniform(0.3, 0.9, (R, S)).astype(np.float32), axis=1),
        "sig": rng.randn(96).astype(np.float32), "sig_t": rng.randn(42).astype(np.float32),
        "zs": rng.randn(2, 32).astype(np.float32), "za": rng.randn(2, 32).astype(np.float32),
        "bc": rng.rand(R, 3).astype(np.float32),
    }
    return jp, dec, inp


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _batch_args(inp, pkg):
    f = jnp.asarray if pkg == "jax" else _t
    return (f(inp["ro"]), f(inp["rd"]), f(inp["ro_t"]), f(inp["rd_t"]), f(inp["z"]),
            f(inp["sig"]), f(inp["sig_t"]), f(inp["zs"][0]), f(inp["za"][0]), f(inp["zs"][1]),
            f(inp["za"][1]), f(inp["bc"]))


@pytest.mark.parametrize("branch", ["head", "torso", "head_listener"])
def test_decoder_bf16_matches_reference_jit(setup, branch):
    jp, dec, inp = setup
    rng = np.random.RandomState(1)
    pts = (rng.randn(2048, 3) * 0.3).astype(np.float32)
    rd = rng.randn(2048, 3).astype(np.float32)
    sig = {"head": inp["sig"], "torso": inp["sig_t"], "head_listener": None}[branch]
    fj, sj = jax.jit(lambda p, a, b, c, d, s: apply_decoder(
        p, JDecoderConfig(**DEC), a, b, c, d, s, branch, compute_dtype=jnp.bfloat16))(
        jp, pts, rd, inp["zs"][0], inp["za"][0], sig)
    with torch.no_grad():
        ft, st = dec(_t(pts), _t(rd), _t(inp["zs"][0]), _t(inp["za"][0]),
                     None if sig is None else _t(sig), branch, compute_dtype=torch.bfloat16)
    assert ft.dtype == st.dtype == torch.float32
    err = np.abs(ft.numpy() - np.asarray(fj))
    assert err.max() < 1e-3 and err.mean() < 1e-6, (err.max(), err.mean())
    sj = np.asarray(sj)
    d = np.abs(st.numpy() - sj)
    assert (d <= 2e-2 * np.abs(sj)).all() and (d == 0).mean() > 0.99
    # float32 stays the oracle: compute_dtype=None is today's function
    f32, s32 = dec(_t(pts), _t(rd), _t(inp["zs"][0]), _t(inp["za"][0]),
                   None if sig is None else _t(sig), branch)
    fj32, sj32 = apply_decoder(jp, JDecoderConfig(**DEC), pts, rd, inp["zs"][0], inp["za"][0],
                               sig, branch)
    assert np.abs(f32.detach().numpy() - np.asarray(fj32)).max() < 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_branch", ["head", "head_listener"])
def test_render_ray_batch_matches_reference(setup, dtype, head_branch):
    jp, dec, inp = setup
    rj = JRenderConfig(n_samples=S, compute_dtype=dtype)
    rt = RenderConfig(n_samples=S, compute_dtype=dtype)
    ref = jax.jit(lambda p, *a: jf.render_ray_batch(
        p, JDecoderConfig(**DEC), rj, *a, head_branch=head_branch, return_weights=True))(
        jp, *_batch_args(inp, "jax"))
    with torch.no_grad():
        got = tf.render_ray_batch(dec, rt, *_batch_args(inp, "torch"), head_branch=head_branch,
                                  return_weights=True)
    names = ("rgb_head", "rgb_com", "w_head", "w_com")
    for name, g, r in zip(names, got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape and g.dtype == np.float32
        err = np.abs(g - r)
        if dtype == "float32":
            assert err.max() < 1e-5, (name, err.max())
        elif name.startswith("rgb"):
            assert err.max() < 1e-3 and err.mean() < 1e-5, (name, err.max(), err.mean())
        else:
            assert err.max() < 5e-4, (name, err.max())
    # without return_weights only the two colours come back
    with torch.no_grad():
        two = tf.render_ray_batch(dec, rt, *_batch_args(inp, "torch"), head_branch=head_branch)
    assert len(two) == 2 and torch.equal(two[0], got[0])


def test_render_ray_batch_gradients_reach_every_used_parameter(setup):
    """Autograd carries the bf16 products' gradients back to the float32
    master weights of both branches (and of the deformation field)."""
    _, dec, inp = setup
    rt = RenderConfig(n_samples=S, compute_dtype="bfloat16")
    dec.zero_grad(set_to_none=True)
    head, com = tf.render_ray_batch(dec, rt, *_batch_args(inp, "torch"))
    (head.sum() + com.sum()).backward()
    for name in ("fc_in", "fc_in_torso", "blocks.0", "deform_net.blocks_embed.0", "feat_out",
                 "sigma_out", "fc_view"):
        g = dec.get_submodule(name).weight.grad
        assert g is not None and g.dtype == torch.float32 and bool(g.abs().sum() > 0), name
    assert dec.fc_in_listener.weight.grad is None
    dec.zero_grad(set_to_none=True)


def test_render_head_hierarchical_matches_reference(setup):
    jp, dec, inp = setup
    rj = JRenderConfig(n_samples=S, n_importance=24)
    rt = RenderConfig(n_samples=S, n_importance=24)
    args = ("ro", "rd", "z", "sig")
    ref = jax.jit(lambda p, o, d, z, s, zs, za, bc: jf.render_head_hierarchical(
        p, JDecoderConfig(**DEC), rj, o, d, z, s, zs, za, bc))(
        jp, *(inp[k] for k in args), inp["zs"][0], inp["za"][0], inp["bc"])
    with torch.no_grad():
        got = tf.render_head_hierarchical(dec, rt, *(_t(inp[k]) for k in args),
                                          _t(inp["zs"][0]), _t(inp["za"][0]), _t(inp["bc"]))
    assert np.abs(got.numpy() - np.asarray(ref)).max() < 1e-5
    # with a generator the fine depths are random but the render is finite
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        rnd = tf.render_head_hierarchical(dec, rt, *(_t(inp[k]) for k in args),
                                          _t(inp["zs"][0]), _t(inp["za"][0]), _t(inp["bc"]),
                                          generator=g)
    assert rnd.shape == (R, 3) and bool(torch.isfinite(rnd).all())


@pytest.fixture(scope="module")
def scene(setup):
    jp, dec, _ = setup
    ds = make_synthetic_dataset(n_frames=4, H=24, W=24, n_samples_gt=8)
    rng = np.random.RandomState(2)
    sig = rng.randn(96).astype(np.float32) * 0.1
    sig_t = rng.randn(42).astype(np.float32) * 0.1
    zs, za = (rng.randn(2, 32).astype(np.float32) for _ in range(2))
    return ds, jp, dec, sig, sig_t, zs, za


class _Params(torch.nn.Module):
    def __init__(self, dec):
        super().__init__()
        self.decoder = dec


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unfused_frame_renderer_matches_reference(scene, dtype):
    """use_fused_kernel=False: render_ray_batch over tiles of tile_rays rays
    (here 200: two whole tiles and a ragged one)."""
    ds, jp, dec, sig, sig_t, zs, za = scene
    kw = dict(n_samples=S, compute_dtype=dtype, tile_rays=200)
    jcfg = JExperimentConfig(decoder=JDecoderConfig(**DEC), render=JRenderConfig(**kw))
    tcfg = ExperimentConfig(decoder=DecoderConfig(**DEC), render=RenderConfig(**kw))
    ref = j_make_frame_renderer(jcfg, ds.hwfcxy, ds.near, ds.far)(
        {"decoder": jp}, zs, za, ds.poses[1], ds.poses[0], sig, sig_t, ds.bc_img)
    got = make_frame_renderer(tcfg, ds.hwfcxy, ds.near, ds.far, device="cpu")(
        _Params(dec), zs, za, ds.poses[1], ds.poses[0], sig, sig_t, ds.bc_img)
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape == (24, 24, 3)
        err = np.abs(g - r)
        if dtype == "float32":
            assert err.max() < 1e-5, err.max()
        else:
            assert err.max() < 2e-4 and err.mean() < 1e-5, (err.max(), err.mean())


def test_unfused_hierarchical_renderer_matches_reference(scene):
    ds, jp, dec, sig, _, zs, za = scene
    kw = dict(n_samples=S, n_importance=16, tile_rays=256)
    jcfg = JExperimentConfig(decoder=JDecoderConfig(**DEC), render=JRenderConfig(**kw))
    tcfg = ExperimentConfig(decoder=DecoderConfig(**DEC), render=RenderConfig(**kw))
    ref = j_make_head_hierarchical_renderer(jcfg, ds.hwfcxy, ds.near, ds.far)(
        {"decoder": jp}, zs, za, ds.poses[2], sig, ds.bc_img)
    got = make_head_hierarchical_renderer(tcfg, ds.hwfcxy, ds.near, ds.far, device="cpu")(
        _Params(dec), zs, za, ds.poses[2], sig, ds.bc_img)
    assert got.shape == (24, 24, 3)
    assert np.abs(got.numpy() - np.asarray(ref)).max() < 1e-5
