"""The port's deferred_composite and bg_blend (plain PyTorch) against the
reference package's (XLA on the CPU), on the same buffers: the reference's
pair_field_eval output (interpret mode) for a pair list with gaps, read
through the same flags.

The two sides run the same expressions; what differs is the order of the
float32 transmittance products (XLA's cumprod against torch.cumprod) and
of the sums over samples. Measured over these cases: largest difference
2.4e-7 on the accumulated colours and transmittances (final transmittances
down to 0.052), 1.2e-7 on the per-(tile, slab) diagnostics, 0 on the blend;
the bar is 1e-6 on all of them. Unlisted
blocks hold NaN (standing in for the kernel's unwritten memory) in one
case: the masked reads must keep every output finite and equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfanerf_tpu.models import DecoderConfig as JDecoderConfig
from dfanerf_tpu.models import init_decoder
from dfanerf_tpu.ops import fused_render as jf
from dfanerf_tpu.ops.pack import pack_field_weights as j_pack
from dfanerf_torch.ops.composite import bg_blend, deferred_composite

j_pack = jax.jit(j_pack, static_argnums=(1, 5, 6))
BAR = 1e-6
N, S = 512, 16


@pytest.fixture(scope="module")
def setup():
    params = jax.jit(lambda k: init_decoder(k, JDecoderConfig()))(jax.random.PRNGKey(0))
    # a density bias of 3 makes the transmittances fall well below 1, so the
    # cumprod and the diagnostics carry real values
    params["sigma_out"] = {"w": params["sigma_out"]["w"], "b": jnp.full((1,), 3.0)}
    rng = np.random.RandomState(4)
    sh, st, zs, za = (jnp.asarray(rng.randn(k).astype(np.float32)) for k in (96, 42, 256, 256))
    pw_h = j_pack(params, JDecoderConfig(), sh, zs, za, "head", jnp.bfloat16)
    pw_t = j_pack(params, JDecoderConfig(), st, zs, za, "torso", jnp.bfloat16)
    ro, ro_t = ((rng.randn(N, 3) * 0.05).astype(np.float32) for _ in range(2))
    rd, rd_t = ((rng.randn(N, 3) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32) for _ in range(2))
    z = jnp.linspace(0.3, 0.9, S)
    occ = np.array([[[1, 0], [1, 1]], [[0, 1], [1, 1]]], np.int32)  # [field, tile, slab]

    def bufs(pw, branch, o, d, flags):
        t_i, j_i = (jnp.asarray(x, jnp.int32) for x in np.nonzero(flags))
        return tuple(np.array(b.astype(jnp.float32)) for b in jf.pair_field_eval(
            pw, branch, jnp.asarray(o), jnp.asarray(d), z, t_i, j_i, interpret=True))

    sh_f, ct_f = jf.fused_far_eval_split(pw_h, pw_t, *(jnp.asarray(x) for x in (ro, rd, ro_t, rd_t)),
                                         z[-1], interpret=True)
    return {"buf_h": bufs(pw_h, "head", ro, rd, occ[0]),
            "buf_t": bufs(pw_t, "torso", ro_t, rd_t, occ[1]), "occ": occ, "rd": rd,
            "rd_t": rd_t, "z": np.array(z), "sh": np.array(sh_f), "ct": np.array(ct_f),
            "bc": rng.rand(N, 3).astype(np.float32)}


def _with_nan(buf, flags):
    """The buffer with NaN in every block its flags clear."""
    out = buf.copy().reshape(flags.shape[1], 8, flags.shape[0] + 1, 256)
    for t in range(flags.shape[0]):
        for j in range(flags.shape[1]):
            if not flags[t, j]:
                out[j, :, t] = np.nan
    out[:, :, -1] = np.nan  # the never-written row past the last tile
    return out.reshape(buf.shape)


def _both(setup, nan, with_diagnostics):
    occ = setup["occ"]
    buf_h = tuple(_with_nan(b, occ[0]) if nan else b for b in setup["buf_h"])
    buf_t = tuple(_with_nan(b, occ[1]) if nan else b for b in setup["buf_t"])
    ref = jf.deferred_composite(
        tuple(jnp.asarray(b) for b in buf_h),
        tuple(jnp.asarray(b) for b in buf_t), jnp.asarray(occ), jnp.asarray(setup["rd"]),
        jnp.asarray(setup["rd_t"]), jnp.asarray(setup["z"]), with_diagnostics=with_diagnostics)
    got = deferred_composite(
        tuple(torch.from_numpy(b) for b in buf_h), tuple(torch.from_numpy(b) for b in buf_t),
        torch.from_numpy(occ), torch.from_numpy(setup["rd"]), torch.from_numpy(setup["rd_t"]),
        torch.from_numpy(setup["z"]), with_diagnostics=with_diagnostics)
    return got, [np.asarray(r) for r in ref]


@pytest.mark.parametrize("with_diagnostics", [True, False], ids=["diagnostics", "serving"])
@pytest.mark.parametrize("nan", [False, True], ids=["clean", "nan-unlisted"])
def test_deferred_composite_matches(setup, with_diagnostics, nan):
    got, ref = _both(setup, nan, with_diagnostics)
    assert len(got) == len(ref) == (8 if with_diagnostics else 4)
    shapes = [(N, 3), (N, 3), (N, 1), (N, 1)] + [(2, 2)] * 4
    for g, r, shape in zip(got, ref, shapes):
        assert tuple(g.shape) == r.shape == shape
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), r, atol=BAR, rtol=0)
    if with_diagnostics:  # the case has transmittances well below 1
        assert float(got[2].min()) < 0.5


def test_bg_blend_matches(setup):
    got, _ = _both(setup, True, False)
    ah, ac, th, tc = (g.numpy() for g in got)
    ref = jf.bg_blend(jnp.asarray(setup["sh"]), jnp.asarray(setup["ct"]), jnp.asarray(setup["rd"]),
                      jnp.asarray(setup["rd_t"]), jnp.asarray(setup["bc"]), 1e10,
                      *(jnp.asarray(x) for x in (ah, ac, th, tc)))
    out = bg_blend(*(torch.from_numpy(x) for x in (setup["sh"], setup["ct"], setup["rd"],
                                                   setup["rd_t"], setup["bc"])), 1e10,
                   *(torch.from_numpy(x) for x in (ah, ac, th, tc)))
    for g, r in zip(out, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=BAR, rtol=0)


def test_unported_options_raise(setup):
    args = (setup["buf_h"], setup["buf_t"], setup["occ"], setup["rd"], setup["rd_t"], setup["z"])
    for kw in ({"buf_h2": setup["buf_h"]}, {"s_slab": 4}, {"with_ray_diag": True},
               {"ray_err_bc": setup["bc"]}, {"with_keys": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            deferred_composite(*args, **kw)
