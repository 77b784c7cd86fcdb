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
case: the masked reads must keep every output finite and equal.

The half-slab cases (4 samples per slab, occ_pack2) run the same bar on the
reference's buffers at s_slab=4, read through one flag set or through the
packed-2 partition (A: the even pairs of each field's tile-major list, B:
the odd ones). The packed-2 composite must also equal the one-list
composite of the port's own plain buffers within the reference's 3e-4
(tests/test_ops.py:444-504)."""

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
from dfanerf_torch.ops.pair_field import pair2_field_eval, pair_field_eval

j_pack = jax.jit(j_pack, static_argnums=(1, 5, 6))
BAR = 1e-6
N, S = 512, 16
PACK2_BAR = 3e-4
# [field, tile, half-slab] flags at 4 samples per slab: K = 6 and 5
OCC4 = np.array([[[1, 1, 0, 1], [0, 1, 1, 1]], [[0, 1, 1, 0], [1, 1, 0, 1]]], np.int32)


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

    def bufs4(pw, branch, o, d, flags):
        t_i, j_i = (jnp.asarray(x, jnp.int32) for x in np.nonzero(flags))
        return tuple(np.array(b.astype(jnp.float32)) for b in jf.pair_field_eval(
            pw, branch, jnp.asarray(o), jnp.asarray(d), z, t_i, j_i, interpret=True, s_slab=4))

    return {"buf_h": bufs(pw_h, "head", ro, rd, occ[0]),
            "buf_t": bufs(pw_t, "torso", ro_t, rd_t, occ[1]), "occ": occ, "rd": rd,
            "rd_t": rd_t, "z": np.array(z), "sh": np.array(sh_f), "ct": np.array(ct_f),
            "bc": rng.rand(N, 3).astype(np.float32), "pw": (pw_h, pw_t), "ro": ro, "ro_t": ro_t,
            "buf4_h": bufs4(pw_h, "head", ro, rd, OCC4[0]),
            "buf4_t": bufs4(pw_t, "torso", ro_t, rd_t, OCC4[1])}


def _with_nan(buf, flags, sp=8):
    """The buffer with NaN in every block its flags clear."""
    out = buf.copy().reshape(flags.shape[1], sp, flags.shape[0] + 1, 256)
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
    """Every option of deferred_composite is ported (the live keys of
    with_keys are held in tests/test_torch_live_serving.py); what it still
    refuses are operands that do not fit: a second quartet without its flag
    partition, and buffers of another sample count than the depths."""
    bufs = tuple(tuple(torch.from_numpy(b) for b in setup[k]) for k in ("buf_h", "buf_t"))
    rays = tuple(torch.from_numpy(setup[k]) for k in ("rd", "rd_t"))
    z = torch.from_numpy(setup["z"])
    occ = torch.from_numpy(setup["occ"])
    with pytest.raises(ValueError, match="come together"):
        deferred_composite(*bufs, occ, *rays, z, buf_h2=bufs[0], buf_t2=bufs[1])
    with pytest.raises(ValueError, match="samples"):
        deferred_composite(*bufs, occ, *rays, z[:8])
    out = deferred_composite(*bufs, occ, *rays, z, with_keys=True)
    assert len(out) == 5 and [tuple(k.shape) for k in out[4]] == [(2, 2)] * 4


def _partition(occ):
    """The packed-2 flag partition of [2, T, J] flags: (A, B), the even and
    odd pairs of each field's tile-major list."""
    occ_a, occ_b = np.zeros_like(occ), np.zeros_like(occ)
    for f in range(2):
        t_i, j_i = np.nonzero(occ[f])
        occ_a[f][t_i[0::2], j_i[0::2]] = 1
        occ_b[f][t_i[1::2], j_i[1::2]] = 1
    return occ_a, occ_b


@pytest.mark.parametrize("with_diagnostics", [True, False], ids=["diagnostics", "serving"])
@pytest.mark.parametrize("packed", [False, True], ids=["one-list", "packed-2"])
def test_deferred_composite_half_slabs_match(setup, with_diagnostics, packed):
    """s_slab=4 buffers, NaN in every block the flags they are read under
    clear; packed-2: the A and B quartets each hold only their own blocks."""
    flag_sets = _partition(OCC4) if packed else (OCC4,)
    quartets = [[tuple(_with_nan(b, flags[f], sp=4) for b in setup[key])
                 for f, key in enumerate(("buf4_h", "buf4_t"))] for flags in flag_sets]
    args = (setup["rd"], setup["rd_t"], setup["z"])
    kw = {"with_diagnostics": with_diagnostics, "s_slab": 4}
    if packed:
        kw_j = dict(kw, buf_h2=tuple(jnp.asarray(b) for b in quartets[1][0]),
                    buf_t2=tuple(jnp.asarray(b) for b in quartets[1][1]),
                    occ2=jnp.asarray(flag_sets[1]))
        kw_t = dict(kw, buf_h2=tuple(torch.from_numpy(b) for b in quartets[1][0]),
                    buf_t2=tuple(torch.from_numpy(b) for b in quartets[1][1]),
                    occ2=torch.from_numpy(flag_sets[1]))
    else:
        kw_j = kw_t = kw
    first = flag_sets[0]
    ref = jf.deferred_composite(*(tuple(jnp.asarray(b) for b in q) for q in quartets[0]),
                                jnp.asarray(first), *(jnp.asarray(x) for x in args), **kw_j)
    got = deferred_composite(*(tuple(torch.from_numpy(b) for b in q) for q in quartets[0]),
                             torch.from_numpy(first), *(torch.from_numpy(x) for x in args), **kw_t)
    assert len(got) == len(ref) == (8 if with_diagnostics else 4)
    shapes = [(N, 3), (N, 3), (N, 1), (N, 1)] + [(2, 4)] * 4
    for g, r, shape in zip(got, ref, shapes):
        assert tuple(g.shape) == np.asarray(r).shape == shape
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=BAR, rtol=0)


def test_packed2_composite_equals_one_list(setup):
    """The port's own plain buffers: the packed-2 evaluation composited
    under the A/B partition against the one-list evaluation at s_slab=4."""
    pw_h, pw_t = ({k: torch.tensor(np.asarray(v.astype(jnp.float32))).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32) for k, v in pw.items()}
        for pw in setup["pw"])
    ro, rd, ro_t, rd_t, z = (torch.from_numpy(setup[k]) for k in ("ro", "rd", "ro_t", "rd_t", "z"))
    occ = torch.from_numpy(OCC4)
    occ_a, occ_b = (torch.from_numpy(x) for x in _partition(OCC4))
    one, two = [], []
    for f, (pw, branch, o, d) in enumerate(((pw_h, "head", ro, rd), (pw_t, "torso", ro_t, rd_t))):
        t_i, j_i = (x.to(torch.int32) for x in torch.nonzero(occ[f], as_tuple=True))
        one.append(pair_field_eval(pw, branch, o, d, z, t_i, j_i, s_slab=4))
        two.append(pair2_field_eval(pw, branch, o, d, z, t_i[0::2], j_i[0::2], t_i[1::2],
                                    j_i[1::2], s_slab=4))
    ref = deferred_composite(one[0], one[1], occ, rd, rd_t, z, with_diagnostics=False, s_slab=4)
    got = deferred_composite(two[0][0], two[1][0], occ_a, rd, rd_t, z, with_diagnostics=False,
                             buf_h2=two[0][1], buf_t2=two[1][1], occ2=occ_b, s_slab=4)
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=PACK2_BAR, rtol=0)
