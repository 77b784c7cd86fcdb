"""The port's half-slab pair evaluations (plain PyTorch versions, on the
CPU) against the reference package's run in Pallas interpret mode, on the
same packed weights, rays and pair lists: pair_field_eval at 4 samples per
slab, and the packed-2 pair2_field_eval_prepped at 4 and 8 samples per slab
(the reference's ``s_slab``), whose A and B lists are the even and odd
pairs of a field's tile-major list.

The setup of tests/test_torch_pair_field.py (two tiles, 32 samples: 8
half-slabs or 4 slabs) and its bars: sigma max 1e-3 and mean 1e-5, the
bf16 colours at most one bf16 ulp apart in at most 1% of the listed
entries. Only listed blocks are compared. Each slab size's list has gaps
and an odd K = 5, so A holds 3 pairs and B 2; the reference pads B to A's
length with a pair on its dummy tile row (as tests/test_ops.py:484-486
does), the port lists exactly the pairs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfanerf_tpu.models import DecoderConfig as JDecoderConfig
from dfanerf_tpu.models import init_decoder
from dfanerf_tpu.ops import fused_render as jf
from dfanerf_tpu.ops.pack import pack_field_weights as j_pack
from dfanerf_torch.ops.fused_render import view_bias
from dfanerf_torch.ops.pair_field import (
    pair2_field_eval_prepped, pair2_field_kernel, pair_field_eval, pair_field_kernel,
)

j_pack = jax.jit(j_pack, static_argnums=(1, 5, 6))
SIG_MAX, SIG_MEAN, RGB_ULPS, RGB_FRAC = 1e-3, 1e-5, 1.0, 0.01
N, S, SP = 512, 32, 4  # two tiles, eight half-slabs
J, T = S // SP, N // 256
# tile 0 half-slabs 0, 1, 3 and tile 1 half-slabs 2, 7: K = 5
OCC = np.zeros((T, J), np.int32)
OCC[0, [0, 1, 3]] = 1
OCC[1, [2, 7]] = 1
# at 8 samples per slab (four slabs): tile 0 slabs 0, 1, 3 and tile 1 slabs 2, 3: K = 5
OCC8 = np.zeros((T, S // 8), np.int32)
OCC8[0, [0, 1, 3]] = 1
OCC8[1, [2, 3]] = 1
SLABS = (4, 8)


@pytest.fixture(scope="module")
def setup():
    params = jax.jit(lambda k: init_decoder(k, JDecoderConfig()))(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    vecs = [jnp.asarray(rng.randn(k).astype(np.float32)) for k in (96, 42, 256, 256)]
    o = (rng.randn(N, 3) * 0.05).astype(np.float32)
    d = (rng.randn(N, 3) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32)
    return {"params": params, "vecs": vecs, "o": o, "d": d,
            "z": np.array(jnp.linspace(0.3, 0.9, S))}


def _to_torch(pw):
    return {k: torch.tensor(np.asarray(v.astype(jnp.float32))).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32) for k, v in pw.items()}


def _pack(setup, branch):
    sig = setup["vecs"][0] if branch == "head" else setup["vecs"][1]
    return j_pack(setup["params"], JDecoderConfig(), sig, setup["vecs"][2], setup["vecs"][3],
                  branch, jnp.bfloat16)


def _ulps(a, b):
    """|a - b| in bf16 ulps of b (bf16 has 8 significant bits)."""
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
    return np.abs(a - b) / step


def _listed(t_i, j_i, sp=SP):
    m = np.zeros((S // sp, sp, T + 1, 256), bool)
    m[j_i, :, t_i, :] = True
    return m.reshape(S // sp, sp, -1)


def _occ(sp):
    return OCC if sp == SP else OCC8


def _assert_close(got, ref, listed):
    """Port quartet vs reference quartet on the listed blocks; NaN elsewhere."""
    shape = listed.shape[:2] + (768,)
    assert [tuple(g.shape) for g in got] == [tuple(r.shape) for r in ref] == [shape] * 4
    assert got[0].dtype == torch.float32 and all(g.dtype == torch.bfloat16 for g in got[1:])
    got = [g.float().numpy() for g in got]
    ref = [np.asarray(r.astype(jnp.float32)) for r in ref]
    err = np.abs(got[0][listed] - ref[0][listed])
    assert err.max() < SIG_MAX and err.mean() < SIG_MEAN, (err.max(), err.mean())
    for g, r in zip(got[1:], ref[1:]):
        ulps = _ulps(g[listed], r[listed])
        assert ulps.max() <= RGB_ULPS and (ulps > 0).mean() < RGB_FRAC, (ulps.max(),
                                                                          (ulps > 0).mean())
    assert all(np.isnan(g[~listed]).all() for g in got)


def _split(occ):
    """The field's tile-major list and its even/odd (A, B) halves, int32."""
    t_i, j_i = (x.astype(np.int32) for x in np.nonzero(occ))
    return (t_i, j_i), (t_i[0::2], j_i[0::2]), (t_i[1::2], j_i[1::2])


def _reference_pair2(pw, branch, setup, a, b, act, sp=SP):
    """The reference's packed-2 evaluation, B padded with a dummy-tile pair."""
    tb, jb = b
    if len(tb) < len(a[0]):
        tb, jb = np.append(tb, T).astype(np.int32), np.append(jb, 0).astype(np.int32)
    o, d = jnp.asarray(setup["o"]), jnp.asarray(setup["d"])
    pad = jnp.zeros((256, jf.PE_PAD))
    o_r = jnp.concatenate([jf.pe_replicate(o), pad])
    d_r = jnp.concatenate([jf.pe_replicate(d), pad])
    vr = jnp.concatenate([jf.view_bias(pw, d).astype(jnp.bfloat16),
                          jnp.zeros((256, 256), jnp.bfloat16)])
    return jf.pair2_field_eval_prepped(pw, branch, o_r, d_r, vr, jnp.asarray(setup["z"]),
                                       *(jnp.asarray(x) for x in (*a, tb, jb)), interpret=True,
                                       act=act, s_slab=sp)


def _port_pair2(pw, branch, setup, a, b, act, sp=SP):
    o, d, z = (torch.from_numpy(setup[k]) for k in ("o", "d", "z"))
    vr = view_bias(pw, d).to(torch.bfloat16).contiguous()
    return pair2_field_eval_prepped(pw, branch, o, d, vr, z,
                                    *(torch.from_numpy(x) for x in (*a, *b)), act, sp)


@pytest.mark.parametrize("branch", ["head", "torso"])
@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_pair_field_half_slabs_match_interpret_kernel(setup, branch, act):
    pw = _pack(setup, branch)
    (t_i, j_i), _, _ = _split(OCC)
    ref = jf.pair_field_eval(pw, branch, jnp.asarray(setup["o"]), jnp.asarray(setup["d"]),
                             jnp.asarray(setup["z"]), jnp.asarray(t_i), jnp.asarray(j_i),
                             interpret=True, act=act, s_slab=SP)
    got = pair_field_eval(_to_torch(pw), branch, torch.from_numpy(setup["o"]),
                          torch.from_numpy(setup["d"]), torch.from_numpy(setup["z"]),
                          torch.from_numpy(t_i), torch.from_numpy(j_i), act, SP)
    _assert_close(got, ref, _listed(t_i, j_i))


@pytest.mark.parametrize("sp", SLABS)
@pytest.mark.parametrize("branch", ["head", "torso"])
@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_pair2_matches_interpret_kernel(setup, branch, act, sp):
    pw = _pack(setup, branch)
    _, a, b = _split(_occ(sp))
    assert (len(a[0]), len(b[0])) == (3, 2)
    ref_a, ref_b = _reference_pair2(pw, branch, setup, a, b, act, sp)
    got_a, got_b = _port_pair2(_to_torch(pw), branch, setup, a, b, act, sp)
    _assert_close(got_a, ref_a, _listed(*a, sp))
    _assert_close(got_b, ref_b, _listed(*b, sp))


@pytest.mark.parametrize("sp", SLABS)
def test_pair2_quartets_equal_pair_field_on_a_and_b(setup, sp):
    """A and B quartets equal pair_field's on the A and B lists bit for bit
    (the listed blocks; NaN in the same places elsewhere)."""
    pw = _to_torch(_pack(setup, "torso"))
    _, a, b = _split(_occ(sp))
    got = _port_pair2(pw, "torso", setup, a, b, "softplus", sp)
    o, d, z = (torch.from_numpy(setup[k]) for k in ("o", "d", "z"))
    for quartet, (t_i, j_i) in zip(got, (a, b)):
        one = pair_field_eval(pw, "torso", o, d, z, torch.from_numpy(t_i), torch.from_numpy(j_i),
                              "softplus", sp)
        for g, w in zip(quartet, one):
            assert torch.equal(g.nan_to_num(), w.nan_to_num())
            assert torch.equal(g.isnan(), w.isnan())


@pytest.mark.parametrize("sp", SLABS)
def test_pair2_one_pair(setup, sp):
    """K = 1: the A list holds the pair, the B list is empty."""
    pw = _pack(setup, "torso")
    occ = np.zeros((T, S // sp), np.int32)
    occ[1, S // sp - 3] = 1
    _, a, b = _split(occ)
    ref_a, _ = _reference_pair2(pw, "torso", setup, a, b, "softplus", sp)
    got_a, got_b = _port_pair2(_to_torch(pw), "torso", setup, a, b, "softplus", sp)
    _assert_close(got_a, ref_a, _listed(*a, sp))
    assert all(np.isnan(g.float().numpy()).all() for g in got_b)


@pytest.mark.parametrize("sp", SLABS)
def test_pair2_no_pairs_returns_zeros_without_a_launch(setup, sp):
    pw = _to_torch(_pack(setup, "head"))
    empty = np.zeros(0, np.int32)
    bufs = _port_pair2(pw, "head", setup, (empty, empty), (empty, empty), "relu", sp)
    assert len(bufs) == 2
    assert all(tuple(b.shape) == (S // sp, sp, 768) and not b.float().any()
               for q in bufs for b in q)
    assert pair2_field_kernel.launches == 0 and pair_field_kernel.launches == 0


def test_pair2_wrapper_refuses_what_it_cannot_serve(setup):
    pw = _to_torch(_pack(setup, "head"))
    o, d, z = (torch.from_numpy(setup[k]) for k in ("o", "d", "z"))
    vr = torch.zeros(N, 256, dtype=torch.bfloat16)
    one, two = torch.zeros(1, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pair2_field_kernel(pw, "head", o, d, vr, z, one, one, one, one)
    with pytest.raises(ValueError, match="one fewer"):
        pair2_field_eval_prepped(pw, "head", o, d, vr, z, one, one, two, two)
    with pytest.raises(ValueError, match="samples per slab"):
        pair2_field_eval_prepped(pw, "head", o, d, vr, z, one, one, one, one, s_slab=2)
    assert pair2_field_kernel.launches == 0
