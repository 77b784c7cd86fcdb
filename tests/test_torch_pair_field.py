"""The port's pair_field_eval (its plain PyTorch version, on the CPU)
against the reference package's pair_field_eval run in Pallas interpret
mode, on the same packed weights, rays and pair list (one with gaps).

Both sides round the PE and every activation to bf16 at the same points;
sin and the float32 sums differ in the last bits and now and then flip one
bf16 activation. Bars, with the largest values measured over these cases:
sigma (float32, after the density activation) max 1e-3 (measured 3.9e-4
on sigmas of a few 1e-2, random init) and mean 1e-5 (measured 3.1e-6);
the bf16 colours at most one bf16 ulp apart (measured 1) in at most 1% of
the listed entries (measured 0.1%). Only listed blocks are compared: the
kernel never writes the others, and the plain version fills them with NaN."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfanerf_tpu.models import DecoderConfig as JDecoderConfig
from dfanerf_tpu.models import init_decoder
from dfanerf_tpu.ops import fused_render as jf
from dfanerf_tpu.ops.pack import pack_field_weights as j_pack
from dfanerf_torch.ops.pair_field import (
    pair_field_eval, pair_field_eval_prepped, pair_field_kernel,
)

j_pack = jax.jit(j_pack, static_argnums=(1, 5, 6))
SIG_MAX, SIG_MEAN, RGB_ULPS, RGB_FRAC = 1e-3, 1e-5, 1.0, 0.01
N, S = 512, 32  # two tiles, four slabs


@pytest.fixture(scope="module")
def setup():
    params = jax.jit(lambda k: init_decoder(k, JDecoderConfig()))(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    vecs = [jnp.asarray(rng.randn(k).astype(np.float32)) for k in (96, 42, 256, 256)]
    o = (rng.randn(N, 3) * 0.05).astype(np.float32)
    d = (rng.randn(N, 3) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32)
    occ = np.array([[1, 1, 0, 0], [0, 1, 0, 1]], np.int32)  # tile 0 slabs 0-1, tile 1 slabs 1, 3
    return {"params": params, "vecs": vecs, "o": o, "d": d, "occ": occ,
            "z": np.array(jnp.linspace(0.3, 0.9, S))}


def _to_torch(pw):
    return {k: torch.tensor(np.asarray(v.astype(jnp.float32))).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32) for k, v in pw.items()}


def _pack(setup, branch, dtype=jnp.bfloat16):
    sig = setup["vecs"][0] if branch == "head" else setup["vecs"][1]
    return j_pack(setup["params"], JDecoderConfig(), sig, setup["vecs"][2], setup["vecs"][3],
                  branch, dtype)


def _ulps(a, b):
    """|a - b| in bf16 ulps of b (bf16 has 8 significant bits)."""
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
    return np.abs(a - b) / step


@pytest.mark.parametrize("branch", ["head", "torso"])
@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_matches_interpret_kernel(setup, branch, act):
    pw = _pack(setup, branch)
    t_i, j_i = (x.astype(np.int32) for x in np.nonzero(setup["occ"]))
    ref = jf.pair_field_eval(pw, branch, jnp.asarray(setup["o"]), jnp.asarray(setup["d"]),
                             jnp.asarray(setup["z"]), jnp.asarray(t_i), jnp.asarray(j_i),
                             interpret=True, act=act)
    got = pair_field_eval(_to_torch(pw), branch, torch.from_numpy(setup["o"]),
                          torch.from_numpy(setup["d"]), torch.from_numpy(setup["z"]),
                          torch.from_numpy(t_i), torch.from_numpy(j_i), act)
    assert [tuple(g.shape) for g in got] == [tuple(r.shape) for r in ref] == [(4, 8, 768)] * 4
    assert got[0].dtype == torch.float32 and all(g.dtype == torch.bfloat16 for g in got[1:])
    listed = np.zeros((4, 8, 3, 256), bool)
    listed[j_i, :, t_i, :] = True
    listed = listed.reshape(4, 8, 768)
    got = [g.float().numpy() for g in got]
    ref = [np.asarray(r.astype(jnp.float32)) for r in ref]
    err = np.abs(got[0][listed] - ref[0][listed])
    assert err.max() < SIG_MAX and err.mean() < SIG_MEAN, (err.max(), err.mean())
    for g, r in zip(got[1:], ref[1:]):
        ulps = _ulps(g[listed], r[listed])
        assert ulps.max() <= RGB_ULPS and (ulps > 0).mean() < RGB_FRAC, (ulps.max(),
                                                                          (ulps > 0).mean())
    # every block no pair lists holds NaN in the plain version
    assert all(np.isnan(g[~listed]).all() for g in got)


def test_no_pairs_returns_zeros_without_a_launch(setup):
    pw = _to_torch(_pack(setup, "head"))
    empty = torch.zeros(0, dtype=torch.int32)
    bufs = pair_field_eval(pw, "head", torch.from_numpy(setup["o"]), torch.from_numpy(setup["d"]),
                           torch.from_numpy(setup["z"]), empty, empty)
    assert all(tuple(b.shape) == (4, 8, 768) and not b.float().any() for b in bufs)
    assert pair_field_kernel.launches == 0


def test_wrapper_refuses_what_it_cannot_serve(setup):
    pw = _to_torch(_pack(setup, "head"))
    o, d, z = (torch.from_numpy(setup[k]) for k in ("o", "d", "z"))
    vr = torch.zeros(N, 256, dtype=torch.bfloat16)
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pair_field_kernel(pw, "head", o, d, vr, z, one, one)
    with pytest.raises(ValueError, match="whole"):
        pair_field_eval_prepped(pw, "head", o[:300], d[:300], vr[:300], z, one, one)
    with pytest.raises(ValueError, match="branch"):
        pair_field_eval_prepped(pw, "neck", o, d, vr, z, one, one)
    assert pair_field_kernel.launches == 0
